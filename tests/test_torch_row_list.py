"""The row list that K1, K6 and K7 walk (ops/csrc/row_list.cuh), in its
plain mirror ``ops.testing.ancestry_rows``: attention over the listed rows
equals the dense twins (``ancestry_attention_update_plain``,
``ancestry_attention_ids_plain``) in f32, on three ancestries: one that a
beam search of the word model draws, one in which every branch keeps its
own slot (nothing to drop but the masked positions), and one with a
branch that selects no row (the dense rows kept). This file imports
neither JAX nor the JAX package."""

import math

import pytest
import torch

from deephumor_tpu_torch.ops import attention as A
from deephumor_tpu_torch.ops.testing import (TILE_ROWS, ancestry_rows,
                                             cap_test_threads,
                                             searched_biases)

cap_test_threads()

BEAM, HEADS, D = 5, 8, 512
# positions of the word search and the p_eff that K1 reads there
STEPS = (3, 15, 23, 31)


@pytest.fixture(scope="module")
def searched():
    return searched_biases(items=3, seed=0, steps=STEPS)


def distinct(items, p, pos):
    """Every branch keeps its own slot at every valid position."""
    anc = torch.arange(BEAM)[None, :, None].expand(items, BEAM, p)
    valid = torch.zeros(items * BEAM, p, dtype=torch.bool)
    valid[:, :pos + 1] = True
    return A.ancestry_bias(anc, valid, p)


def blank_branch(items, p, pos, seed):
    """A random ancestry in which branch 1 of item 0 is valid nowhere."""
    g = torch.Generator().manual_seed(seed)
    anc = torch.randint(0, BEAM, (items, BEAM, p), generator=g)
    valid = torch.rand(items * BEAM, p, generator=g) < 0.8
    valid[:, pos + 1:] = False
    valid[:, 0] = valid[:, pos] = True
    valid[1] = False
    return A.ancestry_bias(anc, valid, p)


def state(items, p, seed):
    g = torch.Generator().manual_seed(seed)
    rows = items * BEAM
    rnd = lambda *s: torch.randn(s, generator=g)  # noqa: E731
    return rnd(rows, D), rnd(rows, p, D), rnd(rows, p, D), rnd(rows, D), \
        rnd(rows, D)


def listed_attention(q, ck, cv, bias, lists, pe):
    """Each branch's attention over its block's listed rows only, in f32."""
    rows, p, _ = ck.shape
    hd = D // HEADS
    out = torch.zeros(rows, D)
    for g, chunks in enumerate(lists):
        for c, idx in enumerate(chunks):
            j0 = 32 * c
            nq = min(BEAM - j0, 32)
            slot, posn = idx // pe, idx % pe
            k = ck[g * BEAM + slot, posn].reshape(-1, HEADS, hd)
            v = cv[g * BEAM + slot, posn].reshape(-1, HEADS, hd)
            qj = q[g * BEAM + j0:g * BEAM + j0 + nq].reshape(nq, HEADS, hd)
            b = bias[g, j0:j0 + nq][:, slot * p + posn]          # [nq, n]
            e = torch.einsum("jhd,nhd->jhn", qj, k) * (1.0 / math.sqrt(hd))
            w = torch.softmax(e + b[:, None, :], dim=-1)
            o = torch.einsum("jhn,nhd->jhd", w, v)
            out[g * BEAM + j0:g * BEAM + j0 + nq] = o.reshape(nq, D)
    return out


def cases(searched):
    """(name, pos, p_eff, bias) of the three ancestries."""
    for pos, pe, bias in searched:
        yield "search", pos, pe, bias
    p = searched[0][2].shape[-1] // BEAM
    yield "distinct", 31, 32, distinct(3, p, 31)
    yield "blank", 20, 24, blank_branch(3, p, 20, 1)


@pytest.mark.parametrize("cs", [1, 4])
def test_listed_rows_match_the_dense_update_twin(searched, cs):
    for name, pos, pe, bias in cases(searched):
        q, ck, cv, kn, vn = state(bias.shape[0], bias.shape[-1] // BEAM, pos)
        dense_k, dense_v = ck.clone(), cv.clone()
        want = A.ancestry_attention_update_plain(
            q, dense_k, dense_v, kn, vn, bias, pos, beam=BEAM,
            n_heads=HEADS, p_eff=pe)
        lists = ancestry_rows(bias, beam=BEAM, pe=pe, cs=cs)
        # the twin wrote the fresh column; the list reads the same caches
        got = listed_attention(q, dense_k, dense_v, bias, lists, pe)
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5,
                                   msg=lambda m: f"{name} pos {pos}: {m}")


def test_listed_rows_match_the_dense_ids_twin(searched):
    for name, pos, pe, bias in cases(searched):
        items = bias.shape[0]
        q, ck, cv, _, _ = state(items, bias.shape[-1] // BEAM, pos + 100)
        ids = torch.arange(items, dtype=torch.int32).flip(0)
        want = A.ancestry_attention_ids_plain(q, ck, cv, bias, ids, items,
                                              beam=BEAM, n_heads=HEADS,
                                              p_eff=pe)
        lists = ancestry_rows(bias, beam=BEAM, pe=pe, cs=2)
        got = listed_attention(q, ck, cv, bias, lists, pe)
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5,
                                   msg=lambda m: f"{name} pos {pos}: {m}")


def test_the_list_drops_what_no_branch_selects(searched):
    # the search: fewer rows than the dense span, every selected row kept
    for pos, pe, bias in searched:
        n = BEAM * pe
        b = bias.reshape(-1, BEAM, BEAM, bias.shape[-1] // BEAM)[..., :pe]
        b = b.reshape(-1, BEAM, n)
        for g, (idx,) in enumerate(ancestry_rows(bias, beam=BEAM, pe=pe)):
            sel = (b[g] == 0).any(0).nonzero().flatten()
            assert torch.equal(idx, sel)
            assert len(idx) < n
            # no position past pos is read
            assert (idx % pe <= pos).all()
    p = searched[0][2].shape[-1] // BEAM
    # all distinct: every slot's valid positions, nothing else
    lists = ancestry_rows(distinct(2, p, 20), beam=BEAM, pe=24)
    assert [len(c[0]) for c in lists] == [BEAM * 21] * 2
    # a blank branch keeps its item's dense rows; the other items list
    lists = ancestry_rows(blank_branch(3, p, 20, 1), beam=BEAM, pe=24)
    assert torch.equal(lists[0][0], torch.arange(BEAM * 24))
    assert all(len(c[0]) < BEAM * 24 for c in lists[1:])


def test_a_cluster_pads_the_list_to_a_tile_a_block():
    p, pos, pe = 40, 6, 8
    bias = distinct(2, p, pos)            # 35 kept of 40 rows
    for cs, want in [(1, 35), (2, 40), (4, 40)]:
        lists = ancestry_rows(bias, beam=BEAM, pe=pe, cs=cs)
        assert [len(c[0]) for c in lists] == [want] * 2
    # a span of 200 rows: a cluster of 4 reads at least 3 tiles and a row
    bias = distinct(2, p, 3)               # 20 kept of 200
    lists = ancestry_rows(bias, beam=BEAM, pe=40, cs=4)
    idx = lists[0][0]
    assert len(idx) == 3 * TILE_ROWS + 1
    # the kept rows, then the first dropped rows, in dense order
    assert torch.equal(idx, idx.sort().values)
    assert (bias[0].reshape(BEAM, BEAM, p)[..., :40].reshape(BEAM, -1)
            [:, idx] == 0).any(0).sum() == 20


def test_a_beam_above_32_lists_each_chunk_of_branches():
    beam, p, pos, pe = 36, 16, 9, 16
    anc = torch.zeros(1, beam, p, dtype=torch.long)
    anc[:, 32:] = 35                  # the last chunk's branches: slot 35
    valid = torch.zeros(beam, p, dtype=torch.bool)
    valid[:, :pos + 1] = True
    (chunks,) = ancestry_rows(A.ancestry_bias(anc, valid, p), beam=beam,
                              pe=pe)
    assert torch.equal(chunks[0], torch.arange(pos + 1))
    assert torch.equal(chunks[1], 35 * pe + torch.arange(pos + 1))
