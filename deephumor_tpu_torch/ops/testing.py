"""Support for the port's tests and ``chip_smoke.py``: synthetic decode
states for holding the canonical-prefix kernels (K5, K6) against their
plain twins (the card tests and ``chip_smoke.py`` build their inputs
here, so both check the same kind of state), the plain mirror of the row
list that K1, K6 and K7 walk (``ancestry_rows``) and the ancestry biases
of a beam search to hold it on (``searched_biases``), and the cap on
torch's CPU threads that each test module sets. Nothing of the port's
runtime calls any of them."""

import os

import torch

from deephumor_tpu_torch.ops.attention import MASK_FILL, ancestry_bias

__all__ = ["canon_state", "cap_test_threads", "ancestry_rows",
           "searched_biases", "TILE_ROWS"]

# the rows of one tile of the kernels' tensor-core body (attention_mma.cuh
# kTile), and the branches of one block (kMaxBeam)
TILE_ROWS, CHUNK_BRANCHES = 64, 32


def cap_test_threads():
    """Lowers torch's intra-op CPU threads to this test worker's share of
    the cores, ``max(1, os.cpu_count() // PYTEST_XDIST_WORKER_COUNT)``,
    where pytest-xdist runs several workers (it sets that variable in
    each); elsewhere it leaves them as they are. It never raises the
    count: workers that each ran torch with every core's thread would
    oversubscribe the cores many times over. Returns the count in
    force."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0") or 0)
    if workers > 0:
        share = max(1, (os.cpu_count() or 1) // workers)
        if share < torch.get_num_threads():
            torch.set_num_threads(share)
    return torch.get_num_threads()


def canon_state(*, items, beam, p, c, pe, d, dtype, generator, stragglers,
                pos=None):
    """A decode state at position ``pos`` (default ``pe - 1``) in which
    every item but those listed in ``stragglers`` agrees on its ancestry
    below ``c``.

    Returns a dict of CUDA or CPU tensors (the generator's device): ``q``,
    ``kn``, ``vn`` ``[items * beam, d]``; caches ``ck``, ``cv``
    ``[items * beam, p, d]``; the shared caches ``sk``, ``sv``
    ``[items, c, d]`` gathered along each item's path; ``bias_sh``
    ``[items, 1, c]``, the window bias ``bias_win`` over ``[c, pe)`` and
    the full ancestry bias ``bias``; and the int ``pos``.
    """
    dev = generator.device

    def rnd(*shape):
        return torch.randn(shape, generator=generator, device=dev).to(dtype)

    def randint(*shape):
        return torch.randint(0, beam, shape, generator=generator, device=dev)

    rows, pos = items * beam, pe - 1 if pos is None else pos
    ck, cv = rnd(rows, p, d), rnd(rows, p, d)
    path = randint(items, p)
    anc = path[:, None, :].repeat(1, beam, 1)
    anc[:, :, c:] = randint(items, beam, p - c)
    strag = torch.as_tensor(list(stragglers), dtype=torch.long, device=dev)
    anc[strag] = randint(len(strag), beam, p)
    valid = torch.rand(rows, p, generator=generator, device=dev) < 0.9
    valid[:, pos + 1:] = False
    valid[:, 0] = valid[:, pos] = True
    valid = valid.reshape(items, beam, p)
    valid[:, :, :c] = valid[:, :1, :c].clone()  # one validity below c
    valid = valid.reshape(rows, p)
    item = torch.arange(items, device=dev)[:, None]
    sk, sv = (x[item * beam + path[:, :c], torch.arange(c, device=dev)]
              for x in (ck, cv))
    bias_sh = torch.where(valid.reshape(items, beam, p)[:, :1, :c], 0.0,
                          MASK_FILL).float()
    return dict(q=rnd(rows, d), kn=rnd(rows, d), vn=rnd(rows, d), ck=ck,
                cv=cv, sk=sk, sv=sv, bias_sh=bias_sh,
                bias_win=ancestry_bias(anc[:, :, c:pe], valid[:, c:pe],
                                       pe - c),
                bias=ancestry_bias(anc, valid, p), pos=pos)


# the kernels that take a count (K1-K6, K9, K10), in the order of the
# port's table
COUNTED = ("ancestry_attention_update", "grouped_cross_attention",
           "fused_topk_gumbel_sample", "fused_classifier_topk_gumbel_sample",
           "ancestry_attention_update_canon", "ancestry_attention_ids",
           "cross_attention_packed", "fused_survivor_update")


def counted_calls(*, items, beam, p, c, pe, d, n_heads, t_enc, vocab,
                  top_k, length, dtype, generator, pack=4, fresh=True):
    """Each kernel of ``COUNTED`` on inputs made from ``generator`` (on its
    device: the kernels on the card, the twins on the CPU), at a decode
    state of ``items`` items of ``beam`` branches, caches of ``p``
    positions read to ``pe`` (canonical prefix ``c``), width ``d`` over
    ``n_heads`` heads, ``t_enc`` encoder rows (padded to 8 for K9, ``pack``
    items a group), a ``vocab``-wide draw of ``top_k`` and ``length``
    output tokens for K10.

    Returns name -> ``(per, run)``: ``run(count)`` makes the call with the
    count of items (K3 and K4: rows, ``per`` = ``beam`` rows an item; else
    1) given as None, an int or a 0-d int32 tensor, on fresh copies of
    whatever the kernel updates in place (with ``fresh`` False, on the
    same tensors each time: for timing), and returns every output and
    updated tensor. K6's count selects the leading entries of a list that
    puts the odd items first; its other rows are left unwritten by the
    kernel, so :func:`count_rows` names the rows to compare."""
    from deephumor_tpu_torch.ops import attention as A
    from deephumor_tpu_torch.ops import engine as E
    from deephumor_tpu_torch.ops import sampler as S

    dev = generator.device
    s = canon_state(items=items, beam=beam, p=p, c=c, pe=pe, d=d,
                    dtype=dtype, generator=generator, stragglers=range(
                        1, items, 2))
    rows, heads = items * beam, dict(n_heads=n_heads)

    def rnd(*shape, dt=dtype):
        return torch.randn(shape, generator=generator, device=dev).to(dt)

    def randint(high, *shape):
        return torch.randint(0, high, shape, generator=generator, device=dev)

    def caches():
        return (s["ck"].clone(), s["cv"].clone()) if fresh else (s["ck"],
                                                                 s["cv"])

    def k1(n):
        ck, cv = caches()
        return (A.ancestry_attention_update(
            s["q"], ck, cv, s["kn"], s["vn"], s["bias"], s["pos"], beam=beam,
            p_eff=pe, live_items=n, **heads), ck, cv)

    def k5(n):
        ck, cv = caches()
        return (A.ancestry_attention_update_canon(
            s["q"], ck, cv, s["sk"], s["sv"], s["kn"], s["vn"],
            s["bias_sh"], s["bias_win"], s["pos"], beam=beam, c=c, p_eff=pe,
            live_items=n, **heads), ck, cv)

    ids = torch.cat([torch.arange(1, items, 2, device=dev),
                     torch.arange(0, items, 2, device=dev)]).to(torch.int32)

    def k6(n):
        return (A.ancestry_attention_ids(
            s["q"], s["ck"], s["cv"], s["bias"], ids, 1 if n is None else n,
            beam=beam, p_eff=pe, **heads),)

    tp = -(-t_enc // 8) * 8
    q2, ek, ev = rnd(rows, d), rnd(items, tp, d), rnd(items, tp, d)
    mask = torch.rand(items, 1, tp, generator=generator, device=dev) < 0.1
    mask[..., t_enc:] = True
    bias2 = torch.where(mask, A.MASK_FILL, 0.0).float()

    def k2(n):
        return (A.grouped_cross_attention(q2, ek[:, :t_enc].contiguous(),
                                          ev[:, :t_enc].contiguous(),
                                          bias2[..., :t_enc].contiguous(),
                                          live_items=n, **heads),)

    def k9(n):
        return (A.grouped_cross_attention(q2, ek, ev, bias2, live_items=n,
                                          pack_items=pack, t_real=t_enc,
                                          **heads),)

    logits = rnd(rows, vocab)
    x, w, b = rnd(rows, d), rnd(vocab, d), rnd(vocab, dt=torch.float32)
    seed = torch.tensor([1234], dtype=torch.int32, device=dev)
    draw = dict(top_k=top_k, num_draws=beam)

    def k3(n):
        return S.fused_topk_gumbel_sample(logits, seed, 1 / 1.1,
                                          live_rows=n, **draw)

    def k4(n):
        return S.fused_classifier_topk_gumbel_sample(x, w, b, seed, 1 / 1.1,
                                                     live_rows=n, **draw)

    lp = length + 1
    surv_in = dict(
        new_idx=randint(vocab, items, beam, beam),
        new_val=torch.randn(items, beam, beam, generator=generator,
                            device=dev),
        surv=randint(beam * beam, items, beam),
        ended=torch.rand(items, beam, generator=generator, device=dev) < 0.3,
        val=torch.randn(items, beam, generator=generator, device=dev),
        seq=randint(vocab, items, beam, length),
        anc=randint(beam, items, beam, lp),
        valid=torch.rand(items, beam, lp, generator=generator,
                         device=dev) < 0.8)

    def k10(n):
        t = ({k: v.clone() for k, v in surv_in.items()} if fresh
             else surv_in)
        return E.fused_survivor_update(
            t["new_idx"], t["new_val"], t["surv"], t["ended"], t["val"],
            t["seq"], t["anc"], t["valid"], length // 2, beam=beam,
            eos_index=3, pad_index=0, live_items=n)

    return {"ancestry_attention_update": (1, k1),
            "grouped_cross_attention": (1, k2),
            "fused_topk_gumbel_sample": (beam, k3),
            "fused_classifier_topk_gumbel_sample": (beam, k4),
            "ancestry_attention_update_canon": (1, k5),
            "ancestry_attention_ids": (1, k6),
            "cross_attention_packed": (1, k9),
            "fused_survivor_update": (1, k10)}


def count_rows(name, count, items, beam):
    """Bool ``[items]``: the items whose rows a counted call defines and
    computes at an int ``count`` (None: all); for K6 the selected items of
    :func:`counted_calls`' list, at least one. Rows of the other items are
    zero (K1-K5, K9), left as they were (K10) or unwritten (K6)."""
    n = items if count is None else min(max(count, 0), items)
    if name != "ancestry_attention_ids":
        return torch.arange(items) < n
    listed = torch.cat([torch.arange(1, items, 2), torch.arange(0, items, 2)])
    sel = torch.zeros(items, dtype=torch.bool)
    sel[listed[:max(n, 1)]] = True
    return sel


def ancestry_rows(bias, *, beam, pe, cs=1):
    """The rows that a tensor-core block of K1, K6 or K7 walks
    (ops/csrc/row_list.cuh), in plain PyTorch.

    For each item of the ancestry bias ``[items, beam, beam * P]`` and each
    chunk of up to 32 of its branches (one block), the indices ``r = i *
    pe + p`` of the dense (slot i, position p < ``pe``) rows in walk order:
    the rows that some branch keeps (bias above ``MASK_FILL``), padded with
    the first dropped rows to ``(cs - 1) * 64 + 1`` for a cluster of ``cs``
    blocks, or every row where some branch selects none (no bias above
    ``MASK_FILL / 2``). Returns ``[[LongTensor per chunk] per item]``; the
    lengths are what each block adds to the device's tally of rows read,
    ``beam * pe`` what it adds to the dense rows."""
    items, p = bias.shape[0], bias.shape[-1] // beam
    dense = bias.reshape(items, beam, beam, p)[..., :pe].reshape(
        items, beam, beam * pe).cpu()
    n, need = beam * pe, (cs - 1) * TILE_ROWS + 1
    out = []
    for g in range(items):
        chunks = []
        for j0 in range(0, beam, CHUNK_BRANCHES):
            b = dense[g, j0:j0 + CHUNK_BRANCHES]
            keep = (b > MASK_FILL).any(0)
            if not (b > MASK_FILL / 2).any(1).all():
                chunks.append(torch.arange(n))
                continue
            pad = min(max(int(keep.sum()), need), n) - int(keep.sum())
            keep[(~keep).nonzero().flatten()[:pad]] = True
            chunks.append(keep.nonzero().flatten())
        out.append(chunks)
    return out


# the two configurations' model widths and searches (perfbench/configs)
SEARCHES = {
    "word": (dict(num_tokens=29184, max_len=50),
             dict(max_len=32, beam_size=5, top_k=64)),
    "char": (dict(num_tokens=128, max_len=130),
             dict(max_len=128, beam_size=7, top_k=50, temperature=1.1,
                  compact=False, canon=False)),
}


def searched_biases(*, items, seed, steps, config="word", device="cpu"):
    """The ancestry biases that a beam search of the word or char model at
    its widths (``SEARCHES``: D 512, 6 layers, 8 heads; word V 29,184, beam
    5, 32 tokens; char V 128, beam 7, 128 characters; random weights from
    ``seed``, the exact top-k sampler, char with neither compaction nor
    canonical prefixes, so that K1 runs every step) hands K1 over ``items``
    prompts, at the decode positions ``steps``. Returns ``[(pos, p_eff,
    bias [items, beam, beam * P])]`` in the order of ``steps``, the biases
    on ``device``. The search runs on the CPU, through the plain twins."""
    from deephumor_tpu_torch.models import CaptioningTransformer
    from deephumor_tpu_torch.models import transformer

    widths, search = SEARCHES[config]
    model = CaptioningTransformer(hid_dim=512, n_layers=6, n_heads=8,
                                  pf_dim=2048, **widths)
    gen = torch.Generator().manual_seed(seed)
    params = model.init(gen, device="cpu")
    emb = (torch.randn(items, 512, generator=gen),
           torch.randn(items, 49, 512, generator=gen))
    real, seen = transformer.ancestry_attention_update, {}

    def spy(q, ck, cv, kn, vn, bias, pos, **kw):
        if pos in steps and pos not in seen:
            seen[pos] = (pos, kw.get("p_eff"), bias.to(device))
        return real(q, ck, cv, kn, vn, bias, pos, **kw)

    transformer.ancestry_attention_update = spy
    try:
        model.generate_from_emb(params, emb, generator=gen, sampler="exact",
                                **search)
    finally:
        transformer.ancestry_attention_update = real
    return [seen[s] for s in steps if s in seen]
