"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Builds the hand-written kernels of deephumor_tpu_torch from ops/csrc/ and
drives the port's two serving paths, each after its kernels have been
held against their plain PyTorch twins at that path's shapes:

* word: CaptioningTransformer V=29184, hid 512, 6 layers, 8 heads, pf 2048,
  beam 5, len 32, top_k 64, bf16, sampler="pallas", batch 1792 (K1, K2,
  K3);
* char: the same widths at V=128, beam 7, len 128, top_k 50, temperature
  1.1, EOS bias 1.0, batch 768 (K1, K2, K3 for the first draw, K4, K5, K6;
  early-EOS compaction and canonical-prefix attention on by default). K1
  is also held against its twin at the char length with canon off
  (p_eff 128), in bf16 and f32, and at head_dim 24 (its CUDA-core kernel).

K2 is also held against its twin at the word shape in f32, without a
bias, at head_dim 24 (bf16 and f32: its CUDA-core kernel) and with 0 and
500 live items; K3 on rows planted with UNK as the maximum, one value
throughout, 2048 logits tied at the top (its candidate list overflows)
and ties at the threshold, at top_k == num_draws, with live_rows 0, 1 and
half, in f32 at V 29184 and 52000 (rows too long for its vector table),
and at V 3001 (rows that start unaligned), and timed beside torch.topk
alone (a partial yardstick).

Each path also runs with the two kernel-selecting switches:
DH_FUSED_SURVIVOR=1 (the survivor update in K10) and DH_CROSS_PACK=4
(decode cross-attention in K9, in groups of four items, over a store padded
to 56 rows; prefill stays on K2). Between the two paths, the other two
caption families run at the word settings: CaptioningTransformerBase
(decoder-only, global embedding; K1, K3) without and with
DH_FUSED_SURVIVOR=1 (adding K10), and CaptioningLSTM (emb 256, hidden
512, 3 layers; the classifier a bf16 product before K3), both from 1792
cached embeddings; the LSTMs, with and without labels, also from images.
Eight serving legs in all: word, word_fused, word_packed_fused, base,
base_fused, lstm, char and char_packed_fused.

The three kernels that no path of the JAX package launches on the device
run in kernel phases alone, each against its twin at the word shapes and
again at the char shapes: K7 (read-only ancestry attention, each TPU
layout), K8 (K1 with the caches read in 8-position tiles, timed beside
K1) and K11 (the in-place cache column write, exact). They launch 0
times on every leg.

Weights are random from a seed. For each model it checks greedy f32
generation through the kernels (for CaptioningTransformer also with both
switches, and char also with canon off) against the plain path on the
CPU, then runs each leg once with
every launch count at zero and fails if one of its kernels was not
launched or one off its leg was. word_fused and base_fused must give
their default legs' sequences and scores exactly. After the char leg, K6
is held against its twin and timed at each straggler count that leg
showed. Kernels shorter than their wrapper's host work (K2, K3, K4, K5,
K6, K9, K10, K11) are timed with the device queued: K4 at all char rows
and at C_LIVE live rows, beside bf16 F.linear + K3 (the unfused route) and
F.linear alone; K9 at the word and char shapes beside K2 on the same rows.
torch.profiler tables (kernel time by name, the device's idle share)
follow the word, word_packed_fused, base, base_fused and lstm legs, and
end the char path: one more call without and one with both switches.

After the legs, a serving phase drives the product path at the word
width: a 29,184-token vocabulary, 256 random 300x400 uint8 templates
preprocessed on the card (held to their CPU run, atol 1e-4) and encoded
through the ResNet-50 trunk into the pipeline's store (one template held
to the f32 encoder on the CPU), token ids decoded to text and re-encoded
to the same ids, then, with every launch count at zero, the HTTP server
(64 concurrent /caption requests, /captions with an unknown id, /meme,
/healthz) and 2,048 requests from 8 threads through the dynamic batcher
(max_batch 256, the "auto" bucket ladder: captions/s, p50 and p99
latency), and two batchers of one seed fed the same ids one by one. Only
K1, K2 and K3 may launch there, and no plain twin may see a CUDA tensor.
A subprocess then shows that two batchers' first calls, made together in
a cold process, build the kernel library once.

Last, a train phase ([12]) trains the word model at full width (the JAX
package's train measurement config, benchmarks/train_ab.py: default
dropouts, bf16 compute, batch 256, captions of 32 tokens + EOS, a cache
of 300 random templates' trunk features) for 32 steps of
``Trainer.run_epoch`` (prefetch 2) over ``BatchIterator`` batches of an
in-memory dataset, with every launch count at zero: the loss must fall
(the mean of the last 5 steps below that of the first 5), no kernel may
launch, the ResNet and the batch-norm statistics must get no optimizer
update and the statistics must move. It prints the median step time
(CUDA events at each step's start, after 5 warm-up steps), examples/s,
peak memory and the step's floor, then profiles 5 more steps (idle
share, top device ops). The trained model is saved, loaded with
``from_pretrained`` and served at batch 64 (greedy and sampled): K1, K2
and K3 must launch and no plain twin may see a CUDA tensor. Then 3 steps
from 224 x 224 images through the ResNet (batch 32; it takes no
gradient), 3 f32 steps at 2 layers, batch 16, dropout 0 on the card and
on the CPU (losses to rtol 1e-4, parameters to atol 2e-4), and 3 f32
steps of each other captioner at small widths.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernel-times [ROOT]

The second form only times K4 (all char rows, C_LIVE live), K9 (ng 2, 4,
8) and K2 on K9's rows, queued, through the deephumor_tpu_torch of the
tree at ROOT (default: this one), and prints one JSON line: run beside
a parent tree's root, it times the parent's kernels on the same inputs.

Exits non-zero, printing no result, without a CUDA device. Its last line
is ``{"ok": true, "device": {...}}``; the line before it gives the card's
name and power limit, and the one before that a JSON summary of the
kernels (times, launches per path, bounds, library yardsticks).
"""

import contextlib
import itertools
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

# word serving config (the JAX package's bench.py headline leg)
VOCAB, HID, LAYERS, HEADS, PF = 29184, 512, 6, 8, 2048
BEAM, MAX_LEN, TOP_K, BATCH, EOS_BIAS = 5, 32, 64, 1792, 1.5
ROWS, P, T_ENC = BATCH * BEAM, 40, 49
T_PAD, PACK = 56, 4  # the packed legs' padded cross store, items per block
# the LSTM leg (bench.py:164-194): emb 256, hidden 512, 3 layers
L_EMB, L_HID, L_LAYERS = 256, 512, 3
# char serving config (bench.py:63-70,225-251)
C_VOCAB, C_BEAM, C_LEN, C_TOP_K, C_BATCH = 128, 7, 128, 50, 768
C_EOS_BIAS, C_TEMP = 1.0, 1.1
# the greedy char check takes the first of these EOS biases at which a
# quarter of its items have ended by the last compaction while a canon
# boundary still has stragglers
C_GREEDY_EOS_BIASES = (0.0, 0.25, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0)
C_ROWS, C_P = C_BATCH * C_BEAM, 136  # 129 positions, padded to 8
C_LIVE = 160 * C_BEAM  # K4's rows in a late char step (~160 live items)
# the serving phase: templates, their size, the encoder's batch; the
# batcher's largest batch, the requests through it and their threads, and
# the concurrent HTTP requests
S_TEMPLATES, S_HW, S_CHUNK = 256, (300, 400), 32
S_MAX_BATCH, S_REQUESTS, S_THREADS, S_HTTP = 256, 2048, 8, 64
# a random classifier can draw PAD and, at the word legs' EOS bias, ends
# some captions at their first token; a trained captioner does neither.
# The served model pushes PAD down and takes an EOS bias that rarely ends
# a caption, so that the checks of the answers (non-empty, no PAD) test
# the serving path; the id round trip runs at both EOS biases
S_EOS_BIAS, S_PAD_BIAS = 0.5, -1e4
S_PRE_TOL = 1e-4  # preprocess_batch on the card vs on the CPU
S_ENC_TOL = 1e-3  # f32 encoder on the card (cuDNN, no TF32) vs the CPU
# the train phase: the JAX package's train measurement config
# (benchmarks/train_ab.py:30-45): the word model at its default dropouts,
# bf16 compute, batch 256, captions of 32 tokens + EOS, a trunk-feature
# cache of 300 templates; a caption per template, so that the set can be
# memorised. f32 parity with the CPU at 2 layers, batch 16; images through
# the ResNet at batch 32; the other captioners at small widths
T_BATCH, T_CAP, T_TEMPLATES, T_ITEMS = 256, 32, 300, 8192
T_STEPS, T_WARM, T_PROFILED = 32, 5, 5
T_PAR_LAYERS, T_PAR_BATCH, T_PAR_STEPS = 2, 16, 3
T_IMG_BATCH, T_SERVE_BATCH = 32, 64
T_PAR_RTOL, T_PAR_ATOL = 1e-4, 2e-4  # f32 card vs CPU: loss, parameters
TOL = 2e-2  # bf16 kernel vs twin: one bf16 rounding of each output
TOL_F32 = 1e-5  # f32 kernel vs twin: the summation order only
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
SPIN_CYCLES = 50_000_000  # ~25 ms of the device's clock: outlasts an enqueue


def log(*args):
    print(*args, flush=True)


@contextlib.contextmanager
def switches(pack=0, fused=False):
    """Runs the block with DH_CROSS_PACK / DH_FUSED_SURVIVOR set as given
    (unset when 0 / False), and restores the environment after."""
    keys = ("DH_CROSS_PACK", "DH_FUSED_SURVIVOR")
    old = {k: os.environ.pop(k, None) for k in keys}
    if pack:
        os.environ["DH_CROSS_PACK"] = str(pack)
    if fused:
        os.environ["DH_FUSED_SURVIVOR"] = "1"
    try:
        yield
    finally:
        for k, v in old.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v


def card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=10, warmup=2, queued=False):
    """Mean CUDA-event time of one call, after ``warmup`` calls. With
    ``queued`` the device first spins while the host enqueues every call,
    so that calls shorter than their own host overhead are timed on the
    device alone (fails if the spin ended before the last was enqueued)."""
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    if queued:
        torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    if queued and start.query():
        raise AssertionError("timing: the spin ended before every call was "
                             "enqueued")
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes, flops, dtype):
    """The least time the card could take: the bytes each input is read
    and each output written once over the memory rate, or the operations
    over the peak rate of their type, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def library_ms(fn):
    """Time of one PyTorch call computing the same function (yardstick
    only: the port never calls it)."""
    return cuda_ms(fn, iters=5)


def heads(x, n, length):
    """[n, length, D] -> the [n, H, length, hd] layout of SDPA."""
    return x.reshape(n, length, HEADS, -1).transpose(1, 2).contiguous()


def sdpa(q, k, v, mask):
    return torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=mask)


def attention_state(A, dev, gen, *, items, beam, p, pos, dt):
    """q, caches, k_new, v_new and the ancestry bias of a decode state at
    ``pos`` (valid positions at most ``pos``)."""
    rows = items * beam
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev).to(dt)  # noqa
    anc = torch.randint(0, beam, (items, beam, p), generator=gen, device=dev)
    valid = torch.rand(rows, p, generator=gen, device=dev) < 0.8
    valid[:, pos + 1:] = False
    valid[:, 0] = valid[:, pos] = True
    return (rnd(rows, HID), rnd(rows, p, HID), rnd(rows, p, HID),
            rnd(rows, HID), rnd(rows, HID), A.ancestry_bias(anc, valid, p))


def ancestry_sdpa_ms(q, k, v, bias, items, beam, p, pe):
    """One SDPA call over the (slot, position) rows [0, pe) of every item
    with the same bias: the library yardstick of K1, K7 and K8."""
    qh = q.reshape(items, beam, HEADS, -1).transpose(1, 2)
    kh, vh = (heads(x[:, :pe].reshape(items, beam * pe, HID), items,
                    beam * pe) for x in (k, v))
    mask = bias.reshape(items, beam, beam, p)[..., :pe].reshape(
        items, 1, beam, beam * pe).contiguous()
    return library_ms(lambda: sdpa(qh, kh, vh, mask))


def k1_bytes(live, beam, pe, elt):
    """K/V prefix without the column at pos (pe - 1 positions: pos lies
    inside the prefix, and the kernels read it from k_new / v_new), q,
    k_new, v_new, out and the two written columns, plus the bias over the
    read positions."""
    lr = live * beam
    return (2 * lr * (pe - 1) * HID + 6 * lr * HID) * elt \
        + lr * beam * pe * 4


def check_k1(A, dev, gen, *, items, beam, p, pes, dt, live_items=None,
             label="K1", d=HID, heads=HEADS, timed=True):
    """K1 vs twin for each p_eff; caches bit-equal, rows past live_items
    zero. Returns the last p_eff's measurements (with ``timed``)."""
    rows = items * beam
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev).to(dt)  # noqa
    ck, cv = rnd(rows, p, d), rnd(rows, p, d)
    err = 0.0
    for pe in pes:
        pos = pe - 1
        q, kn, vn = rnd(rows, d), rnd(rows, d), rnd(rows, d)
        anc = torch.randint(0, beam, (items, beam, p), generator=gen,
                            device=dev)
        valid = torch.rand(rows, p, generator=gen, device=dev) < 0.8
        valid[:, pos + 1:] = False
        valid[:, 0] = valid[:, pos] = True
        bias = A.ancestry_bias(anc, valid, p)
        caches = [(ck.clone(), cv.clone()) for _ in range(2)]
        kw = dict(beam=beam, n_heads=heads, p_eff=pe, live_items=live_items)
        got = A.ancestry_attention_update(q, *caches[0], kn, vn, bias, pos,
                                          **kw)
        want = A.ancestry_attention_update_plain(q, *caches[1], kn, vn,
                                                 bias, pos, **kw)
        torch.cuda.synchronize()
        if not (torch.equal(caches[0][0], caches[1][0])
                and torch.equal(caches[0][1], caches[1][1])):
            raise AssertionError(f"{label} p_eff={pe}: written caches differ")
        tol = TOL if dt == torch.bfloat16 else TOL_F32
        torch.testing.assert_close(got, want, atol=tol, rtol=tol)
        if live_items is not None and got[live_items * beam:].any():
            raise AssertionError(f"{label}: rows past live_items are not 0")
        e = (got.float() - want.float()).abs().max().item()
        err = max(err, e)
        log(f"  {label} {str(dt)[6:]} head_dim {d // heads} p_eff={pe} "
            f"live_items={live_items}: caches bit-equal, max|out-twin|="
            f"{e:.3e} (atol=rtol={tol})")
    if not timed:
        return None
    k, v = caches[0]
    ms = cuda_ms(lambda: A.ancestry_attention_update(
        q, k, v, kn, vn, bias, pos, **kw))
    plain_ms = cuda_ms(lambda: A.ancestry_attention_update_plain(
        q, k, v, kn, vn, bias, pos, **kw), iters=3)
    live = items if live_items is None else live_items
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                library_ms=ancestry_sdpa_ms(q, k, v, bias, items, beam, p, pe),
                **bound(k1_bytes(live, beam, pe, k.element_size()),
                        4 * live * beam * beam * pe * HID, dt))


def check_k7(A, dev, gen, *, items, beam, p, cases, label):
    """K7 vs its twin for each (impl, p_eff) of ``cases`` (valid
    positions below the smallest p_eff); returns the first case's
    measurements."""
    dt = torch.bfloat16
    pos = min(pe or p for _, pe in cases) - 1
    q, ck, cv, _, _, bias = attention_state(A, dev, gen, items=items,
                                            beam=beam, p=p, pos=pos, dt=dt)
    err, row = 0.0, None
    for impl, p_eff in cases:
        kw = dict(beam=beam, n_heads=HEADS, impl=impl, p_eff=p_eff)
        got = A.ancestry_attention(q, ck, cv, bias, **kw)
        want = A.ancestry_attention_plain(q, ck, cv, bias, **kw)
        torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)
        e = (got.float() - want.float()).abs().max().item()
        err = max(err, e)
        ms = cuda_ms(lambda: A.ancestry_attention(q, ck, cv, bias, **kw))
        pe = p if impl != "native4d" or p_eff is None else p_eff
        log(f"  {label} impl={impl} p_eff={p_eff} (reads {pe} positions): "
            f"max|out-twin|={e:.3e} (atol=rtol={TOL}), {ms:.4f} ms")
        if row is None:
            rows = items * beam
            nbytes = (2 * rows * pe * HID + 2 * rows * HID) * 2 + (
                rows * beam * pe * 4)
            row = dict(ms=ms, plain_ms=cuda_ms(
                lambda: A.ancestry_attention_plain(q, ck, cv, bias, **kw),
                iters=3), library_ms=ancestry_sdpa_ms(
                    q, ck, cv, bias, items, beam, p, pe),
                **bound(nbytes, 4 * rows * beam * pe * HID, dt))
    return dict(row, max_abs_err=err)


def check_k8(A, dev, gen, *, items, beam, p, positions, label):
    """K8 vs its twin at each decode position (written caches bit-equal),
    timed beside K1 at the same read length; returns the last position's
    measurements."""
    dt = torch.bfloat16
    err = 0.0
    for pos in positions:
        q, ck, cv, kn, vn, bias = attention_state(
            A, dev, gen, items=items, beam=beam, p=p, pos=pos, dt=dt)
        caches = [(ck.clone(), cv.clone()) for _ in range(2)]
        kw = dict(beam=beam, n_heads=HEADS)
        got = A.ancestry_attention_update_flash(q, *caches[0], kn, vn, bias,
                                                pos, **kw)
        want = A.ancestry_attention_update_flash_plain(
            q, *caches[1], kn, vn, bias, pos, **kw)
        torch.cuda.synchronize()
        if not (torch.equal(caches[0][0], caches[1][0])
                and torch.equal(caches[0][1], caches[1][1])):
            raise AssertionError(f"{label} pos={pos}: written caches differ")
        torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)
        e = (got.float() - want.float()).abs().max().item()
        err = max(err, e)
        k, v = caches[0]
        ms = cuda_ms(lambda: A.ancestry_attention_update_flash(
            q, k, v, kn, vn, bias, pos, **kw))
        pe = 8 * (pos // 8 + 1)
        k1_ms = cuda_ms(lambda: A.ancestry_attention_update(
            q, k, v, kn, vn, bias, pos, p_eff=pe, **kw))
        log(f"  {label} pos={pos} (tiles through p_eff {pe}): caches "
            f"bit-equal, max|out-twin|={e:.3e} (atol=rtol={TOL}), "
            f"{ms:.4f} ms; K1 at p_eff {pe}: {k1_ms:.4f} ms")
    return dict(max_abs_err=err, ms=ms, plain_ms=cuda_ms(
        lambda: A.ancestry_attention_update_flash_plain(
            q, k, v, kn, vn, bias, pos, **kw), iters=3),
        library_ms=ancestry_sdpa_ms(q, k, v, bias, items, beam, p, pe),
        **bound(k1_bytes(items, beam, pe, k.element_size()),
                4 * items * beam * beam * pe * HID, dt))


def check_k11(C, dev, gen, *, rows, p, positions, label):
    """K11 vs its twin at each position, bf16 caches from bf16 and from
    f32 columns: caches exactly equal. Returns the bf16 -> bf16
    measurements."""
    bf = torch.bfloat16
    ck, cv = (torch.randn(rows, p, HID, generator=gen, device=dev).to(bf)
              for _ in range(2))
    row = None
    for new_dt in (bf, torch.float32):
        news = [[torch.randn(rows, HID, generator=gen, device=dev).to(new_dt)
                 for _ in range(2)] for _ in range(8)]
        for pos in positions:
            got = C.cache_column_write(ck.clone(), cv.clone(), *news[0], pos)
            want = C.cache_column_write_plain(ck.clone(), cv.clone(),
                                              *news[0], pos)
            if not (torch.equal(got[0], want[0])
                    and torch.equal(got[1], want[1])):
                raise AssertionError(f"{label} pos={pos} {new_dt}: caches "
                                     f"differ from the twin's")
        # eight column pairs written at eight positions, over 100 MB in
        # all: each timed call reads inputs that have left the 50 MB L2
        calls = itertools.cycle([(kn, vn, 5 * i % p)
                                 for i, (kn, vn) in enumerate(news)])
        k, v = ck.clone(), cv.clone()
        ms = cuda_ms(lambda: C.cache_column_write(k, v, *next(calls)),
                     queued=True)
        log(f"  {label} rows={rows} P={p} pos={positions} new {new_dt}: "
            f"caches equal to the twin's; {ms:.4f} ms (inputs cold in L2)")
        if row is None:
            def copies(kn, vn, pos):
                k[:, pos].copy_(kn)
                v[:, pos].copy_(vn)

            row = dict(ms=ms, max_abs_err=0.0, plain_ms=cuda_ms(
                lambda: C.cache_column_write_plain(k, v, *next(calls)),
                queued=True), library_ms=cuda_ms(
                lambda: copies(*next(calls)), queued=True),
                # read both new columns, write both cache columns
                **bound(4 * rows * HID * 2, 0, bf))
    return row


def check_k2(A, dev, gen, *, items, beam, live_items=None,
             dt=torch.bfloat16, d=HID, masked=True, timed=True):
    """K2 vs its twin with item 0's encoder rows all masked (or no bias),
    finite, rows past live_items zero. With ``timed``: the kernel, the
    twin and SDPA."""
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev).to(dt)  # noqa
    q, ek, ev = rnd(items * beam, d), rnd(items, T_ENC, d), rnd(
        items, T_ENC, d)
    bias = None
    if masked:
        mask = torch.rand(items, T_ENC, generator=gen, device=dev) < 0.1
        mask[0] = True  # one item with every encoder row masked
        bias = torch.where(mask[:, None, :], A.MASK_FILL, 0.0).float()
    kw = dict(n_heads=HEADS, live_items=live_items)
    got = A.grouped_cross_attention(q, ek, ev, bias, **kw)
    want = A.grouped_cross_attention_plain(q, ek, ev, bias, **kw)
    tol = TOL if dt == torch.bfloat16 else TOL_F32
    torch.testing.assert_close(got, want, atol=tol, rtol=tol)
    live = items if live_items is None else live_items
    if not torch.isfinite(got.float()).all():
        raise AssertionError("K2: output not finite (item 0 fully masked)")
    if got[live * beam:].any():
        raise AssertionError("K2: rows past live_items are not 0")
    err = (got.float() - want.float()).abs().max().item()
    log(f"  K2 {str(dt)[6:]} head_dim {d // HEADS} G={items} r={beam} bias="
        f"{'item 0 fully masked' if masked else None} live_items="
        f"{live_items}: max|out-twin|={err:.3e} (atol=rtol={tol})")
    if not timed:
        return None
    ms = cuda_ms(lambda: A.grouped_cross_attention(q, ek, ev, bias, **kw),
                 queued=True)
    plain_ms = cuda_ms(lambda: A.grouped_cross_attention_plain(
        q, ek, ev, bias, **kw), iters=3)
    log(f"  K2 G={items} r={beam}: {ms:.4f} ms (device alone)")
    qh = q.reshape(items, beam, HEADS, -1).transpose(1, 2)
    kh, vh = (heads(x, items, T_ENC) for x in (ek, ev))
    m4 = bias.reshape(items, 1, 1, T_ENC)
    nbytes = (2 * live * T_ENC * HID + 2 * live * beam * HID) * 2 + (
        live * T_ENC * 4)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms(lambda: sdpa(qh, kh, vh, m4)),
                **bound(nbytes, 4 * live * beam * T_ENC * HID, dt))


def k9_inputs(A, dev, gen, items, beam):
    """q, a store padded from T_ENC to T_PAD rows (pad rows random, their
    bias columns 0, so only t_real keeps them out) and its bias, item 0
    fully masked."""
    dt = torch.bfloat16
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev).to(dt)  # noqa
    q, ek, ev = rnd(items * beam, HID), rnd(items, T_PAD, HID), rnd(
        items, T_PAD, HID)
    mask = torch.rand(items, T_PAD, generator=gen, device=dev) < 0.1
    mask[0] = True
    mask[:, T_ENC:] = False
    return q, ek, ev, torch.where(mask[:, None, :], A.MASK_FILL, 0.0).float()


def k2_on_k9_rows(A, q, ek, ev, bias, live_items):
    """K2's device time (queued) over the rows K9 reads: the first T_ENC
    rows of each item, in an unpadded store."""
    ek2, ev2 = (x[:, :T_ENC].contiguous() for x in (ek, ev))
    b2 = bias[..., :T_ENC].contiguous()
    return cuda_ms(lambda: A.grouped_cross_attention(
        q, ek2, ev2, b2, n_heads=HEADS, live_items=live_items), queued=True)


def check_k9(A, dev, gen, *, items, beam, ngs, live_items=None):
    """K9 vs its twin for each ng, timed with the device queued, beside K2
    on the same rows. Returns the measurements at ng = PACK."""
    dt = torch.bfloat16
    q, ek, ev, bias = k9_inputs(A, dev, gen, items, beam)
    live = items if live_items is None else live_items
    err, row = 0.0, None
    for ng in ngs:
        kw = dict(n_heads=HEADS, pack_items=ng, t_real=T_ENC,
                  live_items=live_items)
        got = A.grouped_cross_attention(q, ek, ev, bias, **kw)
        want = A.cross_attention_packed_plain(q, ek, ev, bias, **kw)
        torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)
        if not torch.isfinite(got[:beam].float()).all():
            raise AssertionError("K9: all-masked item is not finite")
        if got[live * beam:].any():
            raise AssertionError("K9: rows past live_items are not 0")
        e = (got.float() - want.float()).abs().max().item()
        err = max(err, e)
        ms = cuda_ms(lambda: A.grouped_cross_attention(q, ek, ev, bias, **kw),
                     queued=True)
        log(f"  K9 G={items} r={beam} T {T_ENC} of {T_PAD} ng={ng} "
            f"live_items={live_items}: max|out-twin|={e:.3e} (atol=rtol="
            f"{TOL}), {ms:.4f} ms (device alone)")
        if ng == PACK:
            row = dict(ms=ms, plain_ms=cuda_ms(
                lambda: A.cross_attention_packed_plain(q, ek, ev, bias, **kw),
                iters=3))
    row["k2_ms"] = k2_on_k9_rows(A, q, ek, ev, bias, live_items)
    log(f"  K2 on the same rows: {row['k2_ms']:.4f} ms; K9 (ng {PACK}) / K2 "
        f"= {row['ms'] / row['k2_ms']:.3f}")
    qh = q.reshape(items, beam, HEADS, -1).transpose(1, 2)
    kh, vh = (heads(x[:, :T_ENC], items, T_ENC) for x in (ek, ev))
    m4 = bias[..., :T_ENC].reshape(items, 1, 1, T_ENC)
    nbytes = (2 * live * T_ENC * HID + 2 * live * beam * HID) * 2 + (
        live * T_ENC * 4)
    return dict(row, max_abs_err=err,
                library_ms=library_ms(lambda: sdpa(qh, kh, vh, m4)),
                **bound(nbytes, 4 * live * beam * T_ENC * HID, dt))


def check_k10(E, dev, gen, *, items, beam, length, live_items=None):
    """K10 vs its twin at one path's shapes (seq [items, beam, length],
    anc/valid [items, beam, length + 1]): every output equal exactly, and
    items at or past ``live_items`` left as they were."""
    from deephumor_tpu_torch import EOS, PAD

    p = length + 1
    ri = lambda hi, *s: torch.randint(0, hi, s, generator=gen,  # noqa: E731
                                      device=dev)
    new_idx = ri(C_VOCAB, items, beam, beam)
    new_idx[::5, 0, 0] = EOS  # planted EOS picks
    ended = torch.rand(items, beam, generator=gen, device=dev) < 0.2
    ended[::7] = True  # items whose branches have all ended
    args = [new_idx, torch.randn(items, beam, beam, generator=gen, device=dev),
            ri(beam * beam, items, beam), ended,
            torch.randn(items, beam, generator=gen, device=dev),
            ri(C_VOCAB, items, beam, length), ri(beam, items, beam, p),
            torch.rand(items, beam, p, generator=gen, device=dev) < 0.8]
    pos = length // 2
    kw = dict(beam=beam, eos_index=EOS, pad_index=PAD, live_items=live_items)
    got = E.fused_survivor_update(*[a.clone() for a in args], pos, **kw)
    want = E.fused_survivor_update_plain(*args, pos, **kw)
    names = ("chosen", "val", "ended", "seq", "anc", "valid")
    for name, x, y in zip(names, got, want):
        if not torch.equal(x, y):
            raise AssertionError(f"K10: {name} differs from the twin")
    live = items if live_items is None else live_items
    for name, x, a in zip(names[1:], got[1:], (args[4], args[3], *args[5:])):
        if not torch.equal(x[live:], a[live:]):
            raise AssertionError(f"K10: {name} of a dead item changed")
    # a call is shorter than its host overhead: time it queued, on the
    # device alone, and also paced by the host as the engine's loop runs it
    work = [a.clone() for a in args]
    ms, host_ms = (cuda_ms(lambda: E.fused_survivor_update(*work, pos, **kw),
                           queued=q) for q in (True, False))
    plain_ms, plain_host_ms = (cuda_ms(
        lambda: E.fused_survivor_update_plain(*args, pos, **kw), iters=3,
        queued=q) for q in (True, False))
    log(f"  K10 items={items} beam={beam} L={length} P={p} live_items="
        f"{live_items}: all six outputs equal to the twin; device "
        f"{ms:.4f} ms (twin {plain_ms:.4f} ms), host-paced {host_ms:.4f} ms "
        f"(twin {plain_host_ms:.4f} ms)")
    # live rows read new_idx, new_val (beam each), surv, ended, val, seq,
    # anc, valid and write all but the candidates and picks; chosen is
    # written for every row; no arithmetic to speak of
    rows = live * beam
    nbytes = rows * (beam * 12 + 8 + 1 + 4 + 2 * (length * 8 + p * 9)
                     + 1 + 4) + items * beam * 8
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=None,
                **bound(nbytes, 0, torch.float32))


def check_draws(ids, ids_p, logits, top_k, label):
    """ids in the exact keep-ties top-k support of ``logits``, no UNK, no
    repeats, equal to the twin's on >= 0.999 of rows."""
    x = logits.float()
    kth = x.topk(top_k, dim=1).values[:, -1:]
    in_support = (x.gather(1, ids) >= kth).all().item()
    no_unk = not (ids == 1).any().item()
    srt = ids.sort(dim=1).values
    distinct = (srt[:, 1:] != srt[:, :-1]).all().item()
    same = (ids == ids_p).all(dim=1).float().mean().item()
    log(f"  {label}: in exact top-{top_k} support={in_support}, no "
        f"UNK={no_unk}, no repeats={distinct}, rows equal to "
        f"twin={same:.6f} (>= 0.999)")
    if not (in_support and no_unk and distinct and same >= 0.999):
        raise AssertionError(f"{label} disagrees with its twin or the "
                             f"support")


def check_k3(S, dev, gen, *, rows, vocab, top_k, draws, inv_t, label,
             dt=torch.bfloat16, timed=True):
    """K3 vs its twin. Timed first on random logits (with ``timed``); then
    checked on them with rows planted that the kernel treats apart: UNK as
    the row's maximum, rows of one value and, at a vocabulary of 2048 or
    more, 2048 logits tied at the top (the candidate list overflows to the
    whole-row search), ties across the threshold; also at top_k ==
    num_draws, and with live_rows 0, 1 and half the rows."""
    logits = torch.randn(rows, vocab, generator=gen, device=dev).to(dt)
    kw = dict(top_k=top_k, num_draws=draws)
    row = None
    if timed:
        ms = cuda_ms(lambda: S.fused_topk_gumbel_sample(logits, 7, inv_t,
                                                        **kw), queued=True)
        plain_ms = cuda_ms(lambda: S.fused_topk_gumbel_sample_plain(
            logits, 7, inv_t, **kw), iters=2, warmup=1)
        topk_ms = cuda_ms(lambda: torch.topk(logits, top_k, dim=1),
                          queued=True)
        # reads the logits once, writes the ids; its integer compares have
        # no peak rate in the table, so the bytes bound it
        row = dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                   topk_ms=topk_ms, **bound(
                       rows * vocab * logits.element_size()
                       + rows * draws * 4, 0, torch.bfloat16))
        log(f"  {label} [{rows}, {vocab}] {str(dt)[6:]}: {ms:.4f} ms (device "
            f"alone), twin {plain_ms:.4f} ms, torch.topk(k={top_k}) alone "
            f"{topk_ms:.4f} ms (a partial yardstick), bound "
            f"{row['bound_ms']:.4f} ms")
    logits[:8, 1] = logits[:8].float().max() + 1.0  # UNK on top
    logits[8:16] = 0.5  # one value: every column kept
    if vocab >= 2048:
        logits[16:24, :2048] = 7.0  # 2048 tied at the top
    # 40 logits tied with the row's k-th largest: ties across the threshold
    c0 = min(100, vocab - 40)
    logits[24:32, c0:c0 + 40] = logits[24:32].float().topk(
        top_k, dim=1).values[:, -1:].to(dt)
    ids, vals = S.fused_topk_gumbel_sample(logits, 12345, inv_t, **kw)
    ids_p, vals_p = S.fused_topk_gumbel_sample_plain(logits, 12345, inv_t,
                                                     **kw)
    check_draws(ids, ids_p, logits, top_k, label)
    err = (vals - vals_p).abs().max().item()
    # top_k == num_draws: a row with UNK inside its top k exhausts its
    # support and draws column 0, so those rows are held to the twin alone
    ids_k, _ = S.fused_topk_gumbel_sample(logits, 5, inv_t, top_k=draws,
                                          num_draws=draws)
    ids_kp, _ = S.fused_topk_gumbel_sample_plain(logits, 5, inv_t,
                                                 top_k=draws, num_draws=draws)
    x = logits.float()
    clean = x[:, 1] < x.topk(draws, dim=1).values[:, -1]
    check_draws(ids_k[clean], ids_kp[clean], logits[clean], draws,
                f"{label} top_k=num_draws={draws}")
    if not torch.equal(ids_k[~clean], ids_kp[~clean]):
        raise AssertionError(f"{label}: top_k == num_draws, rows with UNK "
                             f"in the top k differ from the twin")
    # live rows draw what they drew, the others id 0, value 0
    for live in (0, 1, rows // 2):
        ids_h, vals_h = S.fused_topk_gumbel_sample(logits, 12345, inv_t,
                                                   live_rows=live, **kw)
        ids_hp, _ = S.fused_topk_gumbel_sample_plain(
            logits, 12345, inv_t, live_rows=live, **kw)
        if ids_h[live:].any() or vals_h[live:].any() or ids_hp[live:].any():
            raise AssertionError(f"{label}: rows past live_rows are not 0")
        if not (torch.equal(ids_h[:live], ids[:live])
                and torch.equal(vals_h[:live], vals[:live])
                and torch.equal(ids_hp[:live], ids_p[:live])):
            raise AssertionError(f"{label}: live rows differ from the full "
                                 f"call")
    log(f"  {label} live_rows 0, 1, {rows // 2}: live rows equal to the "
        f"full call's, the rest 0")
    return None if row is None else dict(row, max_abs_err=err)


def k4_inputs(dev, gen):
    """x [5376, 512], W [128, 512] bf16 and an f32 bias with UNK on top of
    every row (it must never be drawn)."""
    bf = torch.bfloat16
    x = torch.randn(C_ROWS, HID, generator=gen, device=dev).to(bf)
    w = (torch.randn(C_VOCAB, HID, generator=gen, device=dev) / 8).to(bf)
    b = torch.randn(C_VOCAB, generator=gen, device=dev)
    b[1] = 30.0
    return x, w, b


def k4_bytes(live):
    """x's live rows, W and b read; every row's ids (int64) and values
    (f32) written."""
    return live * HID * 2 + C_VOCAB * HID * 2 + C_VOCAB * 4 + (
        C_ROWS * C_BEAM * 12)


def check_k4(S, dev, gen):
    """K4 at the char shapes, all rows live and C_LIVE live (and 3000),
    timed with the device queued beside the unfused route (bf16 F.linear,
    then K3) and F.linear alone (partial yardsticks)."""
    bf = torch.bfloat16
    x, w, b = k4_inputs(dev, gen)
    kw = dict(top_k=C_TOP_K, num_draws=C_BEAM)
    err = 0.0
    for live in (None, 3000, C_LIVE):
        ids, vals = S.fused_classifier_topk_gumbel_sample(
            x, w, b, 4321, 1 / C_TEMP, live_rows=live, **kw)
        ids_p, vals_p = S.fused_classifier_topk_gumbel_sample_plain(
            x, w, b, 4321, 1 / C_TEMP, live_rows=live, **kw)
        n = C_ROWS if live is None else live
        if live is not None and (ids[n:].any() or vals[n:].any()):
            raise AssertionError("K4: rows past live_rows are not 0")
        logits = S.classifier_logits(x[:n], w, b)
        check_draws(ids[:n], ids_p[:n], logits, C_TOP_K,
                    f"K4 live_rows={live}")
        eq = (ids == ids_p).all(dim=1)
        err = max(err, (vals[eq] - vals_p[eq]).abs().max().item())
    row = {}
    for key, live in (("", None), ("_live", C_LIVE)):
        row["ms" + key] = cuda_ms(
            lambda: S.fused_classifier_topk_gumbel_sample(
                x, w, b, 7, 1 / C_TEMP, live_rows=live, **kw), queued=True)
        row["linear_k3_ms" + key] = cuda_ms(
            lambda: S.fused_topk_gumbel_sample(
                torch.nn.functional.linear(x, w, b.to(bf)), 7, 1 / C_TEMP,
                live_rows=live, **kw), queued=True)
        row["bound_ms" + key] = bound(
            k4_bytes(live or C_ROWS), 2 * (live or C_ROWS) * C_VOCAB * HID,
            bf)["bound_ms"]
    row["linear_ms"] = cuda_ms(
        lambda: torch.nn.functional.linear(x, w, b.to(bf)), queued=True)
    plain_ms = cuda_ms(lambda: S.fused_classifier_topk_gumbel_sample_plain(
        x, w, b, 7, 1 / C_TEMP, **kw), iters=2, warmup=1)
    log(f"  K4 [{C_ROWS}, {HID}] x [{C_VOCAB}, {HID}]: {row['ms']:.4f} ms "
        f"(device alone; {C_LIVE} live rows {row['ms_live']:.4f} ms), twin "
        f"{plain_ms:.4f} ms; F.linear + K3 {row['linear_k3_ms']:.4f} ms "
        f"({C_LIVE} live {row['linear_k3_ms_live']:.4f} ms), F.linear alone "
        f"{row['linear_ms']:.4f} ms (partial yardsticks); bound "
        f"{row['bound_ms']:.4f} / {row['bound_ms_live']:.4f} ms")
    return dict(row, max_abs_err=err, plain_ms=plain_ms, library_ms=None,
                bound_by=bound(k4_bytes(C_ROWS),
                               2 * C_ROWS * C_VOCAB * HID, bf)["bound_by"])


def check_k5_k6(A, dev, gen):
    """K5 (pe 120: c 104, w 16; pe 128: c 120, w 8) and K6 (pe 128) at the
    char shapes, and K5 + K6 merged == K1's full-width twin. K5 is timed
    at both canon shapes (the row reports pe 120), K6 at 96 items, both on
    the device alone (queued)."""
    from deephumor_tpu_torch.ops.testing import canon_state

    dt, items, beam = torch.bfloat16, C_BATCH, C_BEAM
    n = 96  # stragglers: the first n items, then the rest in order
    strag_ids = torch.arange(items, device=dev, dtype=torch.int32)
    err5 = err6 = 0.0
    ms5 = {}
    for c, pe, live in ((104, 120, None), (120, 128, None), (104, 120, 500)):
        s = canon_state(items=items, beam=beam, p=C_P, c=c, pe=pe, d=HID,
                        dtype=dt, generator=gen, stragglers=range(n))
        kw = dict(beam=beam, n_heads=HEADS, c=c, p_eff=pe, live_items=live)
        caches = [(s["ck"].clone(), s["cv"].clone()) for _ in range(2)]
        args = (s["sk"], s["sv"], s["kn"], s["vn"], s["bias_sh"],
                s["bias_win"], s["pos"])
        got = A.ancestry_attention_update_canon(s["q"], *caches[0], *args,
                                                **kw)
        want = A.ancestry_attention_update_canon_plain(s["q"], *caches[1],
                                                       *args, **kw)
        torch.cuda.synchronize()
        if not (torch.equal(caches[0][0], caches[1][0])
                and torch.equal(caches[0][1], caches[1][1])):
            raise AssertionError(f"K5 c={c} p_eff={pe}: caches differ")
        torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)
        e = (got.float() - want.float()).abs().max().item()
        err5 = max(err5, e)
        log(f"  K5 c={c} p_eff={pe} live_items={live}: caches bit-equal, "
            f"max|out-twin|={e:.3e} (atol=rtol={TOL})")
        if live is not None:
            continue
        # K6 on the written caches: the 96 stragglers, then the merge
        k6kw = dict(beam=beam, n_heads=HEADS, p_eff=pe)
        ck, cv = caches[0]
        out_s = A.ancestry_attention_ids(s["q"], ck, cv, s["bias"],
                                         strag_ids, n, **k6kw)
        want_s = A.ancestry_attention_ids_plain(
            s["q"], ck, cv, s["bias"], strag_ids, n, **k6kw)
        sr = slice(0, n * beam)
        torch.testing.assert_close(out_s[sr], want_s[sr], atol=TOL, rtol=TOL)
        e = (out_s[sr].float() - want_s[sr].float()).abs().max().item()
        err6 = max(err6, e)
        rows_mask = torch.zeros(items * beam, dtype=torch.bool, device=dev)
        rows_mask[sr] = True
        merged = torch.where(rows_mask[:, None], out_s, got)
        full = A.ancestry_attention_update_plain(
            s["q"], ck.clone(), cv.clone(), s["kn"], s["vn"], s["bias"],
            s["pos"], beam=beam, n_heads=HEADS, p_eff=pe)
        torch.testing.assert_close(merged, full, atol=TOL, rtol=TOL)
        em = (merged.float() - full.float()).abs().max().item()
        log(f"  K6 p_eff={pe} {n} stragglers: max|out-twin|="
            f"{e:.3e}; K5+K6 merged vs K1 twin full width: max|diff|="
            f"{em:.3e} (atol=rtol={TOL})")
        ms5[pe] = cuda_ms(lambda: A.ancestry_attention_update_canon(
            s["q"], ck, cv, *args, **kw), queued=True)
        log(f"  K5 c={c} p_eff={pe} (joined support {c + beam * (pe - c)} "
            f"rows): {ms5[pe]:.4f} ms")
        if pe == 120:
            k5_state = (s, caches[0], args, kw)
    s, (ck, cv), args, kw = k5_state
    plain5 = cuda_ms(lambda: A.ancestry_attention_update_canon_plain(
        s["q"], ck, cv, *args, **kw), iters=3)
    c, pe, w = kw["c"], kw["p_eff"], kw["p_eff"] - kw["c"]
    qh = s["q"].reshape(items, beam, HEADS, -1).transpose(1, 2)
    kh, vh = (torch.cat([heads(sh, items, c), heads(
        x[:, c:pe].reshape(items, beam * w, HID), items, beam * w)], dim=2)
        for sh, x in ((s["sk"], ck), (s["sv"], cv)))
    mask = torch.cat([s["bias_sh"].expand(items, beam, c), s["bias_win"]],
                     dim=-1)[:, None].contiguous()
    rows = items * beam
    # K+V: shared rows, the window's w - 1 cached positions, k_new / v_new
    # read and written at pos (inside the window); q and the output; biases
    nbytes5 = (2 * items * c * HID + 2 * rows * (w - 1) * HID
               + 4 * rows * HID + 2 * rows * HID) * 2 \
        + items * c * 4 + items * beam * beam * w * 4
    k5 = dict(max_abs_err=err5, ms=ms5[120], ms_pe128=ms5[128],
              plain_ms=plain5,
              library_ms=library_ms(lambda: sdpa(qh, kh, vh, mask)),
              **bound(nbytes5, 4 * rows * (c + beam * w) * HID, dt))
    # K6 at pe 128 on the last state that ran it
    k6kw = dict(beam=beam, n_heads=HEADS, p_eff=128)
    s6 = canon_state(items=items, beam=beam, p=C_P, c=120, pe=128, d=HID,
                     dtype=dt, generator=gen, stragglers=range(n))
    ms6 = cuda_ms(lambda: A.ancestry_attention_ids(
        s6["q"], s6["ck"], s6["cv"], s6["bias"], strag_ids, n, **k6kw),
        queued=True)
    plain6 = cuda_ms(lambda: A.ancestry_attention_ids_plain(
        s6["q"], s6["ck"], s6["cv"], s6["bias"], strag_ids, n, **k6kw),
        iters=3)
    sel = slice(0, n * beam)
    qh = s6["q"][sel].reshape(n, beam, HEADS, -1).transpose(1, 2)
    kh, vh = (heads(x[sel, :128].reshape(n, beam * 128, HID), n, beam * 128)
              for x in (s6["ck"], s6["cv"]))
    mask = s6["bias"][:n].reshape(n, beam, beam, C_P)[..., :128].reshape(
        n, 1, beam, beam * 128).contiguous()
    nbytes6 = (2 * n * beam * 128 * HID + 2 * n * beam * HID) * 2 + (
        n * beam * beam * 128 * 4 + n * 4)
    k6 = dict(max_abs_err=err6, ms=ms6, plain_ms=plain6,
              library_ms=library_ms(lambda: sdpa(qh, kh, vh, mask)),
              **bound(nbytes6, 4 * n * beam * beam * 128 * HID, dt))
    return k5, k6


def check_k6_leg(A, dev, gen, boundaries, k6):
    """K6 at the straggler counts the char leg showed: at each canon
    boundary with stragglers, held against its twin and timed on the
    device alone (queued: a launch is shorter than its wrapper's host time)
    over that many items at the p_eff of the phase after it (the
    boundary's + 8, at most 128). Adds the times to ``k6``."""
    from deephumor_tpu_torch.ops.testing import canon_state

    counts = [(min(pe + 8, 128), n) for pe, _, n in boundaries if n]
    if not counts:
        raise AssertionError("char leg: no canon boundary had stragglers")
    dt, items, beam = torch.bfloat16, C_BATCH, C_BEAM
    s = canon_state(items=items, beam=beam, p=C_P, c=120, pe=128, d=HID,
                    dtype=dt, generator=gen,
                    stragglers=range(max(n for _, n in counts)))
    ids = torch.arange(items, device=dev, dtype=torch.int32)
    args = (s["q"], s["ck"], s["cv"], s["bias"], ids)
    kw = dict(beam=beam, n_heads=HEADS)
    k6["ms_leg"] = []
    for pe, n in counts:
        got = A.ancestry_attention_ids(*args, n, p_eff=pe, **kw)
        want = A.ancestry_attention_ids_plain(*args, n, p_eff=pe, **kw)
        sel = slice(0, n * beam)
        torch.testing.assert_close(got[sel], want[sel], atol=TOL, rtol=TOL)
        e = (got[sel].float() - want[sel].float()).abs().max().item()
        k6["max_abs_err"] = max(k6["max_abs_err"], e)
        ms = cuda_ms(lambda: A.ancestry_attention_ids(*args, n, p_eff=pe,
                                                      **kw), queued=True)
        k6["ms_leg"].append([pe, n, ms])
    log(f"  K6 at the char leg's straggler counts, each within atol=rtol="
        f"{TOL} of its twin: (p_eff, stragglers, ms) "
        f"{[(pe, n, round(ms, 4)) for pe, n, ms in k6['ms_leg']]}; 96 items "
        f"at p_eff 128: {k6['ms']:.4f} ms")


def make_model(CaptioningTransformer, dtype, dev, char):
    vocab, max_len, eos = ((C_VOCAB, C_LEN, C_EOS_BIAS) if char
                           else (VOCAB, MAX_LEN, EOS_BIAS))
    model = CaptioningTransformer(
        num_tokens=vocab, hid_dim=HID, n_layers=LAYERS, n_heads=HEADS,
        pf_dim=PF, max_len=max_len + 2, compute_dtype=dtype)
    params = model.init(torch.Generator(dev).manual_seed(0), dev)
    params["decoder"]["classifier"]["bias"][3] = eos
    return model, params


def features(n, dev, seed):
    g = torch.Generator(dev).manual_seed(seed)
    return (torch.randn(n, HID, generator=g, device=dev),
            torch.randn(n, T_ENC, HID, generator=g, device=dev))


def marks(out):
    """(p_eff, live items after compaction, stragglers) per boundary."""
    return [(b["p_eff"], b["live"], b["stragglers"])
            for b in out["boundaries"]]


def retiring_greedy(model, params, enc, kw):
    """Greedy char generation on the kernel path at the first EOS bias of
    C_GREEDY_EOS_BIASES under which at least a quarter of the items have
    ended by the last compaction while a canon boundary still has
    stragglers, so that the check crosses the dead-item path (zero rows,
    ``live_rows``, the cross K/V and encoder mask moved with the items,
    the final un-permutation) as well as canon. Leaves that bias in
    ``params``."""
    n = enc[0].shape[0]
    for eos in C_GREEDY_EOS_BIASES:
        params["decoder"]["classifier"]["bias"][3] = eos
        out = model.generate_from_emb(params, enc, greedy=True, **kw)
        live = [b["live"] for b in out["boundaries"] if b["live"] is not None]
        log(f"  EOS bias {eos}: boundaries {marks(out)}")
        if (live and min(live) <= 3 * n // 4
                and any(b["stragglers"] for b in out["boundaries"])):
            return out
    raise AssertionError("greedy char: no EOS bias retired a quarter of the "
                         "items with stragglers left at a canon boundary")


def check_greedy(CaptioningTransformer, tree_map, _build, dev, char):
    """Greedy f32 generation through the kernels, without and with both
    switches (K9 and K10 then launch), vs the plain path on the CPU
    without switches at the serving widths (char: 32 items at several
    feature scales, compaction and canon on by the defaults, many items
    retired early, and the same boundaries on all three; then once more
    on the card with canon off)."""
    model, params = make_model(CaptioningTransformer, "float32", dev, char)
    n = 32 if char else 64
    enc = features(n, dev, 1)
    kw = (dict(max_len=C_LEN, beam_size=C_BEAM, top_k=C_TOP_K) if char
          else dict(max_len=MAX_LEN, beam_size=BEAM, top_k=TOP_K))
    if char:
        # items at several feature scales end at different steps
        scale = torch.linspace(0.3, 2.0, n, device=dev)[:, None]
        enc = (enc[0] * scale, enc[1] * scale[:, :, None])
        got = retiring_greedy(model, params, enc, kw)
    else:
        got = model.generate_from_emb(params, enc, greedy=True, **kw)
    cpu = lambda t: t.cpu()  # noqa: E731
    want = model.generate_from_emb(tree_map(cpu, params),
                                   tuple(map(cpu, enc)), greedy=True, **kw)
    _build.reset_launch_counts()
    with switches(pack=PACK, fused=True):
        got_sw = model.generate_from_emb(params, enc, greedy=True, **kw)
    k9, k10 = (_build.LAUNCHES[k] for k in ("cross_attention_packed",
                                             "fused_survivor_update"))
    if not (k9 and k10):
        raise AssertionError(f"greedy with both switches: K9 {k9}, K10 {k10} "
                             f"launches")
    for label, g in (("kernel path", got),
                     (f"kernel path, both switches (K9 {k9}, K10 {k10} "
                      f"launches)", got_sw)):
        same = (g["chosen"].cpu() == want["chosen"]).all(dim=1).float().mean()
        log(f"  greedy f32, {n} items: {label} == CPU plain path on "
            f"{same.item():.4f} of items (>= 0.99); boundaries (kernels) "
            f"{marks(g)}; (CPU) {marks(want)}")
        if same < 0.99:
            raise AssertionError(f"greedy {label} disagrees with plain path")
        if char and g["boundaries"] != want["boundaries"]:
            raise AssertionError(f"greedy char, {label}: boundaries differ "
                                 f"from the CPU path's")
    if not char:
        return
    # canon off: K1 reads every per-slot row, through p_eff 128. Canon
    # changes no greedy token (K5 + K6 attend over the same rows as K1), so
    # the CPU plain path's tokens above are the reference, and the
    # compaction boundaries must be its
    _build.reset_launch_counts()
    got = model.generate_from_emb(params, enc, greedy=True, canon=False, **kw)
    k1, k5 = (_build.LAUNCHES[k] for k in ("ancestry_attention_update",
                                            "ancestry_attention_update_canon"))
    same = (got["chosen"].cpu() == want["chosen"]).all(dim=1).float().mean()
    compactions = [[(pe, live) for pe, live, _ in marks(o) if live is not None]
                   for o in (got, want)]
    log(f"  greedy f32, {n} items, canon off (K1 {k1}, K5 {k5} launches): "
        f"kernel path == CPU plain path on {same.item():.4f} of items (>= "
        f"0.99); compactions (p_eff, live) {compactions[0]}; (CPU) "
        f"{compactions[1]}")
    if k5 or not k1 or same < 0.99 or compactions[0] != compactions[1]:
        raise AssertionError("greedy char, canon off: disagrees with the "
                             "plain path or ran canon")


def make_lstm(cls, dtype, dev):
    model = cls(num_tokens=VOCAB, emb_dim=L_EMB, hidden_size=L_HID,
                num_layers=L_LAYERS, compute_dtype=dtype)
    params = model.init(torch.Generator(dev).manual_seed(0), dev)
    params["decoder"]["classifier"]["bias"][3] = EOS_BIAS
    return model, params


def greedy_parity(model, params, enc, tree_map, label):
    """Greedy f32 generation at the word settings on the card vs the plain
    path on the CPU: token-equal on >= 99% of items."""
    kw = dict(max_len=MAX_LEN, beam_size=BEAM, top_k=TOP_K)
    got = model.generate_from_emb(params, enc, greedy=True, **kw)
    cpu = lambda t: t.cpu()  # noqa: E731
    want = model.generate_from_emb(tree_map(cpu, params), tree_map(cpu, enc),
                                   greedy=True, **kw)
    same = (got["chosen"].cpu() == want["chosen"]).all(dim=1).float().mean()
    log(f"  greedy f32, {batch(enc).shape[0]} items: {label} on the card == "
        f"CPU plain path on {same.item():.4f} of items (>= 0.99)")
    if same < 0.99:
        raise AssertionError(f"greedy {label} disagrees with plain path")


def check_output(out, n, vocab, beam, max_len):
    seq = out["sequences"]
    if out["chosen"].shape != (n, max_len) or seq.shape != (n, beam,
                                                           max_len):
        raise AssertionError(f"unexpected output shape {tuple(seq.shape)}")
    if not (((seq >= 0) & (seq < vocab)).all() and not (seq == 1).any()
            and torch.isfinite(out["scores"]).all()):
        raise AssertionError("tokens out of range, UNK drawn or bad scores")


def batch(enc):
    """The global embeddings of ``encode`` output: the whole of it, or the
    first of the cross-attention model's pair."""
    return enc[0] if isinstance(enc, tuple) else enc


def timed_call(model, params, enc, kw, seed):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = model.generate_from_emb(
        params, enc, generator=torch.Generator(
            batch(enc).device).manual_seed(seed), **kw)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def drive(model, params, enc, _build, kw, name_limit, label, path_kernels,
          pack=0, fused=False):
    """One warm-up call, then one call with every launch count at zero;
    fails unless each kernel of ``path_kernels`` launched (and no other).
    Two more calls (not counted) show the run-to-run spread. ``pack`` and
    ``fused`` set the two switches for this leg's calls."""
    with switches(pack, fused):
        model.generate_from_emb(params, enc, **kw)
        _build.reset_launch_counts()
        out, secs = timed_call(model, params, enc, kw, 5)
        launches = dict(_build.LAUNCHES)
        n = batch(enc).shape[0]
        steps = int((out["sequences"] != 0).any(dim=(0, 1)).sum())
        log(f"  {label} generate_from_emb: {n / secs:.1f} captions/s "
            f"({secs:.3f} s, {steps} positions, {name_limit}); launches "
            f"{launches}")
        again = [n / timed_call(model, params, enc, kw, s)[1]
                 for s in (6, 7)]
    log(f"  {label} two more calls (seeds 6, 7): "
        f"{', '.join(f'{r:.1f}' for r in again)} captions/s")
    missing = [k for k in path_kernels if launches[k] < 1]
    extra = [k for k, v in launches.items() if v and k not in path_kernels]
    if missing or extra:
        raise AssertionError(f"{label}: kernels not launched {missing}, "
                             f"launched off the path {extra}")
    return out, launches


def profile_call(model, params, enc, kw, name_limit, label, top, pack=0,
                 fused=False):
    """torch.profiler over one call with the switches as given: kernel
    time by name (the ``top`` largest) and the device's idle share."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with switches(pack, fused), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.generate_from_emb(params, enc, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if getattr(e, "device_time_total", 0) > 0
              and e.device_type.name == "CUDA"]
    busy = sum(e.device_time_total for e in events) / 1e3
    events.sort(key=lambda e: -e.device_time_total)
    lines = [f"{label} profile ({name_limit}): wall {wall * 1e3:.1f} ms "
             f"(profiled), device kernel time {busy:.1f} ms, idle share "
             f"{1 - busy / (wall * 1e3):.3f}"]
    for e in events[:top]:
        lines.append(f"  {e.device_time_total / 1e3:10.3f} ms "
                     f"{e.count:6d} calls  {e.key[:90]}")
    for line in lines:
        log(line)


def check_leg_launches(label, launches, packed, steps):
    """A switched leg's counts: K10 once per decode step and, when packed,
    K2 only in the prefill's layers and K9 in every decode layer-step
    (else K2 in every layer of the prefill and of each step)."""
    got = tuple(launches[k] for k in ("grouped_cross_attention",
                                      "cross_attention_packed",
                                      "fused_survivor_update"))
    want = ((LAYERS, LAYERS * steps, steps) if packed
            else (LAYERS * (steps + 1), 0, steps))
    log(f"  {label}: {steps} decode steps; K2, K9, K10 launches {got} "
        f"(want {want})")
    if got != want:
        raise AssertionError(f"{label}: K2/K9/K10 launch counts")


def twin_guard(modules):
    """Wraps every plain twin of the kernel modules so that a call with a
    CUDA tensor is recorded (a wrapper takes its twin for CPU tensors
    only); returns the record and a function that puts the twins back."""
    hits, saved = [], []
    for mod in modules:
        for name in dir(mod):
            fn = getattr(mod, name)
            if not (name.endswith("_plain") and callable(fn)):
                continue

            def guard(*args, _fn=fn, _name=name, **kwargs):
                if any(isinstance(x, torch.Tensor) and x.is_cuda
                       for x in (*args, *kwargs.values())):
                    hits.append(_name)
                return _fn(*args, **kwargs)

            saved.append((mod, name, fn))
            setattr(mod, name, guard)

    def restore():
        for mod, name, fn in saved:
            setattr(mod, name, fn)

    return hits, restore


def host_ms(fn, iters=10):
    """Mean host time of ``fn`` (ms), the device synchronised around."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def check_caption(text, vocab, where):
    """A served caption: non-empty, every token in the vocabulary, no UNK
    and no PAD."""
    tokens = text.split(" ")
    if not text or any(t not in vocab.stoi for t in tokens) or (
            {"<unk>", "<pad>"} & set(tokens)):
        raise AssertionError(f"{where}: bad caption {text!r}")


def id_round_trip(model, params, pipe, ids, kw, seed):
    """Generates for ``ids`` on the card and decodes each chosen row to
    text; re-encoding the text gives the row's ids up to its first EOS.
    Returns the captions that ended early and those that are empty."""
    from deephumor_tpu_torch.data import EOS_ID, WordPunctTokenizer
    from deephumor_tpu_torch.experiments.inference import (seq_to_text,
                                                           text_to_seq)

    out = model.generate_from_emb(
        params, pipe._stack_features(ids),
        generator=torch.Generator(pipe.device).manual_seed(seed), **kw)
    tok, ended, empty = WordPunctTokenizer(), 0, 0
    for row in out["chosen"].cpu().numpy():
        eos = np.flatnonzero(row == EOS_ID)
        n = int(eos[0]) if eos.size else row.size
        back = text_to_seq(seq_to_text(row, pipe.vocab), pipe.vocab, tok)[0]
        if not np.array_equal(back, row[:n]):
            raise AssertionError(f"decoding: ids {row[:n]} -> text -> {back}")
        ended += n < row.size
        empty += n == 0
    return ended, empty


def http_phase(pipe, kw):
    """Serves ``pipe`` over HTTP on 127.0.0.1:0 through the port's
    ``serve`` and checks every answer."""
    import concurrent.futures
    import importlib.util
    import urllib.error
    import urllib.request
    from urllib.parse import urlencode

    from deephumor_tpu_torch import serve as serve_mod

    ev = threading.Event()
    server = threading.Thread(target=serve_mod.serve, args=(pipe, kw),
                              kwargs=dict(port=0, max_batch=S_MAX_BATCH,
                                          buckets="auto", ready_event=ev),
                              daemon=True)
    server.start()
    if not ev.wait(timeout=300):
        raise AssertionError("serving: the HTTP server did not come up")
    base = f"http://127.0.0.1:{ev.httpd.server_address[1]}"

    def get(route):
        try:
            with urllib.request.urlopen(base + route, timeout=120) as r:
                return r.status, r.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()

    ids = list(pipe._row)
    try:
        reqs = [ids[(37 * i) % len(ids)] for i in range(S_HTTP)]
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(S_HTTP) as ex:
            answers = list(ex.map(
                lambda t: get("/caption?" + urlencode({"template": t})),
                reqs))
        secs = time.perf_counter() - t0
        for (status, body), t in zip(answers, reqs):
            if status != 200:
                raise AssertionError(f"/caption {t}: {status} {body[:200]}")
            check_caption(body.decode(), pipe.vocab, f"/caption {t}")
        status, body = get("/captions?" + urlencode(
            [("template", ids[1]), ("template", "no-such-template"),
             ("template", ids[2])], doseq=True))
        rows = json.loads(body)
        if status != 200 or [r["template"] for r in rows] != [
                ids[1], "no-such-template", ids[2]] or rows[1].get(
                "error_type") != "KeyError":
            raise AssertionError(f"/captions: {status} {rows}")
        for r in (rows[0], rows[2]):
            check_caption(r.get("caption", ""), pipe.vocab, "/captions")
        status, body = get("/meme?" + urlencode({"template": ids[0]}))
        # no Pillow: the route says so; with it, no template has an image
        want = 404 if importlib.util.find_spec("PIL") else 501
        if status != want:
            raise AssertionError(f"/meme: {status} {body[:200]} (want "
                                 f"{want})")
        status, body = get("/healthz")
        health = json.loads(body)
        if (status != 200 or not health["ok"]
                or health["requests"] < S_HTTP + 2):
            raise AssertionError(f"/healthz: {status} {health}")
        srv = ev.caption_srv
        log(f"  HTTP: {S_HTTP} concurrent /caption answered 200 in "
            f"{secs:.3f} s (batches {srv.batch_sizes}, padded to "
            f"{srv.pad_sizes}); /captions: two captions and {rows[1]}; "
            f"/meme {want}; /healthz {health}")
    finally:
        ev.httpd.shutdown()
        server.join(timeout=60)
    if server.is_alive():
        raise AssertionError("serving: the HTTP server did not stop")


def batcher_phase(pipe, kw, name_limit):
    """S_REQUESTS submits from S_THREADS threads through a
    DynamicBatcher: captions/s from the first submit to the last answer,
    and the latency of each request from its submit to its answer."""
    from deephumor_tpu_torch.serving import DynamicBatcher

    ids = list(pipe._row)
    n = S_REQUESTS
    t_sub, t_done, futs = [0.0] * n, [0.0] * n, [None] * n
    barrier = threading.Barrier(S_THREADS)

    with DynamicBatcher(pipe, max_batch=S_MAX_BATCH, buckets="auto", seed=2,
                        **kw) as srv:
        def client(k):
            barrier.wait()
            for i in range(k, n, S_THREADS):
                t_sub[i] = time.perf_counter()
                f = srv.submit(ids[i % len(ids)])
                f.add_done_callback(
                    lambda _, i=i: t_done.__setitem__(i, time.perf_counter()))
                futs[i] = f

        clients = [threading.Thread(target=client, args=(k,))
                   for k in range(S_THREADS)]
        for c in clients:
            c.start()
        for c in clients:
            c.join()
        texts = [f.result(timeout=300) for f in futs]
    for i, text in enumerate(texts):
        check_caption(text, pipe.vocab, f"batcher request {i}")
    wall = max(t_done) - min(t_sub)
    lat = np.array(t_done) - np.array(t_sub)
    stats = {
        "requests": srv.requests_served, "batches": srv.batches_dispatched,
        "batch_sizes": srv.batch_sizes, "buckets": sorted(set(srv.pad_sizes)),
        "captions_per_s": n / wall,
        "p50_ms": float(np.percentile(lat, 50)) * 1e3,
        "p99_ms": float(np.percentile(lat, 99)) * 1e3, "card": name_limit}
    if stats["requests"] != n:
        raise AssertionError(f"batcher: served {stats['requests']} of {n}")
    log(f"  batcher: {n} requests from {S_THREADS} threads in "
        f"{stats['batches']} batches (sizes {stats['batch_sizes']}, buckets "
        f"{stats['buckets']}): {stats['captions_per_s']:.1f} captions/s, p50 "
        f"{stats['p50_ms']:.1f} ms, p99 {stats['p99_ms']:.1f} ms | "
        f"{name_limit}")
    return stats


def check_serving(CaptioningTransformer, tree_map, _build, modules, dev,
                  name_limit):
    """The serving phase (see the module docstring). Returns the launches
    of its main path and its numbers."""
    from deephumor_tpu_torch.data import Vocab
    from deephumor_tpu_torch.experiments.inference import seq_to_text
    from deephumor_tpu_torch.ops.image_ops import preprocess_batch
    from deephumor_tpu_torch.pipeline import MemeGenerationPipeline
    from deephumor_tpu_torch.serving import DynamicBatcher

    model, params = make_model(CaptioningTransformer, "bfloat16", dev, False)
    bias = params["decoder"]["classifier"]["bias"]
    bias[0], bias[3] = S_PAD_BIAS, S_EOS_BIAS
    vocab = Vocab([f"word{i}" for i in range(VOCAB - 6)])
    if len(vocab) != VOCAB:
        raise AssertionError(f"vocabulary of {len(vocab)} tokens")
    pipe = MemeGenerationPipeline(model, params, vocab)
    u8 = torch.randint(0, 256, (S_TEMPLATES, *S_HW, 3), dtype=torch.uint8,
                       device=dev,
                       generator=torch.Generator(dev).manual_seed(8))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    images = preprocess_batch(u8)
    torch.cuda.synchronize()
    t_pre = time.perf_counter() - t0
    err = (images.cpu() - preprocess_batch(u8.cpu())).abs().max().item()
    log(f"  preprocess_batch: {S_TEMPLATES} x {S_HW} uint8 -> "
        f"{tuple(images.shape)} f32 on the card in {t_pre * 1e3:.1f} ms; "
        f"max|card-CPU| {err:.3e} (atol {S_PRE_TOL})")
    if not err <= S_PRE_TOL:
        raise AssertionError("preprocess_batch: card and CPU disagree")
    ids = [f"t{i:03d}" for i in range(S_TEMPLATES)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe.add_templates(ids, images, batch_size=S_CHUNK)
    pipe._stack_features(ids[:1])
    torch.cuda.synchronize()
    t_enc = time.perf_counter() - t0
    k = 7
    got = pipe._stack_features([ids[k]])
    want = model.encode({"encoder": tree_map(lambda t: t.cpu(),
                                             params["encoder"])},
                        images[k:k + 1].cpu())
    errs = []
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, atol=S_ENC_TOL, rtol=S_ENC_TOL)
        errs.append(((g.cpu() - w).abs().max().item(),
                     w.abs().max().item()))
    log(f"  add_templates: {S_TEMPLATES} templates in chunks of {S_CHUNK} "
        f"through ResNet-50 (f32) in {t_enc:.3f} s; template {k}'s (global, "
        f"spatial) encoding vs the CPU encoder: (max|diff|, max|value|) "
        f"{[(f'{e:.2e}', f'{m:.2e}') for e, m in errs]} (atol=rtol "
        f"{S_ENC_TOL})")

    kw = dict(max_len=MAX_LEN, beam_size=BEAM, top_k=TOP_K, temperature=1.0,
              sampler="pallas")
    for eos_bias in (EOS_BIAS, S_EOS_BIAS):
        bias[3] = eos_bias
        ended, empty = id_round_trip(model, params, pipe, ids, kw, 9)
        log(f"  ids -> text -> ids equal up to the first EOS on all "
            f"{S_TEMPLATES} captions at EOS bias {eos_bias} ({ended} ended "
            f"early, {empty} empty)")
    # the batcher's largest call, alone and through the pipeline
    rows = ids[:S_MAX_BATCH]
    enc = pipe._stack_features(rows)
    rates = {}
    for label, fn in (
            ("generate_from_emb", lambda g: model.generate_from_emb(
                params, enc, generator=g, **kw)),
            ("pipeline.generate_captions",
             lambda g: pipe.generate_captions(rows, g, **kw))):
        secs = []
        for seed in (10, 11, 12):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(torch.Generator(dev).manual_seed(seed))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        rates[label] = [S_MAX_BATCH / s for s in secs]
        log(f"  {label}, {S_MAX_BATCH} items: "
            f"{', '.join(f'{r:.1f}' for r in rates[label])} captions/s")
    # the pipeline's own work around that call: the gather from the
    # store, the chosen ids' copy to the host, the text decoding
    chosen = model.generate_from_emb(
        params, enc, generator=torch.Generator(dev).manual_seed(13),
        **kw)["chosen"]
    rows_np = chosen.cpu().numpy()
    own = {"gather_ms": host_ms(lambda: pipe._stack_features(rows)),
           "to_host_ms": host_ms(lambda: chosen.cpu()),
           "decode_ms": host_ms(lambda: [seq_to_text(r, vocab)
                                         for r in rows_np])}
    log(f"  the pipeline's own work at {S_MAX_BATCH} items (ms): {own}")

    hits, restore = twin_guard(modules)
    _build.reset_launch_counts()
    try:
        http_phase(pipe, kw)
        stats = batcher_phase(pipe, kw, name_limit)
        runs = []
        for _ in range(2):
            with DynamicBatcher(pipe, max_batch=S_MAX_BATCH, buckets="auto",
                                seed=5, **kw) as srv:
                runs.append([srv.submit(t).result(timeout=120)
                             for t in ids[:8]])
    finally:
        restore()
    launches = dict(_build.LAUNCHES)
    if runs[0] != runs[1]:
        raise AssertionError("batchers of one seed fed the same ids one by "
                             "one gave different texts")
    log(f"  two batchers of seed 5, 8 ids one by one: equal texts "
        f"({len(set(runs[0]))} distinct)")
    word = ("ancestry_attention_update", "grouped_cross_attention",
            "fused_topk_gumbel_sample")
    missing = [k for k in word if launches[k] < 1]
    extra = [k for k, v in launches.items() if v and k not in word]
    log(f"  serving launches {launches}; plain twins called with CUDA "
        f"tensors: {sorted(set(hits))}")
    if missing or extra or hits:
        raise AssertionError(f"serving: kernels not launched {missing}, "
                             f"launched off the path {extra}, twins on the "
                             f"card {sorted(set(hits))}")
    stats.update(own, preprocess_ms=t_pre * 1e3, encode_s=t_enc,
                 generate_from_emb_per_s=rates["generate_from_emb"],
                 pipeline_per_s=rates["pipeline.generate_captions"])
    return launches, stats


class MemorySet:
    """A dataset held in memory for ``BatchIterator``'s fast path: its id
    matrices come from ``materialize`` as the lengths ask (one caption
    per template, repeated), its images (if any) from ``images``."""

    preload_images = True

    def __init__(self, captions, keys, images=None):
        self.captions, self.keys = captions, keys
        self.images = images if images is not None else {}

    def __len__(self):
        return len(self.keys)

    def materialize(self, max_caption_len, max_label_len):
        from deephumor_tpu_torch.data.dataloaders import pad_ids

        rows = [self.captions[k] for k in self.keys]
        return {"captions": pad_ids(rows, max_caption_len),
                "labels": pad_ids([[int(k[1:]) % 97 + 6] * 3
                                   for k in self.keys], max_label_len),
                "image_keys": self.keys}


def memory_set(n_items, n_templates, vocab, seed, images=None):
    """``n_items`` captions over ``n_templates`` templates, each template
    with one caption of 8-32 tokens + EOS."""
    from deephumor_tpu_torch.data import EOS_ID

    rng = np.random.default_rng(seed)
    keys = [f"t{i:03d}" for i in range(n_templates)]
    captions = {k: list(rng.integers(6, vocab, rng.integers(8, T_CAP + 1)))
                + [EOS_ID] for k in keys}
    items = [keys[i] for i in rng.integers(0, n_templates, n_items)]
    return MemorySet(captions, items, images), keys


def train_step_cost(bs, seq, t_enc, d, layers, pf, vocab):
    """Operations of one train step of the cross-attention model at the
    padded length ``seq``: forward plus backward (2x) of every product,
    the encoder head's linear without an input gradient; and the bytes
    the step must move at least (the f32 masters, gradients and two
    moments, read and written, and the gathered features)."""
    per_pos = (layers * (8 * d * d + 2 * d * pf + 4 * seq * d)
               + d * vocab)
    head = bs * (t_enc + 1) * 2048 * d
    flops = 2 * (3 * bs * seq * per_pos + 2 * head)
    n_params = (2 * vocab * d + vocab + 50 * d + 2048 * d
                + layers * (8 * d * d + 2 * d * pf))
    nbytes = 4 * n_params * 7 + bs * t_enc * 2048 * 4
    return flops, nbytes


def train_epoch_timed(trainer, state, loader, gen):
    """``run_epoch`` with a CUDA event at the start of every step (no
    sync in between): the device-side period of each step, the epoch's
    host time, and the peak memory."""
    events = []
    step = trainer._train_step

    def timed(st, batch, g):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        return step(st, batch, g)

    trainer._train_step = timed
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        state, loss, pp = trainer.run_epoch(state, loader, gen)
    finally:
        trainer._train_step = step
    end = torch.cuda.Event(enable_timing=True)
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    events.append(end)
    ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    return state, ms, wall, torch.cuda.max_memory_allocated()


def check_train(CaptioningTransformer, tree_map, _build, modules, dev,
                name_limit, logdir):
    """The train phase (module docstring, [12]), writing its logs and
    checkpoint under ``logdir``. Returns the launches of the trained
    model's serving calls and the phase's numbers."""
    import dataclasses
    import itertools

    from torch.profiler import ProfilerActivity, profile

    from deephumor_tpu_torch.data.dataloaders import BatchIterator
    from deephumor_tpu_torch.experiments.trainer import Trainer
    from deephumor_tpu_torch.models import (CaptioningLSTM,
                                            CaptioningLSTMWithLabels,
                                            CaptioningTransformerBase)
    from deephumor_tpu_torch.models.encoders import image_encoder_apply
    from deephumor_tpu_torch.utils.pytree import flatten_tree

    out = {}
    model = CaptioningTransformer(num_tokens=VOCAB, hid_dim=HID,
                                  n_layers=LAYERS, n_heads=HEADS, pf_dim=PF,
                                  max_len=50)
    ds, _ = memory_set(T_ITEMS, T_TEMPLATES, VOCAB, 11)
    loader = BatchIterator(ds, T_BATCH, max_caption_len=T_CAP + 1, seed=0,
                           image_rows={f"t{i:03d}": i
                                       for i in range(T_TEMPLATES)})
    trainer = Trainer(model, "smoke", log_dir=logdir,
                      compute_dtype="bfloat16", device=dev)
    state = trainer.init_state(torch.Generator(dev).manual_seed(0))
    # random unit-scale trunk features, as the JAX package's measurement
    # (a random ResNet's features run ~30x hotter and stall the
    # cross-attention model: its docstring)
    trainer._trunk_cache = torch.randn(
        T_TEMPLATES, 7, 7, 2048, device=dev,
        generator=torch.Generator(dev).manual_seed(12))
    # the frozen ResNet and the head's batch-norm statistics, before
    flat0 = {k: v.clone() for k, v in flatten_tree(state["params"]).items()
             if "resnet" in k or k.startswith("encoder/bn/running")}
    gen = torch.Generator(dev).manual_seed(13)
    steps = itertools.islice(itertools.chain.from_iterable(
        loader for _ in range(T_STEPS // len(loader) + 1)), T_STEPS)
    _build.reset_launch_counts()
    state, ms, wall, peak = train_epoch_timed(trainer, state, steps, gen)
    if any(_build.LAUNCHES.values()):
        raise AssertionError(f"train steps launched kernels "
                             f"{dict(_build.LAUNCHES)}")
    losses = [json.loads(line)["value"] for line in open(os.path.join(
        trainer.experiment_dir, "train", "metrics.jsonl"))
        if '"train/batch_loss"' in line]
    flat = flatten_tree(state["params"])
    frozen_same = all(torch.equal(flat[k], v) for k, v in flat0.items()
                      if "resnet" in k)
    stats_moved = all(not torch.equal(flat[k], v) for k, v in flat0.items()
                      if k.startswith("encoder/bn/"))
    opt_keys = set(state["opt_state"]["mu"])
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    flops, nbytes = train_step_cost(T_BATCH, max(T_CAP + 1, T_ENC), T_ENC,
                                    HID, LAYERS, PF, VOCAB)
    floor = bound(nbytes, flops, torch.bfloat16)
    med = float(np.median(ms[T_WARM:]))
    out["word"] = {
        "steps": len(losses), "loss_first5": first, "loss_last5": last,
        "step_ms_median": med, "step_ms": [round(x, 3) for x in ms],
        "examples_per_s": T_BATCH / med * 1e3,
        "epoch_wall_s": wall, "host_ms_per_step": wall / len(ms) * 1e3,
        "peak_mem_gib": peak / 2**30, "tflop_per_step": flops / 1e12,
        "bound_ms": floor["bound_ms"], "bound_by": floor["bound_by"],
        "floor_share": floor["bound_ms"] / med}
    log(f"  word train, bf16, batch {T_BATCH}, {len(losses)} steps, "
        f"prefetch 2 ({name_limit}): median step {med:.2f} ms after "
        f"{T_WARM} warm-up steps, {T_BATCH / med * 1e3:.1f} examples/s, "
        f"peak memory {peak / 2**30:.2f} GiB; floor {floor['bound_ms']:.3f} "
        f"ms ({flops / 1e12:.3f} TFLOP, by {floor['bound_by']}) = "
        f"{floor['bound_ms'] / med:.3f} of the step; loss first 5 "
        f"{first:.4f} -> last 5 {last:.4f}; launches 0")
    if not (len(losses) == T_STEPS and np.isfinite(losses).all()
            and last < first):
        raise AssertionError(f"word train: losses {losses}")
    if not (frozen_same and stats_moved) or any(
            "resnet" in k or "running" in k for k in opt_keys):
        raise AssertionError("word train: the ResNet moved, the BN "
                             "statistics did not, or either is trained")

    # one profiled window of T_PROFILED steps
    window = itertools.islice(iter(loader), T_PROFILED)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _, _ = trainer.run_epoch(state, window, gen)
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if getattr(e, "device_time_total", 0) > 0
              and e.device_type.name == "CUDA"]
    busy = sum(e.device_time_total for e in events) / 1e3
    # cuBLAS products (nvjet / gemm kernels) against the rest
    gemm = sum(e.device_time_total for e in events
               if "nvjet" in e.key or "gemm" in e.key) / 1e3
    events.sort(key=lambda e: -e.device_time_total)
    out["word"]["profile"] = {
        "wall_ms": pwall * 1e3, "device_ms": busy, "matmul_ms": gemm,
        "idle_share": 1 - busy / (pwall * 1e3),
        "idle_share_unprofiled": 1 - busy / T_PROFILED / med,
        "top": [[e.key[:80], e.device_time_total / 1e3, e.count]
                for e in events[:20]]}
    log(f"  word train profile, {T_PROFILED} steps ({name_limit}): wall "
        f"{pwall * 1e3:.1f} ms, device kernel time {busy:.1f} ms (matmuls "
        f"{gemm:.1f} ms), idle share {1 - busy / (pwall * 1e3):.3f} under "
        f"the profiler, {1 - busy / T_PROFILED / med:.3f} against the "
        f"unprofiled median step")
    for e in events[:20]:
        log(f"  {e.device_time_total / 1e3:10.3f} ms {e.count:6d} calls  "
            f"{e.key[:90]}")

    # train, save, serve: the trained checkpoint through K1, K2 and K3
    path = os.path.join(logdir, "trained")
    model.save(state["params"], path)
    served, sparams = CaptioningTransformer.from_pretrained(path, device=dev)
    served = dataclasses.replace(served, compute_dtype="bfloat16")
    with torch.inference_mode():
        enc = image_encoder_apply(
            sparams["encoder"], trainer._trunk_cache[:T_SERVE_BATCH],
            spatial_features=True, from_trunk=True)
    kw = dict(max_len=MAX_LEN, beam_size=BEAM, top_k=TOP_K)
    hits, restore = twin_guard(modules)
    _build.reset_launch_counts()
    try:
        outs = [served.generate_from_emb(sparams, enc, greedy=True, **kw),
                served.generate_from_emb(
                    sparams, enc, sampler="pallas",
                    generator=torch.Generator(dev).manual_seed(14), **kw)]
    finally:
        restore()
    launches = dict(_build.LAUNCHES)
    for o in outs:
        check_output(o, T_SERVE_BATCH, VOCAB, BEAM, MAX_LEN)
    word = ("ancestry_attention_update", "grouped_cross_attention",
            "fused_topk_gumbel_sample")
    missing = [k for k in word if launches[k] < 1]
    extra = [k for k, v in launches.items() if v and k not in word]
    log(f"  trained model saved, loaded on the card, served at batch "
        f"{T_SERVE_BATCH} (greedy, sampled): launches {launches}; plain "
        f"twins called with CUDA tensors: {sorted(set(hits))}")
    if missing or extra or hits:
        raise AssertionError(f"train_serve: kernels not launched {missing}, "
                             f"launched off the path {extra}, twins on the "
                             f"card {sorted(set(hits))}")
    del trainer, state, enc, outs, served, sparams

    # from images: the ResNet at 224 x 224, no cache; the trunk takes no
    # gradient
    rng = np.random.default_rng(15)
    images = {f"t{i:03d}": rng.normal(size=(224, 224, 3)).astype(np.float32)
              for i in range(8)}
    ids, _ = memory_set(3 * T_IMG_BATCH, 8, VOCAB, 16, images)
    trainer = Trainer(model, "smoke_images", log_dir=logdir,
                      compute_dtype="bfloat16", device=dev)
    state = trainer.init_state(torch.Generator(dev).manual_seed(0))
    resnet0 = {k: v.clone() for k, v in flatten_tree(state["params"]).items()
               if "resnet" in k}
    state, loss, _ = trainer.run_epoch(state, BatchIterator(
        ids, T_IMG_BATCH, max_caption_len=T_CAP + 1, seed=0),
        torch.Generator(dev).manual_seed(17))
    flat = flatten_tree(state["params"])
    grad_free = all(torch.equal(flat[k], v) and not flat[k].requires_grad
                    for k, v in resnet0.items())
    log(f"  word train from images (224 x 224, batch {T_IMG_BATCH}, 3 "
        f"steps, the ResNet in each): mean loss {loss:.4f}; ResNet "
        f"unchanged and without a gradient: {grad_free}")
    if not (np.isfinite(loss) and grad_free and state["step"] == 3):
        raise AssertionError("train from images")
    out["images"] = {"loss": loss}
    del trainer, state

    # f32 parity: the same weights and batches, 3 steps on the card and on
    # the CPU, dropout 0
    pmodel = CaptioningTransformer(
        num_tokens=VOCAB, hid_dim=HID, n_layers=T_PAR_LAYERS, n_heads=HEADS,
        pf_dim=PF, max_len=50, enc_dropout=0.0, dec_dropout=0.0)
    params = pmodel.init(torch.Generator().manual_seed(18), device="cpu")
    feats = torch.randn(16, 7, 7, 2048,
                        generator=torch.Generator().manual_seed(19))
    pds, _ = memory_set(T_PAR_BATCH * T_PAR_STEPS, 16, VOCAB, 20)
    pbatches = list(BatchIterator(pds, T_PAR_BATCH, max_caption_len=T_CAP + 1,
                                  seed=0, image_rows={
                                      f"t{i:03d}": i for i in range(16)}))
    runs = {}
    for i, where in enumerate(("cpu", dev)):
        tr = Trainer(pmodel, f"parity{i}", log_dir=logdir, device=where,
                     prefetch=0, log_flush_every=1)
        st = tr.init_state(params=tree_map(
            lambda t, w=where: t.clone().to(w), params))
        tr._trunk_cache = feats.to(where)
        st, _, _ = tr.run_epoch(st, pbatches, torch.Generator(where))
        lines = open(os.path.join(tr.experiment_dir, "train",
                                  "metrics.jsonl")).read().splitlines()
        runs[i] = (
            [json.loads(x)["value"] for x in lines
             if '"train/batch_loss"' in x],
            {k: v.cpu() for k, v in flatten_tree(st["params"]).items()})
    (l_cpu, p_cpu), (l_gpu, p_gpu) = runs[0], runs[1]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(l_gpu, l_cpu))
    param_err = max((p_gpu[k] - v).abs().max().item()
                    for k, v in p_cpu.items())
    log(f"  f32 parity, {T_PAR_LAYERS} layers, batch {T_PAR_BATCH}, "
        f"{T_PAR_STEPS} steps: losses card {l_gpu} vs CPU {l_cpu} (max rel "
        f"{loss_err:.2e}, rtol {T_PAR_RTOL}); parameters max|card-CPU| "
        f"{param_err:.2e} (atol {T_PAR_ATOL})")
    if not (len(l_gpu) == T_PAR_STEPS and loss_err <= T_PAR_RTOL
            and param_err <= T_PAR_ATOL):
        raise AssertionError("train f32 parity: card and CPU disagree")
    out["parity"] = {"loss_rel_err": loss_err, "param_abs_err": param_err}

    # the other three captioners, 3 f32 steps each at small widths
    small = dict(num_tokens=1000)
    for cls, hp in (
            (CaptioningLSTM, dict(emb_dim=64, hidden_size=64, num_layers=2)),
            (CaptioningLSTMWithLabels, dict(emb_dim=64, hidden_size=64,
                                            num_layers=2)),
            (CaptioningTransformerBase, dict(hid_dim=64, n_layers=2,
                                             n_heads=4, pf_dim=128,
                                             max_len=50))):
        m = cls(**small, **hp)
        tr = Trainer(m, "small", log_dir=logdir, device=dev)
        st = tr.init_state(torch.Generator(dev).manual_seed(0))
        tr._trunk_cache = feats[:8].to(dev)
        sds, _ = memory_set(3 * 32, 8, 1000, 21)
        st, loss, _ = tr.run_epoch(st, BatchIterator(
            sds, 32, max_caption_len=T_CAP + 1, seed=0,
            image_rows={f"t{i:03d}": i for i in range(8)}),
            torch.Generator(dev).manual_seed(22))
        log(f"  {cls.__name__}: 3 f32 steps from the trunk cache, mean "
            f"loss {loss:.4f}")
        if not (np.isfinite(loss) and st["step"] == 3):
            raise AssertionError(f"{cls.__name__}: train steps")
        out[cls.__name__] = {"loss": loss}
    return launches, out


def cold_build():
    """``--cold-build``: two batchers' first calls, made together in this
    cold process, over a small model on the card, with the kernel library
    built into a fresh directory. Prints one JSON line: the nvcc runs,
    the library loads, and when each thread first asked for the library
    (seconds from the start of the build)."""
    import ctypes
    import shutil

    from deephumor_tpu_torch.data import Vocab
    from deephumor_tpu_torch.models import CaptioningTransformer
    from deephumor_tpu_torch.ops import _build
    from deephumor_tpu_torch.pipeline import MemeGenerationPipeline
    from deephumor_tpu_torch.serving import DynamicBatcher

    dev = torch.device("cuda", 0)
    _build.BUILD_DIR = _build.BUILD_DIR / f"cold-{os.getpid()}"
    runs, loads, first = [], [], {}
    run_all, library, cdll = _build._run_all, _build.library, ctypes.CDLL

    def counted_run_all(cmds, log_):
        start = time.perf_counter()
        run_all(cmds, log_)
        runs.append(("link" if "-shared" in cmds[0] else "compile", start,
                     time.perf_counter()))

    def recorded_library():
        first.setdefault(threading.get_ident(), time.perf_counter())
        return library()

    def counted_cdll(name, *args, **kwargs):
        if "libdh_kernels" in str(name):  # torch loads libraries too
            loads.append(name)
        return cdll(name, *args, **kwargs)

    _build._run_all, _build.library = counted_run_all, recorded_library
    ctypes.CDLL = counted_cdll
    try:
        vocab = Vocab([f"word{i}" for i in range(58)])
        model = CaptioningTransformer(num_tokens=len(vocab), hid_dim=64,
                                      n_layers=1, n_heads=4, pf_dim=128,
                                      max_len=18, compute_dtype="bfloat16")
        params = model.init(torch.Generator(dev).manual_seed(0), dev)
        pipe = MemeGenerationPipeline(model, params, vocab)
        pipe.add_templates(["a", "b"], torch.randn(
            2, 64, 64, 3, device=dev,
            generator=torch.Generator(dev).manual_seed(1)))
        kw = dict(max_len=8, beam_size=2, top_k=8, sampler="pallas")
        barrier, texts = threading.Barrier(2), []
        with DynamicBatcher(pipe, max_batch=4, seed=0, **kw) as one, \
                DynamicBatcher(pipe, max_batch=4, seed=1, **kw) as two:
            def request(srv, tid):
                barrier.wait()
                texts.append(srv.submit(tid).result(timeout=600))

            threads = [threading.Thread(target=request, args=a)
                       for a in ((one, "a"), (two, "b"))]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
    finally:
        ctypes.CDLL = cdll
        shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)
    start = min((r[1] for r in runs), default=0.0)
    end = max((r[2] for r in runs), default=0.0)
    print(json.dumps({
        "compile_runs": sum(r[0] == "compile" for r in runs),
        "link_runs": sum(r[0] == "link" for r in runs),
        "loads": len(loads), "answers": len(texts),
        "first_calls_s": sorted(t - start for t in first.values()),
        "build_s": end - start}), flush=True)


def check_cold_build():
    """Runs ``--cold-build`` in a subprocess and checks its line: one
    compile run, one link, one load, and both batchers' threads asked for
    the library before the build had ended."""
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--cold-build"],
        capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"cold build phase failed:\n"
                             f"{proc.stderr[-4000:]}")
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    log(f"  cold process, two batchers' first calls together: {got}")
    if not (got["compile_runs"] == got["link_runs"] == got["loads"] == 1
            and got["answers"] == 2 and len(got["first_calls_s"]) == 2
            and max(got["first_calls_s"]) < got["build_s"]):
        raise AssertionError("cold build: the library was not built once "
                             "for two threads that asked at once")


def kernel_times(root):
    """Device times (queued) of K4 at the char shape, all rows and C_LIVE
    live, and of K9 (ng PACK) beside K2 on the same rows at the word and
    char shapes, through the deephumor_tpu_torch of the tree at ``root``:
    given another tree's root, it times that tree's kernels on the same
    inputs (a change beside its parent, in one call). Prints one JSON
    line."""
    sys.path.insert(0, os.path.abspath(root))
    from deephumor_tpu_torch.ops import attention as A
    from deephumor_tpu_torch.ops import sampler as S

    dev = torch.device("cuda", 0)
    gen = torch.Generator(dev).manual_seed(0)
    out = {"tree": root, "card": card()}
    x, w, b = k4_inputs(dev, gen)
    kw = dict(top_k=C_TOP_K, num_draws=C_BEAM)
    for key, live in (("k4_ms", None), ("k4_ms_live", C_LIVE)):
        out[key] = cuda_ms(lambda: S.fused_classifier_topk_gumbel_sample(
            x, w, b, 7, 1 / C_TEMP, live_rows=live, **kw), queued=True)
    for label, items, beam in (("word", BATCH, BEAM),
                               ("char", C_BATCH, C_BEAM)):
        q, ek, ev, bias = k9_inputs(A, dev, gen, items, beam)
        for ng in (2, PACK, 8):
            kw9 = dict(n_heads=HEADS, pack_items=ng, t_real=T_ENC)
            out[f"k9_ms_{label}_ng{ng}"] = cuda_ms(
                lambda: A.grouped_cross_attention(q, ek, ev, bias, **kw9),
                queued=True)
        out[f"k2_ms_{label}"] = k2_on_k9_rows(A, q, ek, ev, bias, None)
    print(json.dumps(out), flush=True)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; nothing is run")
    if sys.argv[1:2] == ["--kernel-times"]:
        return kernel_times(sys.argv[2] if len(sys.argv) > 2 else ".")
    if sys.argv[1:2] == ["--cold-build"]:
        return cold_build()
    from deephumor_tpu_torch.models import (CaptioningLSTM,
                                            CaptioningLSTMWithLabels,
                                            CaptioningTransformer,
                                            CaptioningTransformerBase)
    from deephumor_tpu_torch.ops import _build
    from deephumor_tpu_torch.ops import attention as A
    from deephumor_tpu_torch.ops import cache as C
    from deephumor_tpu_torch.ops import engine as E
    from deephumor_tpu_torch.ops import sampler as S
    from deephumor_tpu_torch.utils.pytree import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    # the f32 ResNet runs on cuDNN in full f32, as the JAX encoder does
    torch.backends.cudnn.allow_tf32 = False
    # the default legs run without the two switches; switched legs set them
    for key in ("DH_CROSS_PACK", "DH_FUSED_SURVIVOR"):
        os.environ.pop(key, None)
    dev = torch.device("cuda", 0)
    name_limit = card()
    t_start = time.perf_counter()
    log(f"[1] device: {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()} | nvidia-smi: {name_limit} | torch "
        f"{torch.__version__} CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    _build.library()
    log(f"[2] kernels built and loaded in {time.perf_counter() - t0:.1f} s "
        f"-> {_build.BUILD_DIR}")
    for line in (_build.BUILD_DIR / "nvcc.log").read_text().splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            log("    " + line.strip())

    gen = torch.Generator(dev).manual_seed(0)
    rows = {}
    log(f"[3] word kernels: K1 rows {ROWS}, P {P}, D {HID}, bf16")
    rows["ancestry_attention_update"] = check_k1(
        A, dev, gen, items=BATCH, beam=BEAM, p=P, pes=(16, 24, 32),
        dt=torch.bfloat16)
    log(f"    K2 G {BATCH}, r {BEAM}, T {T_ENC}: bf16 timed; f32, no bias, "
        f"head_dim 24 (bf16, f32), 0 and 500 live items")
    rows["grouped_cross_attention"] = check_k2(A, dev, gen, items=BATCH,
                                               beam=BEAM)
    f32 = torch.float32
    for k2 in (dict(dt=f32), dict(masked=False), dict(d=24 * HEADS),
               dict(d=24 * HEADS, dt=f32), dict(live_items=0),
               dict(live_items=500)):
        check_k2(A, dev, gen, items=BATCH, beam=BEAM, timed=False, **k2)
    log(f"    K3 [{ROWS}, {VOCAB}] bf16, top_k {TOP_K}, draws {BEAM}; f32; "
        f"V 3001 (rows start unaligned); f32 at V 52000 (no vector table)")
    rows["fused_topk_gumbel_sample"] = check_k3(
        S, dev, gen, rows=ROWS, vocab=VOCAB, top_k=TOP_K, draws=BEAM,
        inv_t=1.0, label="K3")
    rows["fused_topk_gumbel_sample"]["ms_f32"] = check_k3(
        S, dev, gen, rows=ROWS, vocab=VOCAB, top_k=TOP_K, draws=BEAM,
        inv_t=1.0, label="K3 f32", dt=f32)["ms"]
    check_k3(S, dev, gen, rows=ROWS, vocab=3001, top_k=TOP_K, draws=BEAM,
             inv_t=1.0, label="K3 V 3001", timed=False)
    # rows too long for the vector table beside a full candidate list
    check_k3(S, dev, gen, rows=1000, vocab=52000, top_k=TOP_K, draws=BEAM,
             inv_t=1.0, label="K3 f32 V 52000", dt=f32, timed=False)
    log(f"    K9 G {BATCH}, r {BEAM}, T {T_ENC} padded to {T_PAD}, ng 2, 4, 8")
    rows["cross_attention_packed"] = check_k9(A, dev, gen, items=BATCH,
                                              beam=BEAM, ngs=(2, 4, 8))
    log(f"    K10 items {BATCH}, beam {BEAM}, L {MAX_LEN}, P {MAX_LEN + 1}")
    rows["fused_survivor_update"] = check_k10(E, dev, gen, items=BATCH,
                                              beam=BEAM, length=MAX_LEN)
    log(f"    K7 rows {ROWS}, P {P}: native4d p_eff 32, 16, 24; grouped, "
        f"blockdiag (all P)")
    rows["ancestry_attention"] = check_k7(
        A, dev, gen, items=BATCH, beam=BEAM, p=P, label="K7",
        cases=(("native4d", 32), ("native4d", 16), ("native4d", 24),
               ("grouped", None), ("blockdiag", None)))
    log(f"    K8 rows {ROWS}, P {P}, pos 7, 39, 31, beside K1")
    rows["ancestry_attention_update_flash"] = check_k8(
        A, dev, gen, items=BATCH, beam=BEAM, p=P, positions=(7, 39, 31),
        label="K8")
    log(f"    K11 rows {ROWS}, P {P}, D {HID}")
    rows["cache_column_write"] = check_k11(C, dev, gen, rows=ROWS, p=P,
                                           positions=(0, 17, 39), label="K11")

    log("[4] word greedy generate_from_emb, f32, kernels (without and with "
        "both switches) vs plain CPU path")
    check_greedy(CaptioningTransformer, tree_map, _build, dev, char=False)

    log(f"[5] word main path: bf16, sampler='pallas', batch {BATCH}")
    model, params = make_model(CaptioningTransformer, "bfloat16", dev, False)
    kw = dict(max_len=MAX_LEN, beam_size=BEAM, top_k=TOP_K,
              temperature=1.0, sampler="pallas")
    images = torch.randn(8, 224, 224, 3, device=dev,
                         generator=torch.Generator(dev).manual_seed(2))
    out = model.generate(params, images,
                         generator=torch.Generator(dev).manual_seed(3), **kw)
    check_output(out, 8, VOCAB, BEAM, MAX_LEN)
    log("  generate(8 images 224x224): ok")
    word_kernels = ("ancestry_attention_update", "grouped_cross_attention",
                    "fused_topk_gumbel_sample")
    enc = features(BATCH, dev, 4)
    legs = {}
    out, legs["word"] = drive(model, params, enc, _build, kw, name_limit,
                              "word", word_kernels)
    check_output(out, BATCH, VOCAB, BEAM, MAX_LEN)
    profile_call(model, params, enc, kw, name_limit, "word", 12)
    fused, legs["word_fused"] = drive(
        model, params, enc, _build, kw, name_limit, "word_fused",
        word_kernels + ("fused_survivor_update",), fused=True)
    # K3 draws once after the prefill and once per decode step
    check_leg_launches("word_fused", legs["word_fused"], False,
                       legs["word_fused"]["fused_topk_gumbel_sample"] - 1)
    # no compaction at 32 steps: K10 changes no draw
    if not (torch.equal(fused["sequences"], out["sequences"])
            and torch.equal(fused["scores"], out["scores"])):
        raise AssertionError("word_fused: sequences or scores differ from "
                             "the default word leg's at the same seed")
    log("  word_fused: sequences and scores equal to the word leg's")
    out, legs["word_packed_fused"] = drive(
        model, params, enc, _build, kw, name_limit, "word_packed_fused",
        word_kernels + ("cross_attention_packed", "fused_survivor_update"),
        pack=PACK, fused=True)
    check_output(out, BATCH, VOCAB, BEAM, MAX_LEN)
    check_leg_launches(
        "word_packed_fused", legs["word_packed_fused"], True,
        legs["word_packed_fused"]["fused_topk_gumbel_sample"] - 1)
    profile_call(model, params, enc, kw, name_limit, "word_packed_fused", 12,
                 pack=PACK, fused=True)
    del model, params, out, fused, enc
    log(f"    elapsed {time.perf_counter() - t_start:.1f} s")

    log("[6] decoder-only transformer and LSTM: greedy f32 on the card vs "
        "plain CPU path, then the serving legs (bf16, sampler='pallas', "
        f"batch {BATCH})")
    model, params = make_model(CaptioningTransformerBase, "float32", dev,
                               False)
    greedy_parity(model, params, features(64, dev, 1)[0], tree_map,
                  "CaptioningTransformerBase (K1)")
    model, params = make_lstm(CaptioningLSTM, "float32", dev)
    greedy_parity(model, params, torch.randn(
        64, L_EMB, device=dev, generator=torch.Generator(dev).manual_seed(1)),
        tree_map, "CaptioningLSTM")
    base_kernels = ("ancestry_attention_update", "fused_topk_gumbel_sample")
    model, params = make_model(CaptioningTransformerBase, "bfloat16", dev,
                               False)
    out = model.generate(params, images,
                         generator=torch.Generator(dev).manual_seed(3), **kw)
    check_output(out, 8, VOCAB, BEAM, MAX_LEN)
    log("  base generate(8 images 224x224): ok")
    enc = features(BATCH, dev, 4)[0]
    out, legs["base"] = drive(model, params, enc, _build, kw, name_limit,
                              "base", base_kernels)
    check_output(out, BATCH, VOCAB, BEAM, MAX_LEN)
    fused, legs["base_fused"] = drive(
        model, params, enc, _build, kw, name_limit, "base_fused",
        base_kernels + ("fused_survivor_update",), fused=True)
    # K3 draws once after the prefill and once per decode step
    steps = legs["base_fused"]["fused_topk_gumbel_sample"] - 1
    if legs["base_fused"]["fused_survivor_update"] != steps:
        raise AssertionError("base_fused: K10 not launched once per step")
    if not (torch.equal(fused["sequences"], out["sequences"])
            and torch.equal(fused["scores"], out["scores"])):
        raise AssertionError("base_fused: sequences or scores differ from "
                             "the base leg's at the same seed")
    log(f"  base_fused: K10 once in each of {steps} decode steps; sequences "
        f"and scores equal to the base leg's")
    profile_call(model, params, enc, kw, name_limit, "base", 12)
    profile_call(model, params, enc, kw, name_limit, "base_fused", 12,
                 fused=True)
    model, params = make_lstm(CaptioningLSTM, "bfloat16", dev)
    out = model.generate(params, images,
                         generator=torch.Generator(dev).manual_seed(3), **kw)
    check_output(out, 8, VOCAB, BEAM, MAX_LEN)
    lab_model, lab_params = make_lstm(CaptioningLSTMWithLabels, "bfloat16",
                                      dev)
    labels = torch.randint(4, VOCAB, (8, 5), device=dev,
                           generator=torch.Generator(dev).manual_seed(5))
    out = lab_model.generate(lab_params, images, labels,
                             generator=torch.Generator(dev).manual_seed(3),
                             **kw)
    check_output(out, 8, VOCAB, BEAM, MAX_LEN)
    log("  lstm generate(8 images) and lstm_labels generate(8 images, "
        "labels): ok")
    enc = torch.randn(BATCH, L_EMB, device=dev,
                      generator=torch.Generator(dev).manual_seed(4))
    out, legs["lstm"] = drive(model, params, enc, _build, kw, name_limit,
                              "lstm", ("fused_topk_gumbel_sample",))
    check_output(out, BATCH, VOCAB, BEAM, MAX_LEN)
    profile_call(model, params, enc, kw, name_limit, "lstm", 12)
    del model, params, lab_model, lab_params, out, fused, enc
    log(f"    elapsed {time.perf_counter() - t_start:.1f} s")

    log(f"[7] char kernels: K4 x [{C_ROWS}, {HID}] W [{C_VOCAB}, {HID}] "
        f"bf16, top_k {C_TOP_K}, draws {C_BEAM}")
    rows["fused_classifier_topk_gumbel_sample"] = check_k4(S, dev, gen)
    log(f"    K5/K6 rows {C_ROWS}, P {C_P}, D {HID}, bf16")
    (rows["ancestry_attention_update_canon"],
     rows["ancestry_attention_ids"]) = check_k5_k6(A, dev, gen)
    log(f"    K3 (the first draw) [{C_BATCH}, {C_VOCAB}] bf16, top_k "
        f"{C_TOP_K}, draws {C_BEAM}, 1/T 1/{C_TEMP}")
    char_k3 = check_k3(S, dev, gen, rows=C_BATCH, vocab=C_VOCAB,
                       top_k=C_TOP_K, draws=C_BEAM, inv_t=1 / C_TEMP,
                       label="K3 char")
    log("    K1/K2 at the char shapes, all items live and 500 live; K1 to "
        "p_eff 128 (canon off) in bf16 and f32, and at head_dim 24")
    for live in (None, 500):
        char_k1 = check_k1(A, dev, gen, items=C_BATCH, beam=C_BEAM, p=C_P,
                           pes=(40, 128), dt=torch.bfloat16, live_items=live,
                           label="K1 char")
        check_k1(A, dev, gen, items=C_BATCH, beam=C_BEAM, p=C_P, pes=(128,),
                 dt=torch.float32, live_items=live, label="K1 char",
                 timed=False)
        char_k2 = check_k2(A, dev, gen, items=C_BATCH, beam=C_BEAM,
                           live_items=live)
        for name, r in (("K1 (p_eff 128)", char_k1), ("K2", char_k2)):
            log(f"    {name} at the char shape, live items {live}: "
                f"{r['ms']:.4f} ms (twin {r['plain_ms']:.4f} ms, SDPA "
                f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms)")
        if live is None:
            rows["ancestry_attention_update"]["ms_char_pe128"] = char_k1["ms"]
            rows["grouped_cross_attention"].update(
                ms_char=char_k2["ms"], bound_ms_char=char_k2["bound_ms"])
    check_k2(A, dev, gen, items=C_BATCH, beam=C_BEAM, dt=torch.float32,
             timed=False)
    # head_dim 24: bf16 off the tensor cores, on the CUDA-core kernel
    check_k1(A, dev, gen, items=C_BATCH, beam=C_BEAM, p=C_P, pes=(128,),
             dt=torch.bfloat16, label="K1 char", d=24 * HEADS, timed=False)
    rows["fused_topk_gumbel_sample"]["ms_char"] = char_k3["ms"]
    log("    K9 and K10 at the char shapes, all items live and 500 live")
    for live in (None, 500):
        char_k9 = check_k9(A, dev, gen, items=C_BATCH, beam=C_BEAM,
                           ngs=(PACK,), live_items=live)
        char_k10 = check_k10(E, dev, gen, items=C_BATCH, beam=C_BEAM,
                             length=C_LEN, live_items=live)
        if live is None:
            rows["cross_attention_packed"].update(
                ms_char=char_k9["ms"], k2_ms_char=char_k9["k2_ms"],
                bound_ms_char=char_k9["bound_ms"])
        for name, r in (("K9 (ng 4)", char_k9), ("K10", char_k10)):
            log(f"    {name} at the char shape, live items {live}: "
                f"{r['ms']:.4f} ms (twin {r['plain_ms']:.4f} ms, SDPA "
                f"{r['library_ms']}, bound {r['bound_ms']:.4f} ms)")

    log(f"    K7 and K8 rows {C_ROWS}, P {C_P}; K11 rows {C_ROWS}, P {C_P}")
    char_k7 = check_k7(A, dev, gen, items=C_BATCH, beam=C_BEAM, p=C_P,
                       cases=(("native4d", 128), ("grouped", None)),
                       label="K7 char")
    char_k8 = check_k8(A, dev, gen, items=C_BATCH, beam=C_BEAM, p=C_P,
                       positions=(127,), label="K8 char")
    char_k11 = check_k11(C, dev, gen, rows=C_ROWS, p=C_P,
                         positions=(0, 64, 127), label="K11 char")
    for name, r in (("K7 (native4d, p_eff 128)", char_k7),
                    ("K8 (pos 127)", char_k8), ("K11 (pos 64)", char_k11)):
        log(f"    {name} at the char shape: {r['ms']:.4f} ms (twin "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms)")

    log("[8] char greedy generate_from_emb, f32, kernels (without and with "
        "both switches) vs plain CPU path")
    check_greedy(CaptioningTransformer, tree_map, _build, dev, char=True)

    log(f"[9] char main path: bf16, sampler='pallas', batch {C_BATCH}")
    model, params = make_model(CaptioningTransformer, "bfloat16", dev, True)
    kw = dict(max_len=C_LEN, beam_size=C_BEAM, top_k=C_TOP_K,
              temperature=C_TEMP, sampler="pallas")
    enc = features(C_BATCH, dev, 6)
    char_kernels = (
        "ancestry_attention_update", "grouped_cross_attention",
        "fused_topk_gumbel_sample", "fused_classifier_topk_gumbel_sample",
        "ancestry_attention_update_canon", "ancestry_attention_ids")
    out, legs["char"] = drive(model, params, enc, _build, kw, name_limit,
                              "char", char_kernels)
    check_output(out, C_BATCH, C_VOCAB, C_BEAM, C_LEN)
    log(f"  boundaries (p_eff, live items after compaction, stragglers): "
        f"{marks(out)}")
    check_k6_leg(A, dev, gen, marks(out), rows["ancestry_attention_ids"])
    profile_call(model, params, enc, kw, name_limit, "char", 25)
    out, legs["char_packed_fused"] = drive(
        model, params, enc, _build, kw, name_limit, "char_packed_fused",
        char_kernels + ("cross_attention_packed", "fused_survivor_update"),
        pack=PACK, fused=True)
    check_output(out, C_BATCH, C_VOCAB, C_BEAM, C_LEN)
    # K4 draws once per decode step
    check_leg_launches(
        "char_packed_fused", legs["char_packed_fused"], True,
        legs["char_packed_fused"]["fused_classifier_topk_gumbel_sample"])
    log(f"  boundaries (p_eff, live items after compaction, stragglers): "
        f"{marks(out)}")
    profile_call(model, params, enc, kw, name_limit, "char_packed_fused", 12,
                 pack=PACK, fused=True)
    for leg in ("char", "char_packed_fused"):
        if legs[leg]["fused_topk_gumbel_sample"] != 1:
            raise AssertionError(f"{leg}: K3 runs the first draw only")
    del model, params, out, enc
    log(f"    elapsed {time.perf_counter() - t_start:.1f} s")

    log(f"[10] serving: the word model (bf16, sampler='pallas') behind the "
        f"pipeline, the HTTP server and the dynamic batcher (max_batch "
        f"{S_MAX_BATCH}, buckets 'auto')")
    legs["serving"], serving = check_serving(
        CaptioningTransformer, tree_map, _build, (A, C, E, S), dev,
        name_limit)
    log("serving: " + json.dumps(serving))
    log("[11] kernel library build lock")
    check_cold_build()
    log(f"    elapsed {time.perf_counter() - t_start:.1f} s")
    log(f"[12] train: the word model (V {VOCAB}, hid {HID}, {LAYERS} layers, "
        f"bf16, batch {T_BATCH}) from a trunk cache of {T_TEMPLATES} "
        f"templates; then from images, f32 parity with the CPU, the trained "
        f"checkpoint served, and the other captioners")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as logdir:
        legs["train_serve"], train = check_train(
            CaptioningTransformer, tree_map, _build, (A, C, E, S), dev,
            name_limit, logdir)
    log("train: " + json.dumps(train))
    log(f"    train phase {time.perf_counter() - t0:.1f} s; elapsed "
        f"{time.perf_counter() - t_start:.1f} s")

    sources = {
        "ancestry_attention_update": (
            "ancestry_attention.cu", "pallas_attention.py:535"),
        "grouped_cross_attention": (
            "cross_attention.cu", "pallas_attention.py:1182"),
        "fused_topk_gumbel_sample": (
            "topk_gumbel.cu", "pallas_sampler.py:303"),
        "fused_classifier_topk_gumbel_sample": (
            "classifier_topk_gumbel.cu", "pallas_sampler.py:376"),
        "ancestry_attention_update_canon": (
            "ancestry_attention_canon.cu", "pallas_attention.py:845"),
        "ancestry_attention_ids": (
            "ancestry_attention_ids.cu", "pallas_attention.py:1015"),
        "cross_attention_packed": (
            "cross_attention.cu", "pallas_attention.py:1275"),
        "fused_survivor_update": (
            "survivor_update.cu", "pallas_engine.py:154"),
        "ancestry_attention": (
            "ancestry_attention_ids.cu", "pallas_attention.py:264"),
        "ancestry_attention_update_flash": (
            "ancestry_attention_flash.cu", "pallas_attention.py:1459"),
        "cache_column_write": (
            "cache_column_write.cu", "pallas_cache.py:64"),
    }
    kernels = []
    for name, (src, tpu) in sources.items():
        row = rows[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "deephumor_tpu_torch/ops/csrc/" + src,
            "replaces": "deephumor_tpu/ops/" + tpu,
            "launches": sum(leg[name] for leg in legs.values()),
            "launches_by_path": {k: leg[name] for k, leg in legs.items()},
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            # K5 at its second canon shape; K6 at the leg's straggler
            # counts; K1 at the char shape, p_eff 128; K2 and K9 at the
            # char shape, K9 beside K2 on the same rows; K3 at the char
            # shape, in f32, and torch.topk alone; K4 at C_LIVE live rows,
            # beside F.linear + K3 and F.linear alone (partial yardsticks)
            **{k: row[k] for k in (
                "ms_pe128", "ms_leg", "ms_char_pe128", "ms_char",
                "bound_ms_char", "k2_ms", "k2_ms_char", "ms_f32", "topk_ms",
                "ms_live", "bound_ms_live", "linear_ms", "linear_k3_ms",
                "linear_k3_ms_live") if k in row}})
    print(json.dumps({"kernels": kernels}))
    print(f"card: {name_limit}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
