"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Builds the hand-written kernels of deephumor_tpu_torch from ops/csrc/ and
drives the port's two serving paths, each after its kernels have been
held against their plain PyTorch twins at that path's shapes:

* word: CaptioningTransformer V=29184, hid 512, 6 layers, 8 heads, pf 2048,
  beam 5, len 32, top_k 64, bf16, sampler="pallas", batch 1792 (K1, K2,
  K3);
* char: the same widths at V=128, beam 7, len 128, top_k 50, temperature
  1.1, EOS bias 1.0, batch 768 (K1, K2, K3 for the first draw, K4, K5, K6;
  early-EOS compaction and canonical-prefix attention on by default).

Weights are random from a seed. For each path it checks greedy f32
generation through the kernels against the plain path on the CPU, then
runs the path once with every launch count at zero and fails if one of
its kernels was not launched. It ends the char path with a torch.profiler
table of one more call (kernel time by name, the device's idle share).

    python3 chip_smoke.py

Exits non-zero, printing no result, without a CUDA device. Its last line
is ``{"ok": true, "device": {...}}``; the line before it gives the card's
name and power limit, and the one before that a JSON summary of the
kernels (times, launches per path, bounds, library yardsticks).
"""

import json
import subprocess
import sys
import time

import torch

# word serving config (the JAX package's bench.py headline leg)
VOCAB, HID, LAYERS, HEADS, PF = 29184, 512, 6, 8, 2048
BEAM, MAX_LEN, TOP_K, BATCH, EOS_BIAS = 5, 32, 64, 1792, 1.5
ROWS, P, T_ENC = BATCH * BEAM, 40, 49
# char serving config (bench.py:63-70,225-251)
C_VOCAB, C_BEAM, C_LEN, C_TOP_K, C_BATCH = 128, 7, 128, 50, 768
C_EOS_BIAS, C_TEMP = 1.0, 1.1
# the greedy char check takes the first of these EOS biases at which a
# quarter of its items have ended by the last compaction while a canon
# boundary still has stragglers
C_GREEDY_EOS_BIASES = (0.0, 0.25, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0)
C_ROWS, C_P = C_BATCH * C_BEAM, 136  # 129 positions, padded to 8
TOL = 2e-2  # bf16 kernel vs twin: one bf16 rounding of each output
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}


def log(*args):
    print(*args, flush=True)


def card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=10, warmup=2):
    """Mean CUDA-event time of one call, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
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


def k1_bytes(live, beam, pe, elt):
    """K/V prefix, q, k_new, v_new, out and the two written columns, plus
    the bias over the read positions."""
    lr = live * beam
    return (2 * lr * pe * HID + 6 * lr * HID) * elt + lr * beam * pe * 4


def check_k1(A, dev, gen, *, items, beam, p, pes, dt, live_items=None,
             label="K1"):
    """K1 vs twin for each p_eff; caches bit-equal. Returns the last
    p_eff's measurements."""
    rows = items * beam
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev).to(dt)  # noqa
    ck, cv = rnd(rows, p, HID), rnd(rows, p, HID)
    err = 0.0
    for pe in pes:
        pos = pe - 1
        q, kn, vn = rnd(rows, HID), rnd(rows, HID), rnd(rows, HID)
        anc = torch.randint(0, beam, (items, beam, p), generator=gen,
                            device=dev)
        valid = torch.rand(rows, p, generator=gen, device=dev) < 0.8
        valid[:, pos + 1:] = False
        valid[:, 0] = valid[:, pos] = True
        bias = A.ancestry_bias(anc, valid, p)
        caches = [(ck.clone(), cv.clone()) for _ in range(2)]
        kw = dict(beam=beam, n_heads=HEADS, p_eff=pe, live_items=live_items)
        got = A.ancestry_attention_update(q, *caches[0], kn, vn, bias, pos,
                                          **kw)
        want = A.ancestry_attention_update_plain(q, *caches[1], kn, vn,
                                                 bias, pos, **kw)
        torch.cuda.synchronize()
        if not (torch.equal(caches[0][0], caches[1][0])
                and torch.equal(caches[0][1], caches[1][1])):
            raise AssertionError(f"{label} p_eff={pe}: written caches differ")
        torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)
        e = (got.float() - want.float()).abs().max().item()
        err = max(err, e)
        log(f"  {label} p_eff={pe} live_items={live_items}: caches "
            f"bit-equal, max|out-twin|={e:.3e} (atol=rtol={TOL})")
    k, v = caches[0]
    ms = cuda_ms(lambda: A.ancestry_attention_update(
        q, k, v, kn, vn, bias, pos, **kw))
    plain_ms = cuda_ms(lambda: A.ancestry_attention_update_plain(
        q, k, v, kn, vn, bias, pos, **kw), iters=3)
    live = items if live_items is None else live_items
    qh = q.reshape(items, beam, HEADS, -1).transpose(1, 2)
    kh, vh = (heads(x[:, :pe].reshape(items, beam * pe, HID), items,
                    beam * pe) for x in (k, v))
    mask = bias.reshape(items, beam, beam, p)[..., :pe].reshape(
        items, 1, beam, beam * pe).contiguous()
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms(lambda: sdpa(qh, kh, vh, mask)),
                **bound(k1_bytes(live, beam, pe, k.element_size()),
                        4 * live * beam * beam * pe * HID, dt))


def check_k2(A, dev, gen, *, items, beam, live_items=None):
    dt = torch.bfloat16
    q = torch.randn(items * beam, HID, generator=gen, device=dev).to(dt)
    ek, ev = (torch.randn(items, T_ENC, HID, generator=gen,
                          device=dev).to(dt) for _ in range(2))
    mask = torch.rand(items, T_ENC, generator=gen, device=dev) < 0.1
    mask[0] = True  # one item with every encoder row masked
    bias = torch.where(mask[:, None, :], A.MASK_FILL, 0.0).float()
    kw = dict(n_heads=HEADS, live_items=live_items)
    got = A.grouped_cross_attention(q, ek, ev, bias, **kw)
    want = A.grouped_cross_attention_plain(q, ek, ev, bias, **kw)
    torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)
    if not torch.isfinite(got[:beam].float()).all():
        raise AssertionError("K2: all-masked group is not finite")
    err = (got.float() - want.float()).abs().max().item()
    log(f"  K2 G={items} (item 0 fully masked) live_items={live_items}: "
        f"max|out-twin|={err:.3e} (atol=rtol={TOL})")
    ms = cuda_ms(lambda: A.grouped_cross_attention(q, ek, ev, bias, **kw))
    plain_ms = cuda_ms(lambda: A.grouped_cross_attention_plain(
        q, ek, ev, bias, **kw), iters=3)
    qh = q.reshape(items, beam, HEADS, -1).transpose(1, 2)
    kh, vh = (heads(x, items, T_ENC) for x in (ek, ev))
    m4 = bias.reshape(items, 1, 1, T_ENC)
    live = items if live_items is None else live_items
    nbytes = (2 * live * T_ENC * HID + 2 * live * beam * HID) * 2 + (
        live * T_ENC * 4)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms(lambda: sdpa(qh, kh, vh, m4)),
                **bound(nbytes, 4 * live * beam * T_ENC * HID, dt))


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


def check_k3(S, dev, gen, *, rows, vocab, top_k, draws, inv_t, label):
    logits = torch.randn(rows, vocab, generator=gen, device=dev).to(
        torch.bfloat16)
    kw = dict(top_k=top_k, num_draws=draws)
    ids, vals = S.fused_topk_gumbel_sample(logits, 12345, inv_t, **kw)
    ids_p, vals_p = S.fused_topk_gumbel_sample_plain(logits, 12345, inv_t,
                                                     **kw)
    check_draws(ids, ids_p, logits, top_k, label)
    err = (vals - vals_p).abs().max().item()
    ms = cuda_ms(lambda: S.fused_topk_gumbel_sample(logits, 7, inv_t, **kw))
    plain_ms = cuda_ms(lambda: S.fused_topk_gumbel_sample_plain(
        logits, 7, inv_t, **kw), iters=2, warmup=1)
    # reads the logits once, writes the ids; its integer compares have no
    # peak rate in the table, so the bytes bound it
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
                **bound(rows * vocab * 2 + rows * draws * 4, 0,
                        torch.bfloat16))


def check_k4(S, dev, gen):
    """K4 at the char shapes: x [5376, 512], W [128, 512] bf16."""
    bf = torch.bfloat16
    x = torch.randn(C_ROWS, HID, generator=gen, device=dev).to(bf)
    w = (torch.randn(C_VOCAB, HID, generator=gen, device=dev) / 8).to(bf)
    b = torch.randn(C_VOCAB, generator=gen, device=dev)
    b[1] = 30.0  # UNK on top of every row: it must never be drawn
    kw = dict(top_k=C_TOP_K, num_draws=C_BEAM)
    err = 0.0
    for live in (None, 3000):
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
    ms = cuda_ms(lambda: S.fused_classifier_topk_gumbel_sample(
        x, w, b, 7, 1 / C_TEMP, **kw))
    plain_ms = cuda_ms(lambda: S.fused_classifier_topk_gumbel_sample_plain(
        x, w, b, 7, 1 / C_TEMP, **kw), iters=2, warmup=1)
    nbytes = C_ROWS * HID * 2 + C_VOCAB * HID * 2 + C_VOCAB * 4 + (
        C_ROWS * C_BEAM * 8)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
                **bound(nbytes, 2 * C_ROWS * C_VOCAB * HID, bf))


def check_k5_k6(A, dev, gen):
    """K5 (pe 120: c 104, w 16; pe 128: c 120, w 8) and K6 (pe 128) at the
    char shapes, and K5 + K6 merged == K1's full-width twin."""
    from deephumor_tpu_torch.ops.testing import canon_state

    dt, items, beam = torch.bfloat16, C_BATCH, C_BEAM
    n = 96  # stragglers: the first n items, then the rest in order
    strag_ids = torch.arange(items, device=dev, dtype=torch.int32)
    err5 = err6 = 0.0
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
        if pe == 120:
            k5_state = (s, caches[0], args, kw)
    s, (ck, cv), args, kw = k5_state
    ms5 = cuda_ms(lambda: A.ancestry_attention_update_canon(
        s["q"], ck, cv, *args, **kw))
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
    nbytes5 = (2 * items * c * HID + 2 * rows * w * HID + 6 * rows * HID) * 2 \
        + items * c * 4 + items * beam * beam * w * 4
    k5 = dict(max_abs_err=err5, ms=ms5, plain_ms=plain5,
              library_ms=library_ms(lambda: sdpa(qh, kh, vh, mask)),
              **bound(nbytes5, 4 * rows * (c + beam * w) * HID, dt))
    # K6 at pe 128 on the last state that ran it
    k6kw = dict(beam=beam, n_heads=HEADS, p_eff=128)
    s6 = canon_state(items=items, beam=beam, p=C_P, c=120, pe=128, d=HID,
                     dtype=dt, generator=gen, stragglers=range(n))
    ms6 = cuda_ms(lambda: A.ancestry_attention_ids(
        s6["q"], s6["ck"], s6["cv"], s6["bias"], strag_ids, n, **k6kw))
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


def check_greedy(CaptioningTransformer, tree_map, dev, char):
    """Greedy f32 generation through the kernels vs the plain path on the
    CPU at the serving widths (char: 32 items at several feature scales,
    compaction and canon on by the defaults, many items retired early, and
    the same boundaries on both)."""
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
    same = (got["chosen"].cpu() == want["chosen"]).all(dim=1).float().mean()
    log(f"  greedy f32, {n} items: kernel path == CPU plain path on "
        f"{same.item():.4f} of items (>= 0.99); boundaries (kernels) "
        f"{marks(got)}; (CPU) {marks(want)}")
    if same < 0.99:
        raise AssertionError("greedy kernel path disagrees with plain path")
    if char and got["boundaries"] != want["boundaries"]:
        raise AssertionError("greedy char: boundaries differ from the CPU "
                             "path's")


def check_output(out, n, vocab, beam, max_len):
    seq = out["sequences"]
    if out["chosen"].shape != (n, max_len) or seq.shape != (n, beam,
                                                           max_len):
        raise AssertionError(f"unexpected output shape {tuple(seq.shape)}")
    if not (((seq >= 0) & (seq < vocab)).all() and not (seq == 1).any()
            and torch.isfinite(out["scores"]).all()):
        raise AssertionError("tokens out of range, UNK drawn or bad scores")


def timed_call(model, params, enc, kw, seed):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = model.generate_from_emb(
        params, enc, generator=torch.Generator(enc[0].device).manual_seed(
            seed), **kw)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def drive(model, params, enc, _build, kw, name_limit, label, path_kernels):
    """One warm-up call, then one call with every launch count at zero;
    fails unless each kernel of ``path_kernels`` launched (and no other).
    Two more calls (not counted) show the run-to-run spread."""
    model.generate_from_emb(params, enc, **kw)
    _build.reset_launch_counts()
    out, secs = timed_call(model, params, enc, kw, 5)
    launches = dict(_build.LAUNCHES)
    n = enc[0].shape[0]
    steps = int((out["sequences"] != 0).any(dim=(0, 1)).sum())
    log(f"  {label} generate_from_emb: {n / secs:.1f} captions/s "
        f"({secs:.3f} s, {steps} positions, {name_limit}); launches "
        f"{launches}")
    again = [n / timed_call(model, params, enc, kw, s)[1] for s in (6, 7)]
    log(f"  {label} two more calls (seeds 6, 7): "
        f"{', '.join(f'{r:.1f}' for r in again)} captions/s")
    missing = [k for k in path_kernels if launches[k] < 1]
    extra = [k for k, v in launches.items() if v and k not in path_kernels]
    if missing or extra:
        raise AssertionError(f"{label}: kernels not launched {missing}, "
                             f"launched off the path {extra}")
    return out, launches


def profile_char(model, params, enc, kw, name_limit):
    """torch.profiler over one char call: kernel time by name (the 25
    largest) and the device's idle share."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.generate_from_emb(params, enc, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if getattr(e, "device_time_total", 0) > 0
              and e.device_type.name == "CUDA"]
    busy = sum(e.device_time_total for e in events) / 1e3
    events.sort(key=lambda e: -e.device_time_total)
    lines = [f"char profile ({name_limit}): wall {wall * 1e3:.1f} ms "
             f"(profiled), device kernel time {busy:.1f} ms, idle share "
             f"{1 - busy / (wall * 1e3):.3f}"]
    for e in events[:25]:
        lines.append(f"  {e.device_time_total / 1e3:10.3f} ms "
                     f"{e.count:6d} calls  {e.key[:90]}")
    for line in lines:
        log(line)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; nothing is run")
    from deephumor_tpu_torch.models import CaptioningTransformer
    from deephumor_tpu_torch.ops import _build
    from deephumor_tpu_torch.ops import attention as A
    from deephumor_tpu_torch.ops import sampler as S
    from deephumor_tpu_torch.utils.pytree import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    # the f32 ResNet runs on cuDNN in full f32, as the JAX encoder does
    torch.backends.cudnn.allow_tf32 = False
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
    log(f"    K2 G {BATCH}, r {BEAM}, T {T_ENC}")
    rows["grouped_cross_attention"] = check_k2(A, dev, gen, items=BATCH,
                                               beam=BEAM)
    log(f"    K3 [{ROWS}, {VOCAB}] bf16, top_k {TOP_K}, draws {BEAM}")
    rows["fused_topk_gumbel_sample"] = check_k3(
        S, dev, gen, rows=ROWS, vocab=VOCAB, top_k=TOP_K, draws=BEAM,
        inv_t=1.0, label="K3")

    log("[4] word greedy generate_from_emb, f32, kernels vs plain CPU path")
    check_greedy(CaptioningTransformer, tree_map, dev, char=False)

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
    out, word_launches = drive(
        model, params, features(BATCH, dev, 4), _build, kw, name_limit,
        "word", ("ancestry_attention_update", "grouped_cross_attention",
                 "fused_topk_gumbel_sample"))
    check_output(out, BATCH, VOCAB, BEAM, MAX_LEN)
    del model, params, out
    log(f"    elapsed {time.perf_counter() - t_start:.1f} s")

    log(f"[6] char kernels: K4 x [{C_ROWS}, {HID}] W [{C_VOCAB}, {HID}] "
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
    log("    K1/K2 at the char shapes, all items live and 500 live")
    for live in (None, 500):
        char_k1 = check_k1(A, dev, gen, items=C_BATCH, beam=C_BEAM, p=C_P,
                           pes=(40,), dt=torch.bfloat16, live_items=live,
                           label="K1 char")
        char_k2 = check_k2(A, dev, gen, items=C_BATCH, beam=C_BEAM,
                           live_items=live)
        for name, r in (("K1 (p_eff 40)", char_k1), ("K2", char_k2)):
            log(f"    {name} at the char shape, live items {live}: "
                f"{r['ms']:.4f} ms (twin {r['plain_ms']:.4f} ms, SDPA "
                f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms)")
    log(f"    K3 at the char shape: {char_k3['ms']:.4f} ms (twin "
        f"{char_k3['plain_ms']:.4f} ms, bound {char_k3['bound_ms']:.4f} ms)")

    log("[7] char greedy generate_from_emb, f32, kernels vs plain CPU path")
    check_greedy(CaptioningTransformer, tree_map, dev, char=True)

    log(f"[8] char main path: bf16, sampler='pallas', batch {C_BATCH}")
    model, params = make_model(CaptioningTransformer, "bfloat16", dev, True)
    kw = dict(max_len=C_LEN, beam_size=C_BEAM, top_k=C_TOP_K,
              temperature=C_TEMP, sampler="pallas")
    enc = features(C_BATCH, dev, 6)
    out, char_launches = drive(
        model, params, enc, _build, kw, name_limit, "char",
        ("ancestry_attention_update", "grouped_cross_attention",
         "fused_topk_gumbel_sample", "fused_classifier_topk_gumbel_sample",
         "ancestry_attention_update_canon", "ancestry_attention_ids"))
    check_output(out, C_BATCH, C_VOCAB, C_BEAM, C_LEN)
    if char_launches["fused_topk_gumbel_sample"] != 1:
        raise AssertionError("char: K3 runs the first draw only")
    log(f"  boundaries (p_eff, live items after compaction, stragglers): "
        f"{marks(out)}")
    profile_char(model, params, enc, kw, name_limit)
    log(f"    elapsed {time.perf_counter() - t_start:.1f} s")

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
    }
    kernels = []
    for name, (src, tpu) in sources.items():
        row = rows[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "deephumor_tpu_torch/ops/csrc/" + src,
            "replaces": "deephumor_tpu/ops/" + tpu,
            "launches": word_launches[name] + char_launches[name],
            "launches_by_path": {"word": word_launches[name],
                                 "char": char_launches[name]},
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(f"card: {name_limit}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
