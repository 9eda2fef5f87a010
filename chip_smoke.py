"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Builds the hand-written kernels of deephumor_tpu_torch from ops/csrc/,
checks each against its plain PyTorch twin at the flagship serving shapes,
checks greedy generation through the kernels against the plain path on
the CPU, then drives the serving path (word-level CaptioningTransformer,
V=29184, hid 512, 6 layers, 8 heads, pf 2048, beam 5, len 32, top_k 64,
bf16, sampler="pallas", batch 1792, random weights from a seed) and shows
that it launched every kernel.

    python3 chip_smoke.py

Exits non-zero, printing no result, without a CUDA device. Its last line
is ``{"ok": true, "device": {...}}``; the line before it gives the card's
name and power limit, and the one before that a JSON summary of the
kernels.
"""

import json
import subprocess
import sys
import time

import torch

# flagship serving config (the JAX package's bench.py headline leg)
VOCAB, HID, LAYERS, HEADS, PF = 29184, 512, 6, 8, 2048
BEAM, MAX_LEN, TOP_K, BATCH, EOS_BIAS = 5, 32, 64, 1792, 1.5
ROWS, P, T_ENC = BATCH * BEAM, 40, 49
TOL = 2e-2  # bf16 kernel vs twin: one bf16 rounding of each output


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


def check_k1(A, dev, gen):
    """K1 vs twin at the serving shape for each p_eff of the ladder."""
    dt = torch.bfloat16
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev).to(dt)  # noqa
    ck, cv = rnd(ROWS, P, HID), rnd(ROWS, P, HID)
    err = 0.0
    for pe in (16, 24, 32):
        pos = pe - 1
        q, kn, vn = rnd(ROWS, HID), rnd(ROWS, HID), rnd(ROWS, HID)
        anc = torch.randint(0, BEAM, (BATCH, BEAM, P), generator=gen,
                            device=dev)
        valid = torch.rand(ROWS, P, generator=gen, device=dev) < 0.8
        valid[:, pos + 1:] = False
        valid[:, 0] = valid[:, pos] = True
        bias = A.ancestry_bias(anc, valid, P)
        caches = [(ck.clone(), cv.clone()) for _ in range(2)]
        kw = dict(beam=BEAM, n_heads=HEADS, p_eff=pe)
        got = A.ancestry_attention_update(q, *caches[0], kn, vn, bias, pos,
                                          **kw)
        want = A.ancestry_attention_update_plain(q, *caches[1], kn, vn,
                                                 bias, pos, **kw)
        torch.cuda.synchronize()
        if not (torch.equal(caches[0][0], caches[1][0])
                and torch.equal(caches[0][1], caches[1][1])):
            raise AssertionError(f"K1 p_eff={pe}: written caches differ")
        torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)
        e = (got.float() - want.float()).abs().max().item()
        err = max(err, e)
        log(f"  K1 p_eff={pe}: caches bit-equal, max|out-twin|={e:.3e} "
            f"(atol=rtol={TOL})")
    k, v = caches[0]
    ms = cuda_ms(lambda: A.ancestry_attention_update(
        q, k, v, kn, vn, bias, pos, **kw))
    plain_ms = cuda_ms(lambda: A.ancestry_attention_update_plain(
        q, k, v, kn, vn, bias, pos, **kw), iters=3)
    return err, ms, plain_ms


def check_k2(A, dev, gen):
    dt = torch.bfloat16
    q = torch.randn(ROWS, HID, generator=gen, device=dev).to(dt)
    ek, ev = (torch.randn(BATCH, T_ENC, HID, generator=gen,
                          device=dev).to(dt) for _ in range(2))
    mask = torch.rand(BATCH, T_ENC, generator=gen, device=dev) < 0.1
    mask[0] = True  # one item with every encoder row masked
    bias = torch.where(mask[:, None, :], A.MASK_FILL, 0.0).float()
    got = A.grouped_cross_attention(q, ek, ev, bias, n_heads=HEADS)
    want = A.grouped_cross_attention_plain(q, ek, ev, bias, n_heads=HEADS)
    torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)
    if not torch.isfinite(got[:BEAM].float()).all():
        raise AssertionError("K2: all-masked group is not finite")
    err = (got.float() - want.float()).abs().max().item()
    log(f"  K2 (item 0 fully masked): max|out-twin|={err:.3e} "
        f"(atol=rtol={TOL})")
    ms = cuda_ms(lambda: A.grouped_cross_attention(q, ek, ev, bias,
                                                   n_heads=HEADS))
    plain_ms = cuda_ms(lambda: A.grouped_cross_attention_plain(
        q, ek, ev, bias, n_heads=HEADS), iters=3)
    return err, ms, plain_ms


def check_k3(S, dev, gen):
    logits = torch.randn(ROWS, VOCAB, generator=gen, device=dev).to(
        torch.bfloat16)
    kw = dict(top_k=TOP_K, num_draws=BEAM)
    ids, vals = S.fused_topk_gumbel_sample(logits, 12345, 1.0, **kw)
    ids_p, vals_p = S.fused_topk_gumbel_sample_plain(logits, 12345, 1.0,
                                                     **kw)
    x = logits.float()
    kth = x.topk(TOP_K, dim=1).values[:, -1:]
    in_support = (x.gather(1, ids) >= kth).all().item()
    no_unk = not (ids == 1).any().item()
    srt = ids.sort(dim=1).values
    distinct = (srt[:, 1:] != srt[:, :-1]).all().item()
    same = (ids == ids_p).all(dim=1).float().mean().item()
    log(f"  K3: in exact top-{TOP_K} support={in_support}, no UNK={no_unk}, "
        f"no repeats={distinct}, rows equal to twin={same:.6f} (>= 0.999)")
    if not (in_support and no_unk and distinct and same >= 0.999):
        raise AssertionError("K3 disagrees with its twin or the support")
    err = (vals - vals_p).abs().max().item()
    ms = cuda_ms(lambda: S.fused_topk_gumbel_sample(logits, 7, 1.0, **kw))
    plain_ms = cuda_ms(lambda: S.fused_topk_gumbel_sample_plain(
        logits, 7, 1.0, **kw), iters=2, warmup=1)
    return err, ms, plain_ms


def word_model(CaptioningTransformer, dtype, dev):
    model = CaptioningTransformer(
        num_tokens=VOCAB, hid_dim=HID, n_layers=LAYERS, n_heads=HEADS,
        pf_dim=PF, max_len=MAX_LEN + 2, compute_dtype=dtype)
    params = model.init(torch.Generator(dev).manual_seed(0), dev)
    params["decoder"]["classifier"]["bias"][3] = EOS_BIAS
    return model, params


def features(n, dev, seed):
    g = torch.Generator(dev).manual_seed(seed)
    return (torch.randn(n, HID, generator=g, device=dev),
            torch.randn(n, T_ENC, HID, generator=g, device=dev))


def check_greedy(CaptioningTransformer, tree_map, dev):
    """Greedy f32 generation through the kernels vs the plain path on the
    CPU, 64 items at the serving widths."""
    model, params = word_model(CaptioningTransformer, "float32", dev)
    enc = features(64, dev, 1)
    kw = dict(max_len=MAX_LEN, beam_size=BEAM, top_k=TOP_K, greedy=True)
    got = model.generate_from_emb(params, enc, **kw)["chosen"].cpu()
    cpu = lambda t: t.cpu()  # noqa: E731
    want = model.generate_from_emb(tree_map(cpu, params),
                                   tuple(map(cpu, enc)), **kw)["chosen"]
    same = (got == want).all(dim=1).float().mean().item()
    log(f"  greedy f32, 64 items: kernel path == CPU plain path on "
        f"{same:.4f} of items (>= 0.99)")
    if same < 0.99:
        raise AssertionError("greedy kernel path disagrees with plain path")


def check_output(out, n):
    seq = out["sequences"]
    if out["chosen"].shape != (n, MAX_LEN) or seq.shape != (n, BEAM,
                                                           MAX_LEN):
        raise AssertionError(f"unexpected output shape {tuple(seq.shape)}")
    if not (((seq >= 0) & (seq < VOCAB)).all() and not (seq == 1).any()
            and torch.isfinite(out["scores"]).all()):
        raise AssertionError("tokens out of range, UNK drawn or bad scores")


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
    log(f"[3] K1 ancestry_attention_update, rows {ROWS}, P {P}, D {HID}, "
        f"bf16")
    k1 = check_k1(A, dev, gen)
    log(f"[4] K2 grouped_cross_attention, G {BATCH}, r {BEAM}, T {T_ENC}")
    k2 = check_k2(A, dev, gen)
    log(f"[5] K3 fused_topk_gumbel_sample, [{ROWS}, {VOCAB}] bf16, "
        f"top_k {TOP_K}, draws {BEAM}")
    k3 = check_k3(S, dev, gen)
    for name, (_, ms, plain_ms) in zip(("K1 (p_eff 32)", "K2", "K3"),
                                       (k1, k2, k3)):
        log(f"    {name}: kernel {ms:.4f} ms, plain twin {plain_ms:.4f} ms "
            f"({name_limit})")

    log("[6] greedy generate_from_emb, f32, kernels vs plain CPU path")
    check_greedy(CaptioningTransformer, tree_map, dev)

    log(f"[7] main path: bf16, sampler='pallas', batch {BATCH}")
    model, params = word_model(CaptioningTransformer, "bfloat16", dev)
    kw = dict(max_len=MAX_LEN, beam_size=BEAM, top_k=TOP_K,
              temperature=1.0, sampler="pallas")
    images = torch.randn(8, 224, 224, 3, device=dev,
                         generator=torch.Generator(dev).manual_seed(2))
    out = model.generate(params, images,
                         generator=torch.Generator(dev).manual_seed(3), **kw)
    check_output(out, 8)
    log("  generate(8 images 224x224): ok")
    enc = features(BATCH, dev, 4)
    model.generate_from_emb(params, enc, **kw)  # warm-up
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    out = model.generate_from_emb(
        params, enc, generator=torch.Generator(dev).manual_seed(5), **kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    check_output(out, BATCH)
    steps = int((out["sequences"] != 0).any(dim=(0, 1)).sum())
    log(f"  generate_from_emb: {BATCH / secs:.1f} captions/s ({secs:.3f} s, "
        f"{steps} positions, {name_limit}); launches {launches}")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel was not launched: {launches}")

    rows = []
    for (name, src, tpu), (err, ms, plain_ms) in zip(
            (("ancestry_attention_update", "ancestry_attention.cu",
              "deephumor_tpu/ops/pallas_attention.py:535"),
             ("grouped_cross_attention", "cross_attention.cu",
              "deephumor_tpu/ops/pallas_attention.py:1182"),
             ("fused_topk_gumbel_sample", "topk_gumbel.cu",
              "deephumor_tpu/ops/pallas_sampler.py:303")), (k1, k2, k3)):
        rows.append({"name": name, "route": "cuda",
                     "source": "deephumor_tpu_torch/ops/csrc/" + src,
                     "replaces": tpu, "launches": launches[name],
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
    print(json.dumps({"kernels": rows}))
    print(f"card: {name_limit}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
