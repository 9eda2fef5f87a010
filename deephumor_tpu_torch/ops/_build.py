"""Builds ``ops/csrc/*.cu`` with ``nvcc`` into one shared library and
loads it with ``ctypes``.

Each source compiles to an object in its own ``nvcc`` process, all started
together, and one more ``nvcc`` links the objects into the library.

The library has a plain C interface: every pointer and the stream are
``c_void_p``, sizes are ``c_int``, and every entry point returns
``cudaGetLastError()`` so a refused launch raises in the wrapper instead
of vanishing. The build runs at the first kernel call (never at import)
and lands in ``build/deephumor_tpu_torch/`` at the repository root, named
by a hash of the sources and flags, so an unchanged tree reuses it.
``nvcc.log`` beside it keeps ptxas's register/spill report.

Each kernel also has a plain integer launch counter in ``LAUNCHES``: its
wrapper adds one exactly where it launches the kernel (``note_launch``),
so a run can show that its main path went through the kernels. A launch
made while a CUDA graph is captured runs only when the graph replays: it
is tallied with the graph, and each replay adds the tally.
"""

import contextlib
import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

__all__ = ["LAUNCHES", "reset_launch_counts", "note_launch",
           "capture_tally", "add_launches", "library", "check",
           "BUILD_DIR", "dtype_code", "on_kernel_device",
           "check_vector_rows", "check_mma_tiles", "check_smem",
           "smem_need", "count_args", "count_mask", "stream_of"]

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = CSRC.parents[2] / "build" / "deephumor_tpu_torch"
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

LAUNCHES = {
    "ancestry_attention_update": 0,
    "grouped_cross_attention": 0,
    "fused_topk_gumbel_sample": 0,
    "fused_classifier_topk_gumbel_sample": 0,
    "ancestry_attention_update_canon": 0,
    "ancestry_attention_ids": 0,
    "cross_attention_packed": 0,
    "fused_survivor_update": 0,
    "ancestry_attention": 0,
    "ancestry_attention_update_flash": 0,
    "cache_column_write": 0,
    "mla_attention": 0,
    "moe_gather": 0,
    "moe_swiglu": 0,
    "moe_combine": 0,
}

_P, _I, _F, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint
# A count (live items or rows, straggler items) is an int and a pointer
# beside it: NULL, or a device int32 that the kernel reads (count_args).
_SIGNATURES = {
    # dtype, q, ldq, cache_k, cache_v, k_new, ldk, v_new, ldv, bias, out,
    # rows tally (or NULL), items, live, live_ptr, beam, P, p_eff, D, H,
    # pos, inv_scale, stream
    "dh_ancestry_attention_update":
        [_I, _P, _I, _P, _P, _P, _I, _P, _I, _P, _P, _P, _I, _I, _P,
         *[_I] * 6, _F, _P],
    # dtype, q, ek, ev, bias (or NULL), out, G, live, live_ptr, r, T, D, H,
    # inv_scale, stream
    "dh_grouped_cross_attention":
        [_I, *[_P] * 5, _I, _I, _P, *[_I] * 4, _F, _P],
    # dtype, logits, ids, rows, live_rows, live_ptr, V, top_k, num_draws,
    # unk, seed, seed_ptr (or NULL), invT, invT_ptr (or NULL), stream
    "dh_topk_gumbel_sample":
        [_I, _P, _P, _I, _I, _P, *[_I] * 4, _U, _P, _F, _P, _P],
    # x, w, b, ids, vals, scratch (or NULL), rows, live_rows, live_ptr, V,
    # D, top_k, num_draws, unk, seed, seed_ptr (or NULL), invT, invT_ptr
    # (or NULL), stream
    "dh_classifier_topk_gumbel_sample":
        [*[_P] * 6, _I, _I, _P, *[_I] * 5, _U, _P, _F, _P, _P],
    # dtype, q, ldq, cache_k, cache_v, shared_k, shared_v, k_new, ldk,
    # v_new, ldv, bias_shared, bias_win, out, items, live, live_ptr, beam,
    # P, shared_len, c, p_eff, D, H, pos, inv_scale, stream
    "dh_ancestry_attention_update_canon":
        [_I, _P, _I, *[_P] * 5, _I, _P, _I, *[_P] * 3, _I, _I, _P,
         *[_I] * 8, _F, _P],
    # dtype, q, ldq, cache_k, cache_v, bias, item_ids, out, rows tally (or
    # NULL), items, list length, n_sel, n_sel_ptr, min_sel, beam, P, p_eff,
    # D, H, inv_scale, stream
    "dh_ancestry_attention_ids":
        [_I, _P, _I, *[_P] * 6, _I, _I, _I, _P, *[_I] * 6, _F, _P],
    # dtype, q, ek, ev, bias (or NULL), out, G, live, live_ptr, r, Tp,
    # t_real, D, H, inv_scale, stream
    "dh_cross_attention_packed":
        [_I, *[_P] * 5, _I, _I, _P, *[_I] * 5, _F, _P],
    # new_idx, new_val, surv, ended, val, seq, anc, valid, chosen, B, live,
    # live_ptr, beam, L, P, pos, eos, pad, stream
    "dh_fused_survivor_update":
        [*[_P] * 9, _I, _I, _P, *[_I] * 6, _P],
    # dtype, q, cache_k, cache_v, bias, out, rows tally (or NULL), items,
    # beam, P, p_eff, D, H, inv_scale, stream
    "dh_ancestry_attention":
        [_I, *[_P] * 6, *[_I] * 6, _F, _P],
    # dtype, q, cache_k, cache_v, k_new, v_new, bias, out, items, beam, P,
    # D, H, pos, inv_scale, stream
    "dh_ancestry_attention_update_flash":
        [_I, *[_P] * 7, *[_I] * 6, _F, _P],
    # cache dtype, new dtype, cache_k, cache_v, k_new, v_new, rows, P, D,
    # pos, stream
    "dh_cache_column_write":
        [_I, _I, *[_P] * 4, *[_I] * 4, _P],
    # q_lat, q_pe, prefix, gen, bias, out, rows tally (or NULL), items,
    # beam, H, T0, S, pe, scale, stream
    "dh_mla_attention":
        [*[_P] * 7, *[_I] * 6, _F, _P],
    # src, order, dst, count, pairs, k, D, stream
    "dh_moe_gather": [*[_P] * 4, *[_I] * 3, _P],
    # gu, a, count, pairs, I, stream
    "dh_moe_swiglu": [*[_P] * 3, _I, _I, _P],
    # base, y, inv, w, held, out, tokens, k, D, stream
    "dh_moe_combine": [*[_P] * 6, *[_I] * 3, _P],
}
# entry points that return a size, not an error
_SIZES = {
    # dtype, items, beam, p_eff, D, H -> bytes of dynamic shared memory
    "dh_ancestry_attention_update_smem": ([_I] * 6, ctypes.c_longlong),
    # dtype, beam, D, H -> bytes of dynamic shared memory
    "dh_ancestry_attention_update_flash_smem": ([_I] * 4, ctypes.c_longlong),
    # dtype, r, T (K9: t_real), D, H -> bytes of dynamic shared memory
    "dh_grouped_cross_attention_smem": ([_I] * 5, ctypes.c_longlong),
    # dtype, V -> bytes of dynamic shared memory of a block of one team
    "dh_topk_gumbel_sample_smem": ([_I] * 2, ctypes.c_longlong),
    # V, D, live rows -> bytes of K4's logits scratch on the current device
    "dh_classifier_topk_gumbel_sample_scratch": ([_I] * 3, ctypes.c_longlong),
    # beam, H, T0, pe -> bytes of dynamic shared memory
    "dh_mla_attention_smem": ([_I] * 4, ctypes.c_longlong),
    # device -> the opt-in limit of a block's dynamic shared memory
    "dh_smem_optin": ([_I], ctypes.c_int),
}

def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# the launch tally of the graph this thread is capturing (None: not
# capturing); see note_launch
_CAPTURE = threading.local()


def note_launch(name):
    """Counts one launch of kernel ``name``. While this thread captures a
    CUDA graph (``capture_tally``) nothing runs yet: the launch goes into
    that graph's tally, which ``add_launches`` adds to ``LAUNCHES`` at
    each replay."""
    tally = getattr(_CAPTURE, "tally", None)
    if tally is None:
        LAUNCHES[name] += 1
    else:
        tally[name] = tally.get(name, 0) + 1


@contextlib.contextmanager
def capture_tally():
    """Collects the launches that this thread notes inside the block into
    the dict it yields, instead of ``LAUNCHES``."""
    tally, saved = {}, getattr(_CAPTURE, "tally", None)
    _CAPTURE.tally = tally
    try:
        yield tally
    finally:
        _CAPTURE.tally = saved


def add_launches(tally):
    """Adds a captured graph's tally to ``LAUNCHES`` (once per replay)."""
    for name, n in tally.items():
        LAUNCHES[name] += n


def _nvcc():
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (on PATH or under /usr/local/cuda)")
    return path


# serialises the first build and load: threads of one process that make
# their first kernel call together (a server's batchers) would otherwise
# all run nvcc into the same object files
_LIBRARY_LOCK = threading.Lock()


@functools.lru_cache(maxsize=None)
def library():
    """Compiles (if needed) and loads the kernel library. The first
    caller builds it; threads that call at the same time wait for that
    build and share its library."""
    with _LIBRARY_LOCK:
        return _build_and_load()


@functools.lru_cache(maxsize=None)
def _build_and_load():
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        digest.update(p.name.encode() + p.read_bytes())
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = BUILD_DIR / f"libdh_kernels_{digest.hexdigest()[:16]}.so"
    if not so.exists():
        tag = f"{digest.hexdigest()[:16]}.{os.getpid()}"
        objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources]
        cmds = [[_nvcc(), *FLAGS, "-c", "-o", str(obj), str(src)]
                for src, obj in zip(sources, objs)]
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        log = []
        try:
            _run_all(cmds, log)
            _run_all([[_nvcc(), *FLAGS[:2], "-shared", "-o", str(tmp),
                       *map(str, objs)]], log)
        finally:
            (BUILD_DIR / "nvcc.log").write_text("".join(log))
            for obj in objs:
                obj.unlink(missing_ok=True)
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    for name, (argtypes, restype) in _SIZES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    lib.dh_error_string.argtypes = [_I]
    lib.dh_error_string.restype = ctypes.c_char_p
    return lib


def _run_all(cmds, log):
    """Runs the commands in parallel; raises if any of them failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    failed = []
    for cmd, proc in zip(cmds, procs):
        out = proc.communicate()[0]
        log.append(" ".join(cmd) + "\n" + out)
        if proc.returncode != 0:
            failed.append(f"{cmd[-1]} ({proc.returncode}):\n{out[-4000:]}")
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))


def check(err, name):
    """Raises if a C entry point reported a CUDA error."""
    if err != 0:
        msg = library().dh_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg}) at launch")


def dtype_code(t, name):
    """The C side's dtype code (0 = float32, 1 = bfloat16)."""
    import torch

    codes = {torch.float32: 0, torch.bfloat16: 1}
    if t.dtype not in codes:
        raise ValueError(f"{name}: dtype {t.dtype} not supported "
                         f"(float32 or bfloat16)")
    return codes[t.dtype]


def on_kernel_device(name, *tensors, rows=()):
    """True for CUDA tensors (launch the kernel), False for CPU tensors
    (use the plain twin); raises on mixed or other devices, and on the card
    on a non-contiguous tensor of ``tensors``. ``rows`` are 2-D operands
    that the kernel reads at their row stride (their wrapper checks it)."""
    devices = {t.device for t in tensors + tuple(rows)}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on several devices {devices}")
    (dev,) = devices
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    return True


def check_vector_rows(name, head_dim, *tensors):
    """The attention kernels copy head_dim-wide rows as 16-byte vectors."""
    if head_dim * tensors[0].element_size() % 16:
        raise ValueError(f"{name}: head_dim {head_dim} x "
                         f"{tensors[0].element_size()} bytes is not a "
                         f"multiple of 16")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: inputs must be 16-byte aligned")


def check_mma_tiles(name, head_dim, t):
    """The bf16 kernels of K5, K6 and K7 multiply in 16 x 8 x 16 tensor-core
    tiles: head_dim a multiple of 16 up to 256 (any beam: a block takes up
    to 32 branches). Their f32 kernels take what ``check_vector_rows``
    does."""
    import torch

    if t.dtype == torch.bfloat16 and (head_dim % 16 or head_dim > 256):
        raise ValueError(f"{name}: head_dim {head_dim} in bfloat16 is not a "
                         f"multiple of 16 up to 256")


@functools.lru_cache(maxsize=None)
def smem_need(entry, *shape):
    """The dynamic shared memory (bytes) that a block of the kernel behind
    the C entry point ``entry`` needs at ``shape``, as that entry point's
    launcher computes it."""
    return getattr(library(), entry)(*shape)


@functools.lru_cache(maxsize=None)
def _smem_optin(device_index):
    return library().dh_smem_optin(device_index)


def check_smem(name, need, t):
    """Raises ValueError, before any launch, when a block needs more
    dynamic shared memory than the card of ``t`` lets one block take."""
    limit = _smem_optin(t.device.index)
    if need > limit:
        raise ValueError(f"{name}: a block needs {need} bytes of shared "
                         f"memory at this shape, above the card's limit of "
                         f"{limit} bytes a block")


def count_args(name, n, count, device):
    """The (int, device pointer or None) pair that a C entry point takes
    for a count of ``n`` leading items or rows: ``count`` None (all of
    them), an int (clamped to [0, n]), or a 0-d int32 tensor on
    ``device`` that the kernel reads at launch, so that a captured step
    reads each call's own count. A tensor's value is not read here (that
    would wait for the device); the int beside its pointer is ``n``, the
    rows the kernel's grid covers."""
    import torch

    if not isinstance(count, torch.Tensor):
        return n if count is None else min(max(int(count), 0), n), None
    if count.dtype != torch.int32 or count.ndim or count.device != device:
        raise ValueError(f"{name}: a count tensor must be a 0-d int32 on "
                         f"{device}, got {count.dtype} {tuple(count.shape)} "
                         f"on {count.device}")
    return n, count.data_ptr()


def count_mask(n, count, device, per=1):
    """Bool ``[n * per]``: True on the ``per`` rows of each of the first
    ``count`` of ``n`` items (``count`` None, an int or a 0-d integer
    tensor, compared where it lies: no host read). The plain twins
    compute every row and keep those it marks."""
    import torch

    idx = torch.arange(n, device=device)
    mask = idx >= 0 if count is None else idx < count
    return mask[:, None].expand(n, per).reshape(-1)


def stream_of(t):
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
