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
           "smem_need", "live_count", "stream_of"]

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
}

_P, _I, _F, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint
_SIGNATURES = {
    # dtype, q, cache_k, cache_v, k_new, v_new, bias, out,
    # items, live, beam, P, p_eff, D, H, pos, inv_scale, stream
    "dh_ancestry_attention_update":
        [_I, *[_P] * 7, *[_I] * 8, _F, _P],
    # dtype, q, ek, ev, bias (or NULL), out, G, live, r, T, D, H,
    # inv_scale, stream
    "dh_grouped_cross_attention":
        [_I, *[_P] * 5, *[_I] * 6, _F, _P],
    # dtype, logits, ids, live_rows, V, top_k, num_draws, unk, seed,
    # seed_ptr (or NULL), invT, stream
    "dh_topk_gumbel_sample":
        [_I, _P, _P, _I, _I, _I, _I, _I, _U, _P, _F, _P],
    # x, w, b, ids, vals, scratch (or NULL), rows, live_rows, V, D, top_k,
    # num_draws, unk, seed, seed_ptr (or NULL), invT, stream
    "dh_classifier_topk_gumbel_sample":
        [*[_P] * 6, *[_I] * 7, _U, _P, _F, _P],
    # dtype, q, cache_k, cache_v, shared_k, shared_v, k_new, v_new,
    # bias_shared, bias_win, out, items, live, beam, P, shared_len, c,
    # p_eff, D, H, pos, inv_scale, stream
    "dh_ancestry_attention_update_canon":
        [_I, *[_P] * 10, *[_I] * 10, _F, _P],
    # dtype, q, cache_k, cache_v, bias, item_ids, out, items, n_sel, beam,
    # P, p_eff, D, H, inv_scale, stream
    "dh_ancestry_attention_ids":
        [_I, *[_P] * 6, *[_I] * 7, _F, _P],
    # dtype, q, ek, ev, bias (or NULL), out, G, live, r, Tp, t_real, D, H,
    # inv_scale, stream
    "dh_cross_attention_packed":
        [_I, *[_P] * 5, *[_I] * 7, _F, _P],
    # new_idx, new_val, surv, ended, val, seq, anc, valid, chosen, B, live,
    # beam, L, P, pos, eos, pad, stream
    "dh_fused_survivor_update":
        [*[_P] * 9, *[_I] * 8, _P],
    # dtype, q, cache_k, cache_v, bias, out, items, beam, P, p_eff, D, H,
    # inv_scale, stream
    "dh_ancestry_attention":
        [_I, *[_P] * 5, *[_I] * 6, _F, _P],
    # dtype, q, cache_k, cache_v, k_new, v_new, bias, out, items, beam, P,
    # D, H, pos, inv_scale, stream
    "dh_ancestry_attention_update_flash":
        [_I, *[_P] * 7, *[_I] * 6, _F, _P],
    # cache dtype, new dtype, cache_k, cache_v, k_new, v_new, rows, P, D,
    # pos, stream
    "dh_cache_column_write":
        [_I, _I, *[_P] * 4, *[_I] * 4, _P],
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


def on_kernel_device(name, *tensors):
    """True for CUDA tensors (launch the kernel), False for CPU tensors
    (use the plain twin); raises on mixed or other devices."""
    devices = {t.device for t in tensors}
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


def live_count(n, live):
    """How many of ``n`` leading items (or rows) a kernel computes: all of
    them when ``live`` is None, else ``live`` clamped to [0, n]."""
    return n if live is None else min(max(int(live), 0), n)


def stream_of(t):
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
