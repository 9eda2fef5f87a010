"""Builds ``ops/csrc/*.cu`` with ``nvcc`` into one shared library and
loads it with ``ctypes``.

The library has a plain C interface: every pointer and the stream are
``c_void_p``, sizes are ``c_int``, and every entry point returns
``cudaGetLastError()`` so a refused launch raises in the wrapper instead
of vanishing. The build runs at the first kernel call (never at import)
and lands in ``build/deephumor_tpu_torch/`` at the repository root, named
by a hash of the sources and flags, so an unchanged tree reuses it.
``nvcc.log`` beside it keeps ptxas's register/spill report.

Each kernel also has a plain integer launch counter in ``LAUNCHES``: its
wrapper adds one exactly where it launches the kernel, so a run can show
that its main path went through the kernels.
"""

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

__all__ = ["LAUNCHES", "reset_launch_counts", "library", "check",
           "BUILD_DIR", "dtype_code", "on_kernel_device",
           "check_vector_rows", "stream_of"]

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = CSRC.parents[2] / "build" / "deephumor_tpu_torch"
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

LAUNCHES = {
    "ancestry_attention_update": 0,
    "grouped_cross_attention": 0,
    "fused_topk_gumbel_sample": 0,
}

_P, _I, _F, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint
_SIGNATURES = {
    # dtype, q, cache_k, cache_v, k_new, v_new, bias, out,
    # items, beam, P, p_eff, D, H, pos, inv_scale, stream
    "dh_ancestry_attention_update":
        [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P],
    # dtype, q, ek, ev, bias (or NULL), out, G, r, T, D, H, inv_scale,
    # stream
    "dh_grouped_cross_attention":
        [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    # dtype, logits, ids, rows, V, top_k, num_draws, unk, seed, invT, stream
    "dh_topk_gumbel_sample":
        [_I, _P, _P, _I, _I, _I, _I, _I, _U, _F, _P],
}

def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc():
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (on PATH or under /usr/local/cuda)")
    return path


@functools.lru_cache(maxsize=None)
def library():
    """Compiles (if needed) and loads the kernel library."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        digest.update(p.name.encode() + p.read_bytes())
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = BUILD_DIR / f"libdh_kernels_{digest.hexdigest()[:16]}.so"
    if not so.exists():
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *FLAGS, "-o", str(tmp), *map(str, sources)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        (BUILD_DIR / "nvcc.log").write_text(
            " ".join(cmd) + "\n" + res.stdout + res.stderr)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({res.returncode}):\n{res.stderr[-4000:]}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.dh_error_string.argtypes = [_I]
    lib.dh_error_string.restype = ctypes.c_char_p
    return lib


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


def stream_of(t):
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
