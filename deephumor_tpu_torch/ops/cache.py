"""In-place KV-cache column write: the K11 kernel wrapper and its twin.

Counterpart of deephumor_tpu/ops/pallas_cache.py. The wrapper launches
the CUDA kernel (ops/csrc/cache_column_write.cu) for CUDA tensors and runs
its plain PyTorch twin for CPU tensors; anything else raises.
"""

from deephumor_tpu_torch.ops import _build

__all__ = ["cache_column_write", "cache_column_write_plain"]


def cache_column_write_plain(cache_k, cache_v, k_new, v_new, pos,
                             block_rows=320):
    """Plain PyTorch twin of :func:`cache_column_write`."""
    cache_k[:, pos] = k_new.to(cache_k.dtype)
    cache_v[:, pos] = v_new.to(cache_v.dtype)
    return cache_k, cache_v


def cache_column_write(cache_k, cache_v, k_new, v_new, pos, block_rows=320):
    """K11: writes ``k_new``/``v_new`` at position ``pos`` of the caches,
    IN PLACE, cast to the cache dtype.

    Any row count is taken: ``block_rows`` is the TPU kernel's block size,
    accepted for the signature and without effect (the JAX package's block
    search fails with ``ZeroDivisionError`` when ``rows`` has no
    multiple-of-8 divisor at or below it).

    Args:
        cache_k, cache_v: ``[rows, P, D]``, one dtype (float32 or
            bfloat16).
        k_new, v_new: ``[rows, D]``, one dtype (float32 or bfloat16).
        pos: int, ``0 <= pos < P``.

    Returns:
        ``(cache_k, cache_v)``, the same tensors, with only column ``pos``
        rewritten.
    """
    name = "cache_column_write"
    if cache_k.ndim != 3 or cache_v.shape != cache_k.shape:
        raise ValueError(f"{name}: caches must share one [rows, P, D] shape, "
                         f"got {tuple(cache_k.shape)}, "
                         f"{tuple(cache_v.shape)}")
    rows, p, d = cache_k.shape
    for t in (k_new, v_new):
        if t.shape != (rows, d):
            raise ValueError(f"{name}: k_new and v_new must be [{rows}, {d}]"
                             f", got {tuple(t.shape)}")
    if cache_v.dtype != cache_k.dtype or v_new.dtype != k_new.dtype:
        raise ValueError(f"{name}: the caches, and k_new and v_new, must "
                         f"each share one dtype")
    if not 0 <= pos < p:
        raise ValueError(f"{name}: pos {pos} outside the cache length {p}")
    if not _build.on_kernel_device(name, cache_k, cache_v, k_new, v_new):
        return cache_column_write_plain(cache_k, cache_v, k_new, v_new, pos)
    cache_code = _build.dtype_code(cache_k, name)
    new_code = _build.dtype_code(k_new, name)
    # the kernel stores 16-byte chunks of each row's column
    _build.check_vector_rows(name, d, cache_k, cache_v)
    err = _build.library().dh_cache_column_write(
        cache_code, new_code, cache_k.data_ptr(), cache_v.data_ptr(),
        k_new.data_ptr(), v_new.data_ptr(), rows, p, d, pos,
        _build.stream_of(cache_k))
    _build.check(err, name)
    _build.note_launch(name)
    return cache_k, cache_v
