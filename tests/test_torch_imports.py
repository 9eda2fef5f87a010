"""deephumor_tpu_torch stands alone (no JAX, no deephumor_tpu) and its
kernel wrappers only launch for CUDA tensors."""

import ast
import pathlib

import pytest
import torch

from deephumor_tpu_torch.ops import (LAUNCHES, _build, ancestry_bias,
                                     ancestry_attention_update,
                                     fused_topk_gumbel_sample,
                                     grouped_cross_attention,
                                     reset_launch_counts)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "deephumor_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_jax_package(path):
    bad = _imported_roots(path) & {"jax", "jaxlib", "deephumor_tpu", "flax"}
    assert not bad, f"{path} imports {bad}"


def _small_inputs():
    g = torch.Generator().manual_seed(0)
    items, beam, p, d, t = 2, 3, 8, 16, 5
    rows = items * beam
    anc = torch.randint(0, beam, (items, beam, p), generator=g)
    valid = torch.ones(rows, p, dtype=torch.bool)
    attn = (torch.randn(rows, d, generator=g),
            torch.randn(rows, p, d, generator=g),
            torch.randn(rows, p, d, generator=g),
            torch.randn(rows, d, generator=g),
            torch.randn(rows, d, generator=g),
            ancestry_bias(anc, valid, p))
    cross = (torch.randn(rows, d, generator=g),
             torch.randn(items, t, d, generator=g),
             torch.randn(items, t, d, generator=g), None)
    return attn, cross, torch.randn(rows, 40, generator=g)


def test_cpu_tensors_use_the_twins_and_launch_nothing():
    reset_launch_counts()
    attn, cross, logits = _small_inputs()
    ancestry_attention_update(*attn, 3, beam=3, n_heads=2)
    grouped_cross_attention(*cross, n_heads=2)
    fused_topk_gumbel_sample(logits, 1, 1.0, top_k=8, num_draws=3)
    assert set(LAUNCHES.values()) == {0}
    # nothing was built either
    assert _build.library.cache_info().currsize == 0


def test_other_devices_raise():
    logits = torch.randn(4, 40, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        fused_topk_gumbel_sample(logits, 1, 1.0, top_k=8, num_draws=3)


@pytest.mark.parametrize("case", ["dtype", "shape", "pos", "draws"])
def test_wrappers_reject_what_the_kernels_do_not_take(case):
    attn, cross, logits = _small_inputs()
    with pytest.raises(ValueError):
        if case == "dtype":
            grouped_cross_attention(cross[0].half(), *cross[1:], n_heads=2)
        elif case == "shape":
            ancestry_attention_update(attn[0][:-1], *attn[1:], 0, beam=3,
                                      n_heads=2)
        elif case == "pos":
            ancestry_attention_update(*attn, 8, beam=3, n_heads=2)
        else:
            fused_topk_gumbel_sample(logits, 1, 1.0, top_k=2, num_draws=3)
