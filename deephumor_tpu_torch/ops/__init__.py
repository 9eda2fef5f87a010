"""Hand-written CUDA kernels of the decode path and their plain twins."""

from deephumor_tpu_torch.ops._build import LAUNCHES, reset_launch_counts
from deephumor_tpu_torch.ops.attention import (
    ancestry_attention_update, ancestry_attention_update_plain,
    ancestry_bias, grouped_cross_attention, grouped_cross_attention_plain)
from deephumor_tpu_torch.ops.sampler import (
    fused_topk_gumbel_sample, fused_topk_gumbel_sample_plain)

__all__ = [
    "LAUNCHES", "reset_launch_counts", "ancestry_bias",
    "ancestry_attention_update", "ancestry_attention_update_plain",
    "grouped_cross_attention", "grouped_cross_attention_plain",
    "fused_topk_gumbel_sample", "fused_topk_gumbel_sample_plain",
]
