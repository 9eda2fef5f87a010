"""Hand-written CUDA kernels of the decode path and their plain twins."""

from deephumor_tpu_torch.ops._build import LAUNCHES, reset_launch_counts
from deephumor_tpu_torch.ops.attention import (
    ancestry_attention, ancestry_attention_ids, ancestry_attention_ids_plain,
    ancestry_attention_plain, ancestry_attention_update,
    ancestry_attention_update_canon, ancestry_attention_update_canon_plain,
    ancestry_attention_update_flash, ancestry_attention_update_flash_plain,
    ancestry_attention_update_plain, ancestry_bias, cross_attention_packed,
    cross_attention_packed_plain, grouped_cross_attention,
    grouped_cross_attention_plain)
from deephumor_tpu_torch.ops.cache import (cache_column_write,
                                           cache_column_write_plain)
from deephumor_tpu_torch.ops.engine import (fused_survivor_update,
                                            fused_survivor_update_plain)
from deephumor_tpu_torch.ops.sampler import (
    fused_classifier_topk_gumbel_sample,
    fused_classifier_topk_gumbel_sample_plain, fused_topk_gumbel_sample,
    fused_topk_gumbel_sample_plain)

__all__ = [
    "LAUNCHES", "reset_launch_counts", "ancestry_bias",
    "ancestry_attention", "ancestry_attention_plain",
    "ancestry_attention_update", "ancestry_attention_update_plain",
    "ancestry_attention_update_flash",
    "ancestry_attention_update_flash_plain",
    "ancestry_attention_update_canon",
    "ancestry_attention_update_canon_plain",
    "ancestry_attention_ids", "ancestry_attention_ids_plain",
    "grouped_cross_attention", "grouped_cross_attention_plain",
    "cross_attention_packed", "cross_attention_packed_plain",
    "cache_column_write", "cache_column_write_plain",
    "fused_topk_gumbel_sample", "fused_topk_gumbel_sample_plain",
    "fused_classifier_topk_gumbel_sample",
    "fused_classifier_topk_gumbel_sample_plain",
    "fused_survivor_update", "fused_survivor_update_plain",
]
