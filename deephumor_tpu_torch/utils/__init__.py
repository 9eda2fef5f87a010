"""Utilities: the ``.npz`` parameter checkpoint format (counterpart of
deephumor_tpu/utils). ``utils.checkpoint`` (whole training states),
``utils.config`` and ``utils.profiling`` are imported by name."""

from deephumor_tpu_torch.utils.pytree import (flatten_tree, load_params,
                                              save_params, unflatten_tree)

__all__ = ["flatten_tree", "unflatten_tree", "save_params", "load_params"]
