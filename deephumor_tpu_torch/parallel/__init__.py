"""Parallelism layer: a data x model ``DeviceMesh`` over
``torch.distributed``, data and tensor sharding (counterpart of
deephumor_tpu/parallel/)."""

from deephumor_tpu_torch.parallel.mesh import (
    data_sharding,
    dp_generate,
    make_mesh,
    replicate,
    replicated_sharding,
    shard_batch,
    tp_generate,
)
from deephumor_tpu_torch.parallel.sharding import (make_param_shardings,
                                                   place_train_state,
                                                   tp_param_specs)

__all__ = [
    "make_mesh",
    "shard_batch",
    "replicate",
    "data_sharding",
    "replicated_sharding",
    "dp_generate",
    "tp_generate",
    "tp_param_specs",
    "make_param_shardings",
    "place_train_state",
]
