"""Parallelism over ranks (PyTorch port of ``emojivoice_tpu.parallel``):
a process group, a ``(data, model)`` device mesh, DDP over the data axis and
Megatron-style tensor parallelism on the model axis."""

from emojivoice_tpu_torch.parallel.mesh import (
    Mesh,
    batch_sharding,
    initialize_distributed,
    make_mesh,
    pad_batch_to_multiple,
    replicated_sharding,
    shard_batch,
    spawn,
)
from emojivoice_tpu_torch.parallel.tp import (
    MODEL_AXIS,
    count_sharded,
    make_mesh_2d,
    shard_params,
    spec_for,
    tp_shardings,
    tp_specs,
)

__all__ = [
    "MODEL_AXIS",
    "Mesh",
    "batch_sharding",
    "count_sharded",
    "initialize_distributed",
    "make_mesh",
    "make_mesh_2d",
    "pad_batch_to_multiple",
    "replicated_sharding",
    "shard_batch",
    "shard_params",
    "spawn",
    "spec_for",
    "tp_shardings",
    "tp_specs",
]
