"""Process group, device mesh and batch helpers (PyTorch port of
``emojivoice_tpu.parallel.mesh``): the data-parallel half of the port's
parallelism.

JAX runs one process over many devices and lets GSPMD split a global batch.
The port runs one process per device (a *rank*), SPMD: every rank calls the
same function with the same arguments and computes its share, and the result
equals the one-device result.

* ``initialize_distributed`` is ``torch.distributed.init_process_group`` over
  ``tcp://host:port``: NCCL on the card, gloo on the CPU.  More ranks on the
  card than there are cards is refused by count; gloo carries CUDA tensors
  too, so two ranks may share one card when the caller asks for gloo.
* ``spawn`` starts N local ranks (``--num_devices N``), one device each, and
  waits for them with a deadline.
* ``make_mesh`` is a 1-D ``(data,)`` ``DeviceMesh`` over the group
  (``parallel/tp.py::make_mesh_2d`` the 2-D ``(data, model)`` one), wrapped
  in ``Mesh``, the port's ``jax.sharding.Mesh``: its ``shape`` maps axis names
  to sizes, and each axis has its process group and this rank's index on it.
* ``batch_sharding`` / ``replicated_sharding`` are the DTensor placements
  ``Shard(0)`` / ``Replicate()``; ``shard_batch`` cuts this data rank's rows
  out of a global batch; ``pad_batch_to_multiple`` is the JAX function.
* ``global_ratio`` is a loss over the global batch from each rank's share:
  the denominators are summed over the data group and the ratio is scaled by
  the group's size, so that DDP's mean of the ranks' gradients is the
  gradient of the global ratio (the JAX package computes that ratio on the
  sharded batch directly).

The JAX ``shard_chunk`` serves only ``make_train_multi_step``, a remote-TPU
workaround that the port does not have.
"""

from __future__ import annotations

import collections
import dataclasses
import datetime
import socket
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

DATA_AXIS = "data"
TIMEOUT_S = 600  # no collective waits longer: a hung rank fails the run

# the collectives the port's own code calls (by kind: "all_reduce", "all_gather"), here and in parallel/tp.py; DDP's
# gradient buckets are its reducer's and are not counted here
collectives: collections.Counter = collections.Counter()


@dataclasses.dataclass
class Mesh:
    """A ``DeviceMesh`` as this rank sees it."""

    device_mesh: object  # torch.distributed.device_mesh.DeviceMesh
    device: torch.device

    @property
    def shape(self) -> dict:
        dm = self.device_mesh
        return {name: dm.size(i) for i, name in enumerate(dm.mesh_dim_names)}

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def rank(self, axis: str) -> int:
        return self.device_mesh.get_local_rank(axis) if axis in self.shape else 0

    def group(self, axis: str):
        """The process group of `axis` (None where the mesh has no such axis)."""
        return self.device_mesh[axis].get_group() if axis in self.shape else None


def free_port() -> int:
    """An ephemeral port on localhost for a local rendezvous."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def initialize_distributed(coordinator: str, num_processes: int, process_id: int, device="cuda",
                           backend: Optional[str] = None, local_rank: Optional[int] = None) -> torch.device:
    """Join the process group at ``tcp://<coordinator>`` as rank
    `process_id` of `num_processes` → this rank's device.  The backend is
    NCCL on the card and gloo on the CPU unless `backend` says otherwise.
    The device of local rank r is card r; NCCL needs a card per rank on this
    host, and a shortfall is refused by count, never met with gloo or the
    CPU; gloo ranks may share a card (card r mod cards)."""
    device = torch.device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    local = process_id if local_rank is None else local_rank
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available (pass the CPU as the device to run ranks there)")
        have = torch.cuda.device_count()
        if backend == "nccl" and local >= have:
            raise RuntimeError(f"NCCL rank {process_id} needs card {local}, and this host has {have} card(s): "
                               f"ask for at most {have} rank(s) per host, or for gloo to share a card")
        device = torch.device("cuda", local % have)
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}", world_size=num_processes,
                            rank=process_id, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return device


def spawn(fn: Callable, nprocs: int, args: Sequence = (), timeout_s: Optional[float] = None) -> None:
    """Run ``fn(rank, *args)`` in `nprocs` new processes and wait for all of
    them; a rank that raises, or a run past `timeout_s`, ends every rank and
    raises here."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(fn, args=tuple(args), nprocs=nprocs, join=False, start_method="spawn")
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=1.0):
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"{nprocs} ranks did not finish within {timeout_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(10)


def make_mesh(num_devices: Optional[int] = None, axis: str = DATA_AXIS, device=None) -> Mesh:
    """1-D data-parallel mesh over every rank of the process group (whose
    size `num_devices`, where given, must be)."""
    return _device_mesh((num_devices or dist.get_world_size(),), (axis,), device)


def _device_mesh(shape, names, device=None) -> Mesh:
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("a mesh spans a process group: call initialize_distributed first")
    world = dist.get_world_size()
    if int(np.prod(shape)) != world:
        raise ValueError(f"Requested {'x'.join(map(str, shape))} devices, the process group has {world} ranks")
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device()) if dist.get_backend() == "nccl" \
            else torch.device("cpu")
    device = torch.device(device)
    return Mesh(init_device_mesh(device.type, tuple(shape), mesh_dim_names=tuple(names)), device)


def batch_sharding(mesh: Mesh, axis: str = DATA_AXIS):
    """Dim 0 (the batch) split over the data axis."""
    return Shard(0)


def replicated_sharding(mesh: Mesh):
    return Replicate()


def rows(mesh: Optional[Mesh], b: int, axis: str = DATA_AXIS) -> slice:
    """This data rank's rows of a global batch of `b` (all of them without a mesh)."""
    n = 1 if mesh is None else mesh.size(axis)
    if b % n:
        raise ValueError(f"a batch of {b} rows does not split over {n} data ranks")
    r = 0 if mesh is None else mesh.rank(axis)
    return slice(r * b // n, (r + 1) * b // n)


def shard_batch(mesh: Mesh, batch: dict, axis: str = DATA_AXIS) -> dict:
    """A global batch dict → this data rank's rows of every entry."""
    b = next(iter(batch.values())).shape[0]
    sl = rows(mesh, b, axis)
    return {k: v[sl] for k, v in batch.items()}


def pad_batch_to_multiple(batch: dict, n: int) -> dict:
    """Pad the batch dim up to a multiple of n by repeating the final row,
    and attach a "row_mask" (B,) f32 — 1 for real rows, 0 for padding.

    The losses weight rows by row_mask (models/matcha.py), so padded rows
    contribute exactly nothing to values or gradients: uneven final batches
    shard over the mesh without dropping data (the reference's DDP simply
    drops them).  row_mask is attached even when no padding is needed so the
    compiled-step pytree structure (and thus the XLA program cache) is the
    same for even and uneven batches."""
    b = next(iter(batch.values())).shape[0]
    pad = (-b) % n
    out = {k: np.concatenate([v, np.repeat(v[-1:], pad, axis=0)], axis=0) if pad else v
           for k, v in batch.items()}
    out["row_mask"] = np.concatenate(
        [np.ones(b, np.float32), np.zeros(pad, np.float32)]
    )
    return out


def global_ratio(num: torch.Tensor, den: torch.Tensor, group=None) -> torch.Tensor:
    """``num / den`` where each rank of the data `group` holds a share of
    both sums: the denominators are summed over the group and the ratio is
    scaled by its size (see the module docstring).  Without a group, the
    one-device ratio."""
    if group is None:
        return num / den
    den = den.detach().clone()
    collectives["all_reduce"] += 1
    dist.all_reduce(den, group=group)
    return num / den * dist.get_world_size(group)


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous().clone()
        collectives["all_reduce"] += 1
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        collectives["all_reduce"] += 1
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def sum_over(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of `x` over the data `group`, differentiable: every rank's
    loss depends on every rank's share, so the gradient is summed too."""
    return _SumOver.apply(x, group)


def mean_over(values: dict, group=None) -> dict:
    """The data group's mean of each 0-d tensor in `values`, in one
    all-reduce (the global losses from the ranks' scaled shares)."""
    if group is None or dist.get_world_size(group) == 1:
        return values
    keys = list(values)
    stacked = torch.stack([values[k].detach().float() for k in keys])
    collectives["all_reduce"] += 1
    dist.all_reduce(stacked, group=group)
    stacked /= dist.get_world_size(group)
    return dict(zip(keys, stacked.unbind()))


def gather_rows(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every data rank's rows of `t`, in rank order, on every rank."""
    if group is None or dist.get_world_size(group) == 1:
        return t
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    collectives["all_gather"] += 1
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, 0)

