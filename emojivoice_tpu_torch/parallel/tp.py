"""Tensor-parallel parameter sharding over a 2-D ``(data, model)`` mesh
(PyTorch port of ``emojivoice_tpu.parallel.tp``).

The rule set is the JAX package's Megatron column → row pairing, so that each
product pair costs one all-reduce on its output:

acoustic model (models/{text_encoder,decoder}.py):
  - encoder FFN       conv_1 out-sharded   → conv_2 in-sharded
  - encoder attention conv_{q,k,v} out     → conv_o in        (head split)
  - decoder tblock    to_{q,k,v} out       → to_out in        (head split)
  - decoder tblock FF proj_in out (+ snake α/β on the hidden)
                                           → proj_out in
  - time-emb MLP      linear_2 out         → every resnet mlp in
HiFi-GAN (vocoder/hifigan.py):
  - resblock          convs1_* out         → convs2_* in

``TP_RULES`` names the port's own ``state_dict`` keys in torch layouts: a
Conv1d weight is (out, in, k) and a Linear weight (out, in), so JAX's column
split (flax dim -1) is torch dim 0 and its row split (flax dim -2) is dim 1.
A rule applies only where the dimension divides by the model-axis size;
otherwise the leaf stays replicated, as in JAX, and tp 1 replicates
everything.

GSPMD inserts the collectives for JAX; here ``shard_params`` replaces each
split layer by a ``ShardedLayer`` holding its own slice of the weight under
the same parameter names, with Megatron's two autograd-aware collectives: f
(``copy_to_model``: identity forward, all-reduce of the gradient backward)
before a column-parallel product, g (``reduce_from_model``: all-reduce
forward, identity backward) after a row-parallel one, whose bias is added
once, after the all-reduce.  Where a split would cut an attention head (a
q/k/v slice that is not whole heads, as at tiny width with tp 4 or 8), the
layers of that attention gather their weight slices for the product
(``gather_weight``: all-gather forward, this rank's slice of the gradient
backward) and compute the whole attention on every rank of the model group,
so every degree that JAX accepts gives the same numbers.

HiFi-GAN's serving path is K1, which fuses each res-block's column → row
pairs with the residual adds between them: a split pair would need an
all-reduce inside the kernel.  So the generator's weights are laid out by the
rules (``count_sharded`` agrees with JAX), and ``stage_weights`` gathers each
stage's weights once, when it packs them for K1; every rank then runs K1 on
its own rows.  (JAX serves a sharded generator through XLA convs.)
"""

from __future__ import annotations

import re
from typing import Any, Mapping, Sequence

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F
from torch.distributed.tensor import Replicate, Shard

from emojivoice_tpu_torch.parallel.mesh import DATA_AXIS, Mesh, _device_mesh, collectives

MODEL_AXIS = "model"

# (state_dict key regex, torch dimension to split on the model axis), re.search'd
TP_RULES: Sequence[tuple[str, int]] = (
    # --- text encoder (RoPE transformer) ---
    (r"encoder\.encoder\.ffn_layers\.\d+\.conv_1\.(weight|bias)$", 0),
    (r"encoder\.encoder\.ffn_layers\.\d+\.conv_2\.weight$", 1),
    (r"encoder\.encoder\.attn_layers\.\d+\.conv_[qkv]\.(weight|bias)$", 0),
    (r"encoder\.encoder\.attn_layers\.\d+\.conv_o\.weight$", 1),
    # --- decoder U-Net transformer blocks ---
    (r"\.attn1\.to_[qkv]\.weight$", 0),
    (r"\.attn1\.to_out\.0\.weight$", 1),
    (r"\.ff\.net\.0\.proj\.(weight|bias)$", 0),
    (r"\.ff\.net\.0\.(alpha|beta)$", 0),  # SnakeBeta acts on the sharded hidden
    (r"\.ff\.net\.2\.weight$", 1),
    # --- time-embedding MLP → per-resnet conditioning projections ---
    (r"time_mlp\.linear_2\.(weight|bias)$", 0),
    (r"_blocks\.\d+\.0\.mlp\.1\.weight$", 1),
    # --- HiFi-GAN MRF residual stacks ---
    (r"resblocks\.\d+\.convs1\.\d+\.(weight|bias)$", 0),
    (r"resblocks\.\d+\.convs2\.\d+\.weight$", 1),
)


def make_mesh_2d(data: int, model: int, device=None) -> Mesh:
    """(data × model) mesh over the process group's data·model ranks, the
    model axis fastest (rank = data index · model + model index)."""
    return _device_mesh((data, model), (DATA_AXIS, MODEL_AXIS), device)


def spec_for(name: str, shape, tp: int):
    """Placement on the model axis of one state_dict entry under TP_RULES:
    ``Shard(dim)``, or ``Replicate()`` where no rule matches or the dimension
    does not divide by `tp`."""
    if tp <= 1:
        return Replicate()
    for pattern, dim in TP_RULES:
        if re.search(pattern, name):
            if len(shape) <= dim or shape[dim] % tp != 0:
                return Replicate()
            return Shard(dim)
    return Replicate()


def tp_specs(tree: Mapping[str, Any], mesh) -> dict:
    """{name: placement on the model axis} for a state dict or any mapping
    of names to tensors or shapes; `mesh` is anything with a ``shape`` dict."""
    tp = mesh.shape.get(MODEL_AXIS, 1)
    return {name: spec_for(name, tuple(getattr(v, "shape", v)), tp) for name, v in tree.items()}


def tp_shardings(tree: Mapping[str, Any], mesh) -> dict:
    """{name: DTensor placements over the mesh's axes}: replicated over the
    data axis, ``tp_specs`` on the model axis."""
    names = tuple(mesh.shape)
    return {name: tuple(spec if axis == MODEL_AXIS else Replicate() for axis in names)
            for name, spec in tp_specs(tree, mesh).items()}


def count_sharded(tree: Mapping[str, Any], mesh) -> tuple[int, int]:
    """(# sharded entries, total entries)."""
    specs = tp_specs(tree, mesh).values()
    return sum(1 for s in specs if isinstance(s, Shard)), len(specs)


# ---------------------------------------------------------------------- #
# Megatron's collectives, autograd-aware
# ---------------------------------------------------------------------- #

class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        collectives["all_reduce"] += 1
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        collectives["all_reduce"] += 1
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherWeight(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, dim, group):
        n, ctx.rank, ctx.dim, ctx.size = dist.get_world_size(group), dist.get_rank(group), dim, w.shape[dim]
        parts = [torch.empty_like(w) for _ in range(n)]
        collectives["all_gather"] += 1
        dist.all_gather(parts, w.contiguous(), group=group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, grad):
        # the gathered weight feeds a product that every rank of the group computes alike
        return grad.narrow(ctx.dim, ctx.rank * ctx.size, ctx.size).contiguous(), None, None


def copy_to_model(x, group):
    """Megatron's f: identity forward, all-reduce of the gradient backward."""
    return _CopyToModel.apply(x, group)


def reduce_from_model(x, group):
    """Megatron's g: all-reduce forward, identity backward."""
    return _ReduceFromModel.apply(x, group)


def gather_weight(w, dim: int, group):
    """The whole weight from every rank's slice on `dim`."""
    return _GatherWeight.apply(w, dim, group)


class _Group:
    """The model-axis process group a sharded layer talks over; shared, not
    copied, by ``copy.deepcopy`` of a model (a process group is no value)."""

    def __init__(self, group):
        self.group, self.size, self.rank = group, dist.get_world_size(group), dist.get_rank(group)

    def __deepcopy__(self, memo):
        return self


class ShardedLayer(nn.Module):
    """A ``nn.Linear`` or ``nn.Conv1d`` whose weight is split over the model
    axis on `dim`: 0 splits the output features (column-parallel, the bias
    with them), 1 the input features (row-parallel, the bias whole).  Same
    parameter names as the layer it replaces.  With `gather` the product runs
    on the gathered weight (the module docstring)."""

    def __init__(self, layer: nn.Module, dim: int, group: _Group, gather: bool = False):
        super().__init__()
        self.dim, self.tp, self.gather = dim, group, gather
        self.linear = isinstance(layer, nn.Linear)
        if not self.linear:
            self.conv = dict(stride=layer.stride, padding=layer.padding, dilation=layer.dilation, groups=layer.groups)
        self.weight = nn.Parameter(_slice(layer.weight, dim, group))
        self.weight.tp_dim = dim
        if layer.bias is None:
            self.register_parameter("bias", None)
        elif dim == 0:
            self.bias = nn.Parameter(_slice(layer.bias, 0, group))
            self.bias.tp_dim = 0
        else:
            self.bias = nn.Parameter(layer.bias.detach().clone())

    def _product(self, x, w, b):
        return F.linear(x, w, b) if self.linear else F.conv1d(x, w, b, **self.conv)

    def full(self):
        """(weight, bias) as the unsplit layer holds them, gathered."""
        w = gather_weight(self.weight, self.dim, self.tp.group)
        b = self.bias
        if b is not None and self.dim == 0:
            b = gather_weight(b, 0, self.tp.group)
        return w, b

    def forward(self, x):
        w, b = self.full() if self.gather else (self.weight, self.bias)
        w, b = w.to(x.dtype), None if b is None else b.to(x.dtype)  # as the time MLP casts (models/decoder.py)
        if self.gather:
            return self._product(x, w, b)
        if self.dim == 0:
            return self._product(copy_to_model(x, self.tp.group), w, b)
        y = reduce_from_model(self._product(x, w, None), self.tp.group)
        if b is None:
            return y
        return y + (b if self.linear else b[:, None])


def _slice(t: torch.Tensor, dim: int, group: _Group) -> torch.Tensor:
    return t.detach().chunk(group.size, dim)[group.rank].clone()


def is_sharded(p: torch.Tensor) -> bool:
    """Whether a parameter is this rank's slice on the model axis."""
    return getattr(p, "tp_dim", None) is not None


def gathered(layer: nn.Module):
    """(weight, bias) of a layer as one device holds them: gathered from a
    ``ShardedLayer``, the layer's own otherwise."""
    return layer.full() if isinstance(layer, ShardedLayer) else (layer.weight, layer.bias)


@torch.no_grad()
def full_state_dict(module: nn.Module, mesh: Mesh) -> dict:
    """`module`'s state dict as one device holds it: every tensor-parallel
    slice gathered over the mesh's model axis (a collective: every rank of
    the model group calls it)."""
    params = dict(module.named_parameters())
    group = mesh.group(MODEL_AXIS)
    return {name: gather_weight(params[name].detach(), params[name].tp_dim, group)
            if name in params and is_sharded(params[name]) else t
            for name, t in module.state_dict().items()}


def shard_params(module: nn.Module, mesh: Mesh) -> nn.Module:
    """Lay `module`'s parameters out by TP_RULES on the mesh's model axis, in
    place: each split Linear / Conv1d becomes a ``ShardedLayer``, and a split
    parameter of another module (SnakeBeta's α, β) becomes its slice.  An
    attention whose heads a split would cut gathers for its products.  Does
    nothing at tp 1, or to a module already laid out."""
    tp = mesh.size(MODEL_AXIS)
    if tp <= 1 or any(is_sharded(p) for p in module.parameters()):
        return module
    group = _Group(mesh.group(MODEL_AXIS))
    layers = {}
    for name, spec in tp_specs(dict(module.named_parameters()), mesh).items():
        if not isinstance(spec, Shard):
            continue
        owner_name, _, leaf = name.rpartition(".")
        owner = module.get_submodule(owner_name)
        if isinstance(owner, (nn.Linear, nn.Conv1d)):
            layers[owner_name] = spec.dim
        else:
            p = nn.Parameter(_slice(getattr(owner, leaf), spec.dim, group))
            p.tp_dim = spec.dim
            setattr(owner, leaf, p)
    for name, dim in layers.items():
        parent_name, _, child = name.rpartition(".")
        parent = module.get_submodule(parent_name)
        parent._modules[child] = ShardedLayer(parent._modules[child], dim, group)
    for m in module.modules():
        heads = getattr(m, "n_heads", None) or getattr(m, "heads", None)
        if heads and heads % tp:
            for layer in m.modules():
                if isinstance(layer, ShardedLayer):
                    layer.gather = True
    return module
