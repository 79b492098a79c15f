"""Sharding rules of the port: parameter, batch and cache specs per arch,
and their placement as DTensors on a device mesh.

The counterpart of :mod:`repro.models.sharding`, rule for rule:

- tensor parallel over ``model``: attention heads, FFN hidden, vocab,
  experts (MoE), SSM inner channels;
- batch over (pod, data); FSDP over ``data`` for models of at least
  :data:`FSDP_THRESHOLD` parameters (parameters *and* optimizer state);
- ``long_500k`` decode: the KV cache's *sequence* axis over ``data``;
- an axis that does not divide the mesh axis (MQA's single KV head,
  xLSTM's four heads) is replicated, or sharded on an inner dimension.

Three differences of layout from the reference, none of rule:

- a spec is a :class:`Spec`, a tuple of one entry per tensor dimension
  (``None``, a mesh axis name, or a tuple of names), where the reference
  has JAX's ``PartitionSpec``;
- the port keeps its layers as a per-layer list, so no leaf carries the
  reference's scanned leading axis and no spec its leading ``None``;
- the port's KV caches are (B, KV, S, hd) where the reference's are (B, S,
  KV, hd), so :func:`cache_specs` permutes the reference's rule for them.

A mesh here is anything with named axis sizes: a
:class:`torch.distributed.device_mesh.DeviceMesh` with
``mesh_dim_names``, or any object whose ``shape`` maps axis names to sizes
(as a JAX mesh's does).  :func:`to_placements` turns a spec into DTensor
placements on a device mesh and :func:`place` puts a tree of tensors on
one, shard by shard.
"""

from __future__ import annotations

import math
from typing import Any, Callable

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard

from .config import ModelConfig

FSDP_THRESHOLD = 8_000_000_000  # params; above this, shard params over data

Axis = str | tuple[str, ...] | None


class Spec(tuple):
    """One entry per tensor dimension: ``None`` (replicated), a mesh axis
    name, or a tuple of names (the dimension split over each, the first
    the major)."""

    def __new__(cls, *entries: Axis) -> "Spec":
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


def _axis_sizes(mesh: Any) -> dict[str, int]:
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def _axsize(mesh: Any, name: str) -> int:
    return _axis_sizes(mesh).get(name, 1)


def _div(dim: int, mesh: Any, axis: str) -> str | None:
    """The mesh axis if ``dim`` divides evenly over it (and it has more than
    one device), else None."""
    n = _axsize(mesh, axis)
    return axis if (n > 1 and dim % n == 0) else None


def dp_axes(mesh: Any) -> tuple[str, ...]:
    sizes = _axis_sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in sizes)


def use_fsdp(cfg: ModelConfig) -> bool:
    return cfg.n_params_estimate >= FSDP_THRESHOLD


def _fsdp_axis(cfg: ModelConfig, mesh: Any, dim: int) -> str | None:
    if not use_fsdp(cfg):
        return None
    return _div(dim, mesh, "data")


def _map_with_path(fn: Callable, tree: Any, path: tuple[str, ...] = ()) -> Any:
    """``fn(path, leaf)`` over the dicts and lists of ``tree``; a path is the
    dict keys and list indices (as strings) down to the leaf."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, (*path, str(k))) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_with_path(fn, v, (*path, str(i))) for i, v in enumerate(tree)]
    return fn(path, tree)


def param_specs(
    cfg: ModelConfig, params: Any, mesh: Any, moe_ff_axis: str | None = None
) -> Any:
    """A :class:`Spec` tree matching the port's parameter tree (tensors, or
    anything with a ``shape``).  ``moe_ff_axis``: serving-time 2-D expert
    sharding, the experts over ``model`` and their FFN hidden dimension over
    this axis (usually ``data``), as in the reference."""

    def rule(path, leaf) -> Spec:
        return _leaf_rule(path[-1], path, tuple(leaf.shape), cfg, mesh, moe_ff_axis)

    return _map_with_path(rule, params)


def _leaf_rule(
    name, keys, shape, cfg: ModelConfig, mesh: Any, moe_ff_axis: str | None = None
) -> Spec:
    f = lambda dim: _fsdp_axis(cfg, mesh, dim)  # noqa: E731
    if name == "table":  # embedding (V, d)
        return Spec(_div(shape[0], mesh, "model"), f(shape[1]))
    if name == "lm_head":  # (d, V)
        return Spec(f(shape[0]), _div(shape[1], mesh, "model"))
    if name == "frontend_proj":
        return Spec(None, f(shape[1]))
    if name in ("wq", "wk", "wv") and len(shape) == 3:  # (d, H, hd)
        h_ax = _div(shape[1], mesh, "model")
        if h_ax:
            return Spec(f(shape[0]), h_ax, None)
        return Spec(f(shape[0]), None, _div(shape[2], mesh, "model"))
    if name == "wo" and len(shape) == 3:  # (H, hd, d)
        h_ax = _div(shape[0], mesh, "model")
        if h_ax:
            return Spec(h_ax, None, f(shape[2]))
        return Spec(None, _div(shape[1], mesh, "model"), f(shape[2]))
    if name in ("w_gate", "w_up") and len(shape) == 2:  # mlp (d, ff)
        return Spec(f(shape[0]), _div(shape[1], mesh, "model"))
    if name == "w_down" and len(shape) == 2:  # (ff, d)
        return Spec(_div(shape[0], mesh, "model"), f(shape[1]))
    if name == "router":  # (d, E)
        return Spec(None, None)
    if name in ("w_gate", "w_up") and len(shape) == 3:  # moe (E, d, ff)
        e_ax = _div(shape[0], mesh, "model")
        if moe_ff_axis:
            return Spec(e_ax, None, _div(shape[2], mesh, moe_ff_axis))
        if e_ax:
            return Spec(e_ax, f(shape[1]), None)
        return Spec(None, f(shape[1]), _div(shape[2], mesh, "model"))
    if name == "w_down" and len(shape) == 3:  # moe (E, ff, d)
        e_ax = _div(shape[0], mesh, "model")
        if moe_ff_axis:
            return Spec(e_ax, _div(shape[1], mesh, moe_ff_axis), None)
        if e_ax:
            return Spec(e_ax, None, f(shape[2]))
        return Spec(None, _div(shape[1], mesh, "model"), f(shape[2]))
    # --- mamba ---
    if name in ("in_x", "in_z", "w_o"):  # (d, d_inner)
        return Spec(f(shape[0]), _div(shape[1], mesh, "model"))
    if name == "out" and len(shape) == 2:  # (d_inner, d)
        return Spec(_div(shape[0], mesh, "model"), f(shape[1]))
    if name == "conv":  # (w, d_inner)
        return Spec(None, _div(shape[1], mesh, "model"))
    if name in ("w_b", "w_c", "w_dt_lo"):  # (d_inner, N/r)
        return Spec(_div(shape[0], mesh, "model"), None)
    if name == "w_dt_hi":  # (r, d_inner)
        return Spec(None, _div(shape[1], mesh, "model"))
    if name in ("dt_bias", "d_skip"):  # (d_inner,)
        return Spec(_div(shape[0], mesh, "model"))
    if name == "a_log":  # (d_inner, N)
        return Spec(_div(shape[0], mesh, "model"), None)
    # --- mlstm / slstm ---
    if name in ("w_i", "w_f"):  # (d, H)
        return Spec(f(shape[0]), None)
    if name == "w_in" and len(shape) == 3:  # slstm (d, 4, d)
        return Spec(f(shape[0]), None, _div(shape[2], mesh, "model"))
    if name == "r" and len(shape) == 4:  # slstm (4, H, hd, hd)
        return Spec(None, None, None, _div(shape[3], mesh, "model"))
    # norms, biases, scalars → replicated
    return Spec(*([None] * len(shape)))


# ----------------------------------------------------------- activations
def batch_spec(cfg: ModelConfig, mesh: Any, global_batch: int, ndim: int) -> Spec:
    """The batch dimension over (pod, data) where the batch divides them,
    every other dimension replicated."""
    axes = dp_axes(mesh)
    n = math.prod(_axsize(mesh, a) for a in axes)
    lead = axes if (axes and global_batch % n == 0) else ()
    lead_spec = lead if len(lead) != 1 else lead[0]
    return Spec(lead_spec if lead else None, *([None] * (ndim - 1)))


def input_batch_specs(cfg: ModelConfig, mesh: Any, batch_tree: Any, global_batch: int) -> Any:
    return _map_with_path(
        lambda _, leaf: batch_spec(cfg, mesh, global_batch, len(leaf.shape)), batch_tree
    )


def batch_logits_spec(cfg: ModelConfig, mesh: Any, global_batch: int) -> Spec:
    """Logits (B, 1, V): batch over (pod, data), vocabulary over ``model``."""
    lead = batch_spec(cfg, mesh, global_batch, 1)[0]
    return Spec(lead, None, _div(cfg.vocab_size, mesh, "model"))


def cache_specs(
    cfg: ModelConfig,
    mesh: Any,
    cache_tree: Any,
    global_batch: int,
    seq_shard: bool,
    seq_axis: str = "data",
) -> Any:
    """Specs of the port's decode cache (a list of per-layer dicts).

    ``seq_shard=True``: the KV cache's *length* over ``seq_axis``
    (sequence-parallel decoding).  Otherwise the batch over (pod, data) and
    the KV heads over ``model`` where they divide it.  The rules are the
    reference's; for the KV caches, which the port keeps as (B, KV, S, hd),
    the reference's (B, S, KV, hd) rule is permuted to the port's order."""

    def lead() -> Axis:
        return None if seq_shard else batch_spec(cfg, mesh, global_batch, 1)[0]

    def rule(path, leaf) -> Spec:
        name = path[-1]
        shape = tuple(leaf.shape)
        if name in ("k", "v"):  # port (B, KV, S, hd) ≙ reference (B, S, KV, hd)
            b, kv, s, hd = shape
            if seq_shard:
                batch_ax = batch_spec(cfg, mesh, global_batch, 1)[0] if seq_axis == "model" else None
                ref = (batch_ax, _div(s, mesh, seq_axis), None, None)
            else:
                ref = (batch_spec(cfg, mesh, global_batch, 4)[0], None, _div(kv, mesh, "model"), None)
            return Spec(ref[0], ref[2], ref[1], ref[3])
        if name == "h" and len(shape) == 3:  # mamba (B, d_inner, N)
            return Spec(lead(), _div(shape[1], mesh, "model"), None)
        if name == "conv" and len(shape) == 3:  # (B, w-1, d_inner)
            return Spec(lead(), None, _div(shape[2], mesh, "model"))
        if name == "c" and len(shape) == 4:  # mlstm (B, H, hd, hd)
            return Spec(lead(), None, None, _div(shape[3], mesh, "model"))
        if name == "n" and len(shape) == 3:  # mlstm (B, H, hd)
            return Spec(lead(), None, _div(shape[2], mesh, "model"))
        if len(shape) == 2:  # slstm h/c/n (B, d)
            return Spec(lead(), _div(shape[1], mesh, "model"))
        return Spec(*([None] * len(shape)))

    return _map_with_path(rule, cache_tree)


# -------------------------------------------------------------- placement
def to_placements(mesh, spec: Spec) -> list[Placement]:
    """DTensor placements, one per dimension of the device mesh ``mesh``,
    of ``spec``: an axis name entry at tensor dimension ``d`` is ``Shard(d)``
    on that mesh dimension, and a tuple of names is ``Shard(d)`` on each of
    them, which must come in mesh order (the tuple's first name the major,
    as in JAX).  Every other mesh dimension is ``Replicate()``."""
    names = list(mesh.mesh_dim_names)
    placements: list[Placement] = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"{spec}: the axes {axes} of dimension {d} are not in mesh order {names}")
        for i in idx:
            placements[i] = Shard(d)
    return placements


def _local_slices(shape, mesh, placements) -> tuple[list[int], list[slice]]:
    """The local shape and the slices of the global tensor that this rank
    holds under ``placements`` (even shards only)."""
    coord = mesh.get_coordinate()
    local = list(shape)
    start = [0] * len(shape)
    for mdim, p in enumerate(placements):
        if not isinstance(p, Shard):
            continue
        n = mesh.size(mdim)
        if local[p.dim] % n:
            raise ValueError(f"dimension {p.dim} of {tuple(shape)} does not split evenly over {n}")
        local[p.dim] //= n
        start[p.dim] += coord[mdim] * local[p.dim]
    return local, [slice(s, s + n) for s, n in zip(start, local)]


def place(tree: Any, mesh, specs: Any) -> Any:
    """Every tensor of ``tree`` as a DTensor on the device mesh ``mesh``
    under the matching spec of ``specs`` (a tree of :class:`Spec` of the
    same structure).

    Each rank builds only its own shard, at its local shape, and wraps it
    with ``DTensor.from_local``: the global tensor is never formed on the
    mesh's device.  A leaf with data (on any device) is sliced to this
    rank's shard and copied to the mesh's device; a fake or meta leaf gives
    an empty meta shard of its type (the dry-run's: DTensor runs a meta
    shard on a mesh of any device type, and indexes it on a host whose
    PyTorch has no CUDA, which a fake CUDA tensor cannot)."""
    from torch._subclasses.fake_tensor import is_fake

    def leaf(path, t):
        spec = _get(specs, path)
        placements = to_placements(mesh, spec)
        shape, slices = _local_slices(tuple(t.shape), mesh, placements)
        if is_fake(t) or t.device.type == "meta":
            local = torch.empty(shape, dtype=t.dtype, device="meta")
        else:
            local = t.detach()[tuple(slices)].to(mesh.device_type).contiguous()
        out = DTensor.from_local(local, mesh, placements, run_check=False,
                                 shape=t.shape, stride=_contiguous_stride(t.shape))
        return out.requires_grad_(t.requires_grad)

    return _map_with_path(leaf, tree)


def _contiguous_stride(shape) -> tuple[int, ...]:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def _get(tree: Any, path: tuple[str, ...]) -> Any:
    for k in path:
        tree = tree[int(k)] if isinstance(tree, (list, tuple)) else tree[k]
    return tree


def full_tensor(tree: Any) -> Any:
    """Every DTensor of ``tree`` gathered to a plain tensor (other leaves as
    they are)."""
    return _map_with_path(
        lambda _, t: t.full_tensor() if isinstance(t, DTensor) else t, tree
    )


def gather_last(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x.gather(-1, idx[..., None])[..., 0]``: the entry of ``x`` at ``idx``
    along its last dimension (the gold logit of a loss).

    On a DTensor each shard looks up its own part, whatever the placements:
    where ``x`` is sharded over its last dimension (logits over a
    vocabulary sharded on ``model``) a shard gives the entries whose ids
    fall in its range and 0 for the others, and the result is ``Partial``,
    summed where it is next read (a (B, S) all-reduce, where gathering the
    logits would move all of them); a ``Partial`` ``x`` gives a ``Partial``
    result (the lookup is linear); a dimension sharded before the last
    takes ``idx`` sharded alike."""
    if not isinstance(x, DTensor):
        return x.gather(-1, idx[..., None])[..., 0]
    from torch.distributed.tensor import Partial

    last = x.ndim - 1
    mesh = x.device_mesh
    if any(type(p) not in (Shard, Replicate, Partial) for p in x.placements):
        x = x.redistribute(mesh, [Replicate()] * mesh.ndim)
    vdims = [i for i, p in enumerate(x.placements) if isinstance(p, Shard) and p.dim == last]
    idx_pl = [p if isinstance(p, Shard) and p.dim < last else Replicate() for p in x.placements]
    out_pl = [Partial() if i in vdims else (p if isinstance(p, Partial) else idx_pl[i])
              for i, p in enumerate(x.placements)]
    if not isinstance(idx, DTensor):
        idx = DTensor.from_local(idx, mesh, [Replicate()] * mesh.ndim, run_check=False)

    def local(xl, il):
        n = xl.shape[-1]
        loc = il - _shard_index(mesh, vdims) * n
        valid = (loc >= 0) & (loc < n)
        g = xl.gather(-1, loc.clamp(0, n - 1)[..., None])[..., 0]
        return torch.where(valid, g, torch.zeros((), dtype=g.dtype, device=g.device))

    return _shard_map(local, out_pl, (list(x.placements), idx_pl), mesh, x, idx)


def _shard_map(fn: Callable, out_pl, in_pls, mesh, *args):
    """``fn`` on the local shards of ``args`` placed by ``in_pls`` (inputs
    redistributed to them), its outputs placed by ``out_pl``
    (``local_map``).  Each input's gradient is placed as the input is,
    except that a replicated input's gradient is ``Partial`` on a mesh
    dimension where another input is sharded: each shard's computation
    then saw part of the work, and its gradient is a part of the sum
    (``local_map`` would otherwise take it as whole)."""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map

    split = [any(type(pl[m]) is Shard for pl in in_pls) for m in range(mesh.ndim)]
    grad_pls = tuple(
        [Partial() if type(p) is Replicate and split[m] else (Replicate() if p.is_partial() else p)
         for m, p in enumerate(pl)]
        for pl in in_pls)
    return local_map(fn, out_placements=out_pl, in_placements=tuple(in_pls),
                     in_grad_placements=grad_pls, device_mesh=mesh,
                     redistribute_inputs=True)(*args)


def _as_dtensor(t: torch.Tensor, mesh) -> DTensor:
    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def _mesh_of(*tensors):
    return next(t.device_mesh for t in tensors if isinstance(t, DTensor))


def _row_sharded(p, ndim_rows: int) -> bool:
    return type(p) is Shard and p.dim < ndim_rows


def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., K) @ w (K, *N) → (..., *N): a product with a weight (a 2-D
    weight, or a head projection (d, H, hd)).

    On DTensors each mesh dimension is placed as the reference lays its
    weights out, data-parallel over (pod, data) and tensor-parallel over
    the rest (``model``):

    - over a data-parallel dimension, where x's rows (the batch) are
      sharded, the weight is gathered there (FSDP) and the output keeps
      the rows' sharding;
    - otherwise the weight keeps its layout: a weight sharded over an
      output dimension gives an output sharded alike, x whole (its rows
      gathered if they were sharded there); a weight sharded over K (a
      row-parallel product) takes x sharded over K alike, and the shards'
      partial sums are all-reduced at once (Megatron's row-parallel
      product: left ``Partial``, every later reader would reduce it again).

    Left to DTensor, each product is placed by the cost of its inputs'
    moves alone: it partial-sums activations over ``data`` around FSDP
    weights, gathers weights whole under batch-sharded rows, and may shard
    a flattened (H·hd) that H does not divide, which no placement of (H,
    hd) can express."""
    if not isinstance(x, DTensor) and not isinstance(w, DTensor):
        if w.ndim == 2:
            return x @ w
        return (x @ w.reshape(w.shape[0], -1)).unflatten(-1, tuple(w.shape[1:]))
    from torch.distributed.tensor import Partial

    mesh = _mesh_of(x, w)
    x, w = reduce_partial(_as_dtensor(x, mesh)), _as_dtensor(w, mesh)
    last = x.ndim - 1
    dp = dp_axes(mesh)
    x_pl, w_pl, out_pl = [], [], []
    for name, xp, wp in zip(mesh.mesh_dim_names, x.placements, w.placements):
        if _row_sharded(xp, last) and (name in dp or type(wp) is not Shard):
            x_pl.append(xp), w_pl.append(Replicate()), out_pl.append(xp)
        elif type(wp) is Shard and wp.dim >= 1:
            x_pl.append(Replicate()), w_pl.append(wp), out_pl.append(Shard(last + wp.dim - 1))
        elif type(wp) is Shard:
            x_pl.append(Shard(last)), w_pl.append(wp), out_pl.append(Partial())
        else:
            x_pl.append(Replicate()), w_pl.append(Replicate()), out_pl.append(Replicate())

    def local(a, b):
        if b.ndim == 2:
            return a @ b
        return (a @ b.flatten(1)).unflatten(-1, tuple(b.shape[1:]))

    return reduce_partial(_shard_map(local, out_pl, (x_pl, w_pl), mesh, x, w))


def merge_heads(ctx: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """ctx (..., H, hd) @ wo (H, hd, d) → (..., d): the attention output
    projection, placed on DTensors as :func:`linear` places its products,
    the contraction running over (H, hd): where the weight's heads (or head
    size) are sharded, ctx takes the same sharding and the shards' partial
    sums are all-reduced."""
    if not isinstance(ctx, DTensor) and not isinstance(wo, DTensor):
        return ctx.flatten(-2) @ wo.flatten(0, 1)
    from torch.distributed.tensor import Partial

    mesh = _mesh_of(ctx, wo)
    ctx, wo = reduce_partial(_as_dtensor(ctx, mesh)), _as_dtensor(wo, mesh)
    n = ctx.ndim
    dp = dp_axes(mesh)
    c_pl, w_pl, out_pl = [], [], []
    for name, cp, wp in zip(mesh.mesh_dim_names, ctx.placements, wo.placements):
        if _row_sharded(cp, n - 2) and (name in dp or type(wp) is not Shard):
            c_pl.append(cp), w_pl.append(Replicate()), out_pl.append(cp)
        elif type(wp) is Shard and wp.dim in (0, 1):
            c_pl.append(Shard(n - 2 + wp.dim)), w_pl.append(wp), out_pl.append(Partial())
        elif type(wp) is Shard:
            c_pl.append(Replicate()), w_pl.append(wp), out_pl.append(Shard(n - 2))
        else:
            c_pl.append(Replicate()), w_pl.append(Replicate()), out_pl.append(Replicate())

    def local(a, b):
        return a.flatten(-2) @ b.flatten(0, 1)

    return reduce_partial(_shard_map(local, out_pl, (c_pl, w_pl), mesh, ctx, wo))


def by_batch_and_heads(fn: Callable, *tensors: torch.Tensor, n_out: int = 1, heads_out: int = 1):
    """``fn(*tensors)`` where ``fn`` treats every (batch, head) pair on its
    own: each tensor's first two dimensions are (B, H), and each of the
    ``n_out`` outputs has B first and H (or H's outer part, as in a
    flattened (H·hd)) at dimension ``heads_out`` (the mLSTM's chunks and
    cell).

    On DTensors each shard runs ``fn`` on its own rows and heads: the
    batch and head sharding of the first DTensor is kept and every other
    dimension gathered (the products inside contract over them).  Left to
    DTensor, a batched product of 4-D tensors flattens (B, H) with H
    sharded, which has no placement."""
    if not any(isinstance(t, DTensor) for t in tensors):
        return fn(*tensors)

    mesh = _mesh_of(*tensors)
    first = next(t for t in tensors if isinstance(t, DTensor))
    pl = [p if type(p) is Shard and p.dim in (0, 1) else Replicate() for p in first.placements]
    ins = [reduce_partial(_as_dtensor(t, mesh)) for t in tensors]
    one = [Shard(heads_out) if type(p) is Shard and p.dim == 1 else p for p in pl]
    out_pl = one if n_out == 1 else tuple([one] * n_out)
    return _shard_map(fn, out_pl, [pl for _ in ins], mesh, *ins)


def by_rows(fn: Callable, rows: tuple, whole: tuple = (), n_out: int = 1):
    """``fn(*rows, *whole)`` where ``fn`` treats each row (dimension 0 of
    every tensor of ``rows`` and of each of the ``n_out`` outputs) on its
    own and reads the tensors of ``whole`` (weights) entire: the sLSTM's
    recurrence, whose per-head product contracts a head's state with a
    weight sharded on another dimension.

    On DTensors each shard runs ``fn`` on its own rows: the row sharding
    of the first DTensor of ``rows`` is kept, everything else gathered."""
    if not any(isinstance(t, DTensor) for t in (*rows, *whole)):
        return fn(*rows, *whole)
    mesh = _mesh_of(*rows, *whole)
    first = next((t for t in rows if isinstance(t, DTensor)), None)
    keep = first.placements if first is not None else [Replicate()] * mesh.ndim
    pl = [p if type(p) is Shard and p.dim == 0 else Replicate() for p in keep]
    ins = [reduce_partial(_as_dtensor(t, mesh)) for t in (*rows, *whole)]
    out_pl = pl if n_out == 1 else tuple([pl] * n_out)
    return _shard_map(fn, out_pl, [pl] * len(rows) + [[Replicate()] * mesh.ndim] * len(whole),
                      mesh, *ins)


def by_rows_and_channels(fn: Callable, *tensors: torch.Tensor,
                         dims: tuple[tuple[int | None, int], ...],
                         out_dims: tuple[int, int]) -> torch.Tensor:
    """``fn(*tensors)`` where ``fn`` treats each row and each channel on its
    own: Mamba's causal depthwise convolution and its scan.  ``dims[i]`` is
    tensor i's (row dimension, or None for a weight, channel dimension),
    ``out_dims`` the output's.

    On DTensors each shard runs ``fn`` on its own rows and channels, as
    the first DTensor with rows is sharded over them; every other
    dimension is gathered."""
    if not any(isinstance(t, DTensor) for t in tensors):
        return fn(*tensors)
    mesh = _mesh_of(*tensors)
    ins = [reduce_partial(_as_dtensor(t, mesh)) for t in tensors]
    lead = next(i for i, t in enumerate(tensors) if isinstance(t, DTensor) and dims[i][0] is not None)
    in_pls = [[] for _ in ins]
    out_pl = []
    for p in ins[lead].placements:
        which = None
        if type(p) is Shard:
            which = [k for k in (0, 1) if dims[lead][k] == p.dim]
        if which:
            k = which[0]
            for pl, d in zip(in_pls, dims):
                pl.append(Replicate() if d[k] is None else Shard(d[k]))
            out_pl.append(Shard(out_dims[k]))
        else:
            for pl in in_pls:
                pl.append(Replicate())
            out_pl.append(Replicate())
    return _shard_map(fn, out_pl, in_pls, mesh, *ins)


def reduce_partial(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's ``Partial`` placements summed (all-reduced) to
    ``Replicate``; anything else as it is."""
    if isinstance(t, DTensor) and any(p.is_partial() for p in t.placements):
        return t.redistribute(t.device_mesh, [Replicate() if p.is_partial() else p
                                              for p in t.placements])
    return t


def like_experts(t: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The MoE's expert buffer ``t`` (E, C, d) laid out as the expert
    weight ``w`` (E, ...) is: experts sharded where ``w``'s are, whole
    elsewhere (its partial sums over the batch's shards reduced).  Left to
    DTensor, the buffer's capacity dimension may come out sharded under
    the sharded experts, and flattening (E, C) then needs a strided shard
    whose views DTensor sizes wrongly."""
    if not isinstance(t, DTensor) or not isinstance(w, DTensor):
        return t
    return t.redistribute(t.device_mesh, [Shard(0) if type(p) is Shard and p.dim == 0
                                          else Replicate() for p in w.placements])


def _shard_index(mesh, dims: list[int]) -> int:
    """This rank's index among the shards of a tensor dimension split over
    the mesh dimensions ``dims`` (the first the major)."""
    coord = mesh.get_coordinate()
    index = 0
    for i in dims:
        index = index * mesh.size(i) + coord[i]
    return index


def embedding(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``F.embedding(ids, table)``: the rows of ``table`` (N, d) at ``ids``.

    On a DTensor table whose rows are sharded (a vocabulary over
    ``model``), each shard looks up the ids in its range, gives zeros for
    the others, and the shards' sum is all-reduced where it is made (the
    reference's clamped ids are the caller's).  A table sharded over ``d``
    (FSDP) is gathered over that mesh dimension first; ids keep their batch
    sharding."""
    if not isinstance(table, DTensor):
        return F.embedding(ids, table)
    from torch.distributed.tensor import Partial

    mesh = table.device_mesh
    tab_pl = [Shard(0) if isinstance(p, Shard) and type(p) is Shard and p.dim == 0 else Replicate()
              for p in table.placements]
    vdims = [i for i, p in enumerate(tab_pl) if isinstance(p, Shard)]
    if not isinstance(ids, DTensor):
        ids = DTensor.from_local(ids, mesh, [Replicate()] * mesh.ndim, run_check=False)
    ids_pl = [p if i not in vdims and type(p) is Shard else Replicate()
              for i, p in enumerate(ids.placements)]
    out_pl = [Partial() if i in vdims else p for i, p in enumerate(ids_pl)]

    def local(tl, il):
        n = tl.shape[0]
        loc = il - _shard_index(mesh, vdims) * n
        valid = (loc >= 0) & (loc < n)
        rows = F.embedding(loc.clamp(0, n - 1), tl)
        return torch.where(valid[..., None], rows, torch.zeros((), dtype=rows.dtype, device=rows.device))

    return reduce_partial(_shard_map(local, out_pl, (tab_pl, ids_pl), mesh, reduce_partial(table), ids))


def write_slot(cache: torch.Tensor, slot: torch.Tensor, new: torch.Tensor) -> None:
    """``cache.index_copy_(2, slot, new)`` in place: a decode step's K or V
    (B, KV, 1, hd) into its slot of the (B, KV, S, hd) cache.

    Where the cache is a DTensor, ``new`` takes its placements and each
    shard writes its own part; a cache sharded over S (``long_500k``)
    writes only on the shard that holds the slot, which the others leave as
    it was."""
    if not isinstance(cache, DTensor):
        cache.index_copy_(2, slot, new)
        return
    mesh = cache.device_mesh
    sdims = [i for i, p in enumerate(cache.placements) if isinstance(p, Shard) and p.dim == 2]
    if not isinstance(new, DTensor):
        new = DTensor.from_local(new, mesh, [Replicate()] * mesh.ndim, run_check=False)
    keep = [Replicate() if i in sdims else p for i, p in enumerate(cache.placements)]
    local_new = new.redistribute(mesh, keep).to_local()
    local = cache.to_local()
    if isinstance(slot, DTensor):
        slot = slot.full_tensor()
    if not sdims:
        local.index_copy_(2, slot, local_new)
        return
    n = local.shape[2]
    at = slot - _shard_index(mesh, sdims) * n
    idx = at.clamp(0, n - 1)
    owns = (at >= 0) & (at < n)
    local.index_copy_(2, idx, torch.where(owns, local_new, local.index_select(2, idx)))


def _register_rules() -> None:
    """DTensor rules of aten operators the models reach with DTensors.

    ``index_add`` (the MoE dispatch into its expert buffer): besides
    replicated, and sharded on a dimension it does not index, the rows it
    adds may be sharded with their indices, and each shard adds its own into
    a ``Partial`` buffer (summed where it is next read), which DTensor has
    no rule for."""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import register_sharding

    R = Replicate()

    @register_sharding(torch.ops.aten.index_add.default)
    def _(self, dim, index, source, alpha=1):
        dim %= self.ndim
        return [
            ([R], [R, None, R, R]),
            *[([Shard(d)], [Shard(d), None, R, Shard(d)]) for d in range(self.ndim) if d != dim],
            ([Partial()], [Partial(), None, Shard(0), Shard(dim)]),
        ]


_register_rules()


# The tensor-parallel-only layout of a block's weights (the reference's
# ``blocks._tp_only_constraints``): with ``cfg.fsdp_weight_gather`` the
# block gathers each FSDP-sharded weight over ``data`` before using it.
_TP_ONLY = {
    "wq": Spec(None, "model", None),
    "wk": Spec(None, "model", None),
    "wv": Spec(None, "model", None),
    "wo": Spec("model", None, None),
    "w_gate": Spec(None, "model"),
    "w_up": Spec(None, "model"),
    "w_down": Spec("model", None),
}


def tp_only_layout(params: Any) -> Any:
    """The DTensor weights of a block's parameters redistributed to their
    tensor-parallel-only layout (an axis that does not divide ``model``
    stays replicated); plain tensors and other leaves as they are."""

    def rule(path, t):
        spec = _TP_ONLY.get(path[-1])
        if spec is None or not isinstance(t, DTensor) or len(spec) != t.ndim:
            return t
        mesh = t.device_mesh
        spec = Spec(*(_div(n, mesh, a) if a else None for n, a in zip(t.shape, spec)))
        return t.redistribute(mesh, to_placements(mesh, spec))

    return _map_with_path(rule, params)
