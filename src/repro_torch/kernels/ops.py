"""Public wrappers of the port's kernels, and the kernels as ``torch.library``
custom operators.

The device of the input decides the path, and nothing else: a tensor on
the CPU goes to the plain PyTorch version (:mod:`.ref`), which autograd
differentiates; a CUDA tensor goes to the operator ``repro_torch::<name>``,
whose CUDA implementation launches the hand-written Hopper kernel or
raises.  A meta tensor (the dry-run's shards) goes to the operator too,
whose fake implementation is its meta kernel.  There is no switch and no fallback from a failed build or launch
to the plain version.

Each of the seven attention, normalisation and gating kernels (four
forwards, three backwards) is an operator with

- its CUDA implementation: the kernel's launcher (:mod:`.flash_attention`,
  :mod:`.decode_attention`, :mod:`.rmsnorm`, :mod:`.moe_gating`), which
  counts the launches;
- a fake implementation giving the outputs' shapes and types, which is
  also its meta kernel: ``FakeTensorMode`` and meta tensors (the
  dry-run's shards) run the card's program without a card;
- for flash attention, RMSNorm and the gates, an autograd formula whose
  backward is the ``*_bwd`` operator; the decode kernel has none, and the
  wrapper refuses inputs that require grad;
- for both attention operators, a FLOP formula
  (``torch.utils.flop_counter``) that counts only the (query, key) pairs
  the masks keep;
- a DTensor sharding rule (:func:`_register_rules`): attention over the
  batch, or over the heads where the query and the KV heads both divide
  the mesh; RMSNorm and the gates over rows, where their input already
  is; else replicated.

Under no_grad (serving) the flash forward skips its log-sum-exp output,
as the raw kernel always did: its ``lse`` comes back (B, H, 0).

The float32 GEMM (``repro_torch::gemm``, :mod:`.gemm`) is routed by what its
inputs show rather than by the device alone: :func:`matmul` takes it for
CUDA float32 products that need no gradient and whose rows TMA can
address (:func:`.gemm.takes`), and the plain ``x @ w`` for everything else,
meta tensors included (the dry-run's products stay DTensor's own).  It has
a fake implementation and a FLOP formula, no autograd formula (a product
that needs a gradient never reaches it) and no sharding rule (it runs on
the local shards of :func:`repro_torch.models.sharding.linear`).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch import Tensor
from torch.utils.flop_counter import register_flop_formula

from . import _build
from . import decode_attention as _decode
from . import flash_attention as _flash
from . import gemm as _gemm
from . import moe_gating as _gating
from . import ref
from . import rmsnorm as _rmsnorm
from . import selective_scan as _scan

# Each kernel's launch counter: (module, attribute), by the name of its
# library (``_build.KERNELS``).
_COUNTERS = {
    "flash_attention": (_flash, "launches"),
    "decode_attention": (_decode, "launches"),
    "rmsnorm": (_rmsnorm, "launches"),
    "moe_gating": (_gating, "launches"),
    "flash_attention_bwd": (_flash, "backward_launches"),
    "rmsnorm_bwd": (_rmsnorm, "backward_launches"),
    "moe_gating_bwd": (_gating, "backward_launches"),
    "gemm": (_gemm, "launches"),
    "selective_scan": (_scan, "launches"),
}


def _route(t: torch.Tensor) -> str:
    """"cpu" for the plain version; "cuda" for the operator, as for a meta
    tensor (no data, as the dry-run's shards: the operator's fake
    implementation gives its outputs)."""
    if t.device.type == "cpu":
        return "cpu"
    if t.device.type in ("cuda", "meta"):
        return "cuda"
    raise ValueError(f"no kernel for tensors on {t.device}")


def _empty(shape, like: Tensor, dtype: torch.dtype | None = None) -> Tensor:
    return torch.empty(shape, dtype=dtype or like.dtype, device=like.device)


# ------------------------------------------------------- flash attention
@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(), device_types="cuda")
def _flash_op(q: Tensor, k: Tensor, v: Tensor, lengths: Tensor | None, causal: bool,
              window: int, softcap: float, need_lse: bool, prefix: int = 0) -> tuple[Tensor, Tensor]:
    if need_lse:
        return _flash.flash_attention_cuda(q, k, v, lengths, causal=causal, window=window,
                                           softcap=softcap, return_lse=True, prefix=prefix)
    out = _flash.flash_attention_cuda(q, k, v, lengths, causal=causal, window=window,
                                      softcap=softcap, prefix=prefix)
    return out, _empty(q.shape[:2] + (0,), q, torch.float32)


@_flash_op.register_fake
def _(q, k, v, lengths, causal, window, softcap, need_lse, prefix=0):
    b, h, s, _ = q.shape
    return _empty(q.shape, q), _empty((b, h, s if need_lse else 0), q, torch.float32)


@torch.library.custom_op("repro_torch::flash_attention_bwd", mutates_args=(), device_types="cuda")
def _flash_bwd_op(q: Tensor, k: Tensor, v: Tensor, out: Tensor, dout: Tensor, lse: Tensor,
                  lengths: Tensor | None, causal: bool, window: int,
                  softcap: float) -> tuple[Tensor, Tensor, Tensor]:
    return _flash.flash_attention_backward_cuda(q, k, v, out, dout, lse, lengths, causal=causal,
                                                window=window, softcap=softcap)


@_flash_bwd_op.register_fake
def _(q, k, v, out, dout, lse, lengths, causal, window, softcap):
    return _empty(q.shape, q), _empty(k.shape, k), _empty(v.shape, v)


def _flash_setup(ctx, inputs, output):
    q, k, v, lengths, causal, window, softcap, _, prefix = inputs
    out, lse = output
    ctx.save_for_backward(q, k, v, out, lse, lengths)
    ctx.opts = (causal, window, softcap)
    ctx.prefix = prefix


def _flash_backward(ctx, dout, dlse):
    del dlse
    if ctx.prefix:
        raise NotImplementedError("the flash backward kernel takes no prefix")
    q, k, v, out, lse, lengths = ctx.saved_tensors
    dq, dk, dv = _flash_bwd_op(q, k, v, out, dout, lse, lengths, *ctx.opts)
    return dq, dk, dv, None, None, None, None, None, None


_flash_op.register_autograd(_flash_backward, setup_context=_flash_setup)


# -------------------------------------------------------------- decode
@torch.library.custom_op("repro_torch::decode_attention", mutates_args=(), device_types="cuda")
def _decode_op(q: Tensor, k_cache: Tensor, v_cache: Tensor, valid_len: Tensor,
               softcap: float) -> Tensor:
    return _decode.decode_attention_cuda(q, k_cache, v_cache, valid_len, softcap=softcap)


@_decode_op.register_fake
def _(q, k_cache, v_cache, valid_len, softcap):
    return _empty(q.shape, q)


# -------------------------------------------------------------- rmsnorm
# The operators take x of any rank, normalised over its last dimension (the
# kernels see it as rows): a DTensor then keeps its batch sharding, where
# flattening (B, S) to rows first would tie it to B dividing the shards.
def _rows(t: Tensor) -> Tensor:
    return t.reshape(-1, t.shape[-1]).contiguous()


@torch.library.custom_op("repro_torch::rmsnorm", mutates_args=(), device_types="cuda")
def _rmsnorm_op(x: Tensor, scale: Tensor, eps: float) -> Tensor:
    return _rmsnorm.rmsnorm_cuda(_rows(x), scale, eps=eps).reshape(x.shape)


@_rmsnorm_op.register_fake
def _(x, scale, eps):
    return _empty(x.shape, x)


@torch.library.custom_op("repro_torch::rmsnorm_bwd", mutates_args=(), device_types="cuda")
def _rmsnorm_bwd_op(x: Tensor, scale: Tensor, dy: Tensor, eps: float) -> tuple[Tensor, Tensor]:
    dx, dscale = _rmsnorm.rmsnorm_backward_cuda(_rows(x), scale, _rows(dy), eps=eps)
    return dx.reshape(x.shape), dscale


@_rmsnorm_bwd_op.register_fake
def _(x, scale, dy, eps):
    return _empty(x.shape, x), _empty(scale.shape, scale)


def _rmsnorm_setup(ctx, inputs, output):
    x, scale, eps = inputs
    ctx.save_for_backward(x, scale)
    ctx.eps = eps


def _rmsnorm_backward(ctx, dy):
    x, scale = ctx.saved_tensors
    dx, dscale = _rmsnorm_bwd_op(x, scale, dy, ctx.eps)
    return dx, dscale, None


_rmsnorm_op.register_autograd(_rmsnorm_backward, setup_context=_rmsnorm_setup)


# --------------------------------------------------------------- gating
@torch.library.custom_op("repro_torch::moe_gating", mutates_args=(), device_types="cuda")
def _gating_op(logits: Tensor, top_k: int) -> tuple[Tensor, Tensor]:
    return _gating.moe_gating_cuda(logits, top_k)


@_gating_op.register_fake
def _(logits, top_k):
    t = logits.shape[0]
    return _empty((t, top_k), logits, torch.float32), _empty((t, top_k), logits, torch.int32)


@torch.library.custom_op("repro_torch::moe_gating_bwd", mutates_args=(), device_types="cuda")
def _gating_bwd_op(logits: Tensor, ids: Tensor, dgates: Tensor) -> Tensor:
    return _gating.moe_gating_backward_cuda(logits, ids, dgates)


@_gating_bwd_op.register_fake
def _(logits, ids, dgates):
    return _empty(logits.shape, logits)


def _gating_setup(ctx, inputs, output):
    logits, _ = inputs
    _, ids = output
    ctx.save_for_backward(logits, ids)
    ctx.mark_non_differentiable(ids)


def _gating_backward(ctx, dgates, dids):
    del dids
    logits, ids = ctx.saved_tensors
    return _gating_bwd_op(logits, ids, dgates), None


_gating_op.register_autograd(_gating_backward, setup_context=_gating_setup)


# ----------------------------------------------------------------- gemm
@torch.library.custom_op("repro_torch::gemm", mutates_args=(), device_types="cuda")
def _gemm_op(x: Tensor, w: Tensor) -> Tensor:
    return _gemm.gemm_cuda(x, w)


@_gemm_op.register_fake
def _(x, w):
    return _empty((x.shape[0], w.shape[1]), x)


# ------------------------------------------------------- selective scan
@torch.library.custom_op("repro_torch::selective_scan", mutates_args=(), device_types="cuda")
def _scan_op(x: Tensor, dt: Tensor, bm: Tensor, cm: Tensor, z: Tensor, a_log: Tensor,
             d_skip: Tensor, last_state: bool) -> tuple[Tensor, Tensor]:
    return _scan.selective_scan_cuda(x, dt, bm, cm, z, a_log, d_skip, last_state=last_state)


@_scan_op.register_fake
def _(x, dt, bm, cm, z, a_log, d_skip, last_state):
    b, _, e = x.shape
    return _empty(x.shape, x), _empty((b, e, a_log.shape[1]) if last_state else (0,), x)


# ------------------------------------------------------------ the FLOPs
def _lengths_or_full(lengths, b: int, s: int) -> np.ndarray:
    """Each row's length: its value where ``lengths`` holds data, ``s`` for
    every row where it is absent or a fake tensor (the dry-run)."""
    from torch._subclasses.fake_tensor import is_fake

    if lengths is None or is_fake(lengths) or lengths.device.type == "meta":
        return np.full(b, s, dtype=np.int64)
    return np.clip(lengths.detach().cpu().numpy().astype(np.int64), 0, s)


def flash_pairs(s: int, causal: bool, window: int, lengths, prefix: int = 0) -> np.ndarray:
    """The (query, key) pairs that the causal mask, the window (with the
    keys below ``prefix`` seen by every query) and each row's length keep,
    for each row of the batch: key j < length and, for query i, j <= i when
    causal and j > i - window or j < prefix when windowed."""
    i = np.arange(s)
    hi = i if causal else np.full(s, s - 1)
    lo = np.maximum(i - window + 1, 0) if window > 0 else np.zeros(s, dtype=np.int64)
    pre = np.minimum(lo, prefix) if window > 0 else np.zeros(s, dtype=np.int64)
    return np.array([(np.maximum(np.minimum(hi, n - 1) - lo + 1, 0)
                      + np.maximum(np.minimum(np.minimum(pre, n), hi + 1), 0)).sum() for n in lengths])


def flash_flops(q, k, lengths, causal: bool, window: int, prefix: int = 0) -> int:
    """The forward's FLOPs: q·k and p·v, 2·hd each, per kept pair and
    query head."""
    b, h, s, hd = q.shape
    pairs = flash_pairs(s, causal, window, _lengths_or_full(lengths, b, s), prefix)
    return int(4 * hd * h * pairs.sum())


@register_flop_formula(torch.ops.repro_torch.flash_attention, get_raw=True)
def _flash_flop(q, k, v, lengths, causal, window, softcap, need_lse, prefix=0, out_val=None, **_):
    return flash_flops(q, k, lengths, causal, window, prefix)


@register_flop_formula(torch.ops.repro_torch.flash_attention_bwd, get_raw=True)
def _flash_bwd_flop(q, k, v, out, dout, lse, lengths, causal, window, softcap, out_val=None, **_):
    # The backward recomputes q·k, then dp = dO·vᵀ, dv = pᵀ·dO, dq = ds·k
    # and dk = dsᵀ·q: five products for the forward's two.
    return 5 * flash_flops(q, k, lengths, causal, window) // 2


@register_flop_formula(torch.ops.repro_torch.decode_attention, get_raw=True)
def _decode_flop(q, k_cache, v_cache, valid_len, softcap, out_val=None, **_):
    b, h, hd = q.shape
    s = k_cache.shape[2]
    return int(4 * hd * h * _lengths_or_full(valid_len, b, s).sum())


@register_flop_formula(torch.ops.repro_torch.gemm, get_raw=True)
def _gemm_flop(x, w, out_val=None, **_):
    return _gemm.flops(x.shape[0], w.shape[1], x.shape[1])


# ------------------------------------------------------ sharding rules
def _even(op_spec) -> bool:
    """Whether every input of a candidate strategy splits evenly: a GQA
    layout sharded over heads is right only where the query heads and the
    KV heads both divide the number of shards."""
    for spec in op_spec.input_specs:
        meta = getattr(spec, "tensor_meta", None)
        if meta is None:
            continue
        shards = [1] * len(meta.shape)
        for mdim, p in enumerate(spec.placements):
            if p.is_shard():
                shards[p.dim] *= spec.mesh.size(mdim)
        if any(n % c for n, c in zip(meta.shape, shards)):
            return False
    return True


def _follows(proposed, now) -> bool:
    """Whether ``proposed`` shards only where the placements ``now`` do."""
    return all(not p.is_shard() or p == n for p, n in zip(proposed, now))


_RULES_REGISTERED = False


def _register_rules() -> None:
    """Register the DTensor sharding rule of each operator (once, at the
    first call on a CUDA tensor, real or fake: the CPU path never imports
    DTensor).  A rule
    lists, for one mesh dimension, the acceptable (outputs, inputs)
    placements; DTensor expands them over the mesh, and the candidates
    whose shards would be uneven are dropped.  An input placed otherwise is
    redistributed to the cheapest candidate."""
    global _RULES_REGISTERED
    if _RULES_REGISTERED:
        return
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    R = Replicate()

    def rule(op, follow=False):
        def wrap(fn):
            register_sharding(op)(fn)
            prop = DTensor._op_dispatcher.sharding_propagator
            inner = prop.op_strategy_funcs[op]

            def filtered(op_schema):
                strategy = inner(op_schema)
                now = op_schema.args_schema[0].strategies[0].output_spec.placements
                strategy.strategies = [
                    s for s in strategy.strategies
                    if _even(s) and (not follow or _follows(s.input_specs[0].placements, now))
                ]
                return strategy

            prop.op_strategy_funcs[op] = filtered
            return fn

        return wrap

    def opt(t, p):
        return None if t is None else p

    @rule(torch.ops.repro_torch.flash_attention.default)
    def _(q, k, v, lengths, causal, window, softcap, need_lse, prefix=0):
        rest = [None] * 5
        return [
            ([R, R], [R, R, R, opt(lengths, R), *rest]),
            ([Shard(0), Shard(0)], [Shard(0)] * 3 + [opt(lengths, Shard(0)), *rest]),
            ([Shard(1), Shard(1)], [Shard(1)] * 3 + [opt(lengths, R), *rest]),
        ]

    @rule(torch.ops.repro_torch.flash_attention_bwd.default)
    def _(q, k, v, out, dout, lse, lengths, causal, window, softcap):
        rest = [None] * 3
        return [
            ([R] * 3, [R] * 6 + [opt(lengths, R), *rest]),
            ([Shard(0)] * 3, [Shard(0)] * 6 + [opt(lengths, Shard(0)), *rest]),
            ([Shard(1)] * 3, [Shard(1)] * 6 + [opt(lengths, R), *rest]),
        ]

    @rule(torch.ops.repro_torch.decode_attention.default)
    def _(q, k_cache, v_cache, valid_len, softcap):
        return [
            ([R], [R, R, R, R, None]),
            ([Shard(0)], [Shard(0)] * 4 + [None]),
            ([Shard(1)], [Shard(1)] * 3 + [R, None]),
        ]

    # The row operators shard a leading dimension only where their input
    # already is (follow=True): DTensor would otherwise slice a replicated
    # input for free and hand the next product rows it must gather again.
    @rule(torch.ops.repro_torch.rmsnorm.default, follow=True)
    def _(x, scale, eps):
        rows = [([Shard(d)], [Shard(d), R, None]) for d in range(x.ndim - 1)]
        return [([R], [R, R, None]), *rows]

    @rule(torch.ops.repro_torch.rmsnorm_bwd.default, follow=True)
    def _(x, scale, dy, eps):
        rows = [([Shard(d), Partial()], [Shard(d), R, Shard(d), None]) for d in range(x.ndim - 1)]
        return [([R, R], [R, R, R, None]), *rows]

    @rule(torch.ops.repro_torch.moe_gating.default, follow=True)
    def _(logits, top_k):
        return [([R, R], [R, None]), ([Shard(0), Shard(0)], [Shard(0), None])]

    @rule(torch.ops.repro_torch.moe_gating_bwd.default, follow=True)
    def _(logits, ids, dgates):
        return [([R], [R, R, R]), ([Shard(0)], [Shard(0)] * 3)]

    _RULES_REGISTERED = True


# -------------------------------------------------------------- wrappers
def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lengths: torch.Tensor | None = None,
    *,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
    prefix: int = 0,
) -> torch.Tensor:
    """q: (B, H, S, hd); k, v: (B, KV, S, hd); lengths: (B,) int32 or None
    (every row has S keys); ``softcap > 0`` caps the scaled scores; with a
    ``window``, the keys below ``prefix`` stay visible to every query."""
    if _route(q) == "cpu":
        return ref.flash_attention_ref(
            q, k, v, causal=causal, lengths=lengths, window=window, softcap=softcap, prefix=prefix
        )
    _register_rules()
    out, _ = _flash_op(q, k, v, lengths, causal, int(window), float(softcap),
                       _build.needs_grad(q, k, v), int(prefix))
    return out


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    valid_len: torch.Tensor,
    *,
    softcap: float = 0.0,
) -> torch.Tensor:
    """q: (B, H, hd); caches: (B, KV, S, hd) of q's type, or bfloat16 under
    float32 queries; valid_len: (B,) int32; ``softcap > 0`` caps the scaled
    scores."""
    if _route(q) == "cpu":
        return ref.decode_attention_ref(q, k_cache, v_cache, valid_len, softcap=softcap)
    _build.refuse_autograd("decode_attention", q, k_cache, v_cache)
    _register_rules()
    return _decode_op(q, k_cache, v_cache, valid_len, float(softcap))


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """x: (..., d), flattened to rows; scale: (d,).  The default eps is the
    reference wrapper's (``repro.kernels.ops.rmsnorm``); the models pass
    their own 1e-5."""
    if _route(x) == "cpu":
        return ref.rmsnorm_ref(x.reshape(-1, x.shape[-1]), scale, eps).reshape(x.shape)
    _register_rules()
    return _rmsnorm_op(x, scale.float().contiguous(), float(eps))


def moe_gating(logits: torch.Tensor, top_k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """logits: (T, E) → (gates (T, k) float32, ids (T, k) int32)."""
    if _route(logits) == "cpu":
        return ref.moe_gating_ref(logits, top_k)
    _register_rules()
    return _gating_op(logits.contiguous(), int(top_k))


def selective_scan(x, dt, bm, cm, z, a_log, d_skip, *, last_state: bool = False):
    """Mamba's scan from h = 0: x, dt, z (B, S, E); bm, cm (B, S, N);
    a_log (E, N); d_skip (E,) → (y (B, S, E), the state after the last
    position (B, E, N) float32, or None without ``last_state``).  A CPU
    tensor takes the plain version; a CUDA tensor the kernel, which refuses
    what it does not take (:func:`.selective_scan.check_inputs`) and a
    gradient."""
    if _route(x) == "cpu":
        y, h = ref.selective_scan_ref(x, dt, bm, cm, z, a_log, d_skip)
        return y, (h if last_state else None)
    y, h = _scan_op(x, dt, bm, cm, z, a_log, d_skip, bool(last_state))
    return y, (h if last_state else None)


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., K) @ w (K, *N) → (..., *N): a product with a weight (2-D, or
    a head projection's (d, H, hd) or an output projection's flattened
    (H·hd, d)).  The GEMM kernel where :func:`.gemm.takes` the inputs, x's
    rows copied first where TMA cannot address them; else the plain
    product."""
    if not _gemm.takes(x, w):
        if w.dim() == 2:
            return x @ w
        return (x @ w.reshape(w.shape[0], -1)).unflatten(-1, tuple(w.shape[1:]))
    x2 = x.reshape(-1, x.shape[-1])
    if not _gemm.tma_rows(x2):
        x2 = x2.contiguous()
        if x2.data_ptr() % 16:
            x2 = x2.clone()
    w2 = _gemm.weight_2d(w)
    return _gemm_op(x2, w2).view(*x.shape[:-1], *w.shape[1:])


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`, by kernel
    (a ``*_bwd`` backward counts once a call, whatever it launches: flash's
    and RMSNorm's launch two kernels each).  A CUDA graph's replays count
    as their launches, its capture as none (:func:`captured_launches`)."""
    return {name: getattr(mod, attr) for name, (mod, attr) in _COUNTERS.items()}


def reset_launch_counts() -> None:
    for mod, attr in _COUNTERS.values():
        setattr(mod, attr, 0)


def add_launches(counts: dict[str, int]) -> None:
    """Add ``counts`` (by kernel) to the launch counters: what a CUDA graph's
    replay launches on the card without a call from the host."""
    for name, n in counts.items():
        mod, attr = _COUNTERS[name]
        setattr(mod, attr, getattr(mod, attr) + n)


@contextlib.contextmanager
def captured_launches():
    """Keep the launch counters to launches on the card across a CUDA graph
    capture: the wrappers' calls inside the block record kernels into the
    graph and launch nothing, so the counts they add are taken back on exit,
    also when the capture fails.  Yields a dict that then holds them by
    kernel, for :func:`add_launches` to add on each replay."""
    before = launch_counts()
    captured: dict[str, int] = {}
    try:
        yield captured
    finally:
        after = launch_counts()
        captured.update({name: after[name] - before[name] for name in after
                         if after[name] != before[name]})
        add_launches({name: -n for name, n in captured.items()})
