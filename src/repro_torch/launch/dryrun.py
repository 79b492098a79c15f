"""Dry-run of the port: place every (architecture × input shape × mesh) on
a production mesh and describe what each card of it would run, without
any card: its FLOPs, its bytes, its collective traffic and its memory.

The counterpart of :mod:`repro.launch.dryrun`, which lowers and compiles
each combination for a TPU pod and reads XLA's cost and memory analyses.
Here the mesh lies over a fake process group (:mod:`.mesh`); the
parameters (and for training the AdamW moments, under the parameter
specs), the batch and the cache are DTensors whose local shards are meta
tensors at their local shapes (:func:`repro_torch.models.sharding.place`);
and the reference's step runs on them eagerly:

- ``train``: ``Model.loss``, its backward and ``adamw_update``
  (:func:`repro_torch.launch.train.make_train_step`);
- ``prefill``: ``Model.prefill``;
- ``decode``: ``Model.decode_step``.

DTensor propagates the placements op by op and issues its collectives as
functional collectives; every operation on a local shard, the port's
kernels included (their fake implementations, through the custom
operators of :mod:`repro_torch.kernels.ops`), passes through
:class:`DeviceCounter`, which reads off what one card does:

- ``flops``: the FLOPs of the local operations
  (``torch.utils.flop_counter``'s formulas, the kernels' own);
- ``bytes_accessed``: each local operation's inputs read and outputs
  written once (views excluded);
- ``collective_bytes``: the result bytes of the collectives, by the
  reference's names (``all-reduce``, ``all-gather``, ``reduce-scatter``,
  ``all-to-all``, ``collective-permute``);
- ``per_device_memory``: ``argument_size_in_bytes`` (the local shards of
  the inputs), and from the live bytes of the storages the step makes,
  ``output_size_in_bytes`` (those the results hold), ``temp_size_in_bytes``
  and ``peak_memory_in_bytes`` (arguments plus the most ever live).
  Kernel scratch is not in it: the fake implementations allocate only the
  outputs (flash backward's (B, H, S) float32 row sums, RMSNorm backward's
  per-block partials of d floats);
- ``fits``: whether that peak fits :data:`HBM_BYTES`.

Local shards are meta tensors and not fake CUDA tensors: DTensor runs meta
shards on a mesh of any device type, and a PyTorch built without CUDA
cannot index a fake CUDA tensor (its Python indexing takes a CUDA device
guard).  The kernels' operators take meta tensors as they take fake ones.

``python -m repro_torch.launch.dryrun --arch glm4_9b --shape train_4k
--mesh single`` prints one row per combination and writes each result to
``build/dryrun/<arch>_<shape>_<mesh>.json``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import time
import traceback
import weakref
from pathlib import Path
from typing import Any, Callable

import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from ..configs import ARCHS, SHAPES, InputShape, for_shape, get_config
from ..models import Model
from ..models.config import ModelConfig
from ..models.sharding import (
    batch_logits_spec,
    cache_specs,
    input_batch_specs,
    param_specs,
    place,
    to_placements,
)
from ..optim import AdamWConfig, adamw_init
from ..optim.adamw import leaves
from .mesh import make_production_mesh, mesh_name
from .train import make_train_step

ART_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"
HBM_BYTES = 80e9  # one H100's device memory

# Functional collectives by the reference's names (HLO's).
_COLLECTIVE_NAMES = (
    ("all_reduce", "all-reduce"),
    ("all_gather", "all-gather"),
    ("reduce_scatter", "reduce-scatter"),
    ("all_to_all", "all-to-all"),
    ("alltoall", "all-to-all"),
    ("permute", "collective-permute"),
    ("broadcast", "collective-permute"),
)
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd", "c10d_functional",
                          "_dtensor")


def collective_kind(func) -> str | None:
    """The reference's name of the collective ``func`` issues, or None."""
    if func.namespace not in _COLLECTIVE_NAMESPACES:
        return None
    name = func.__name__
    return next((kind for key, kind in _COLLECTIVE_NAMES if key in name), None)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class DeviceCounter(TorchDispatchMode):
    """What one card of a mesh does: entered around a step on DTensors, it
    lets DTensor dispatch (an operation with DTensor arguments, and the
    fake tensors DTensor runs an operation on to learn its global output
    shape) and counts every operation on local tensors, which is what a
    card runs.

    ``flops``, ``bytes_accessed``, ``collective_bytes`` (by kind),
    ``collectives`` (each one: kind, the DTensor operator whose inputs it
    redistributes, result shape, bytes) and the
    live bytes of the storages that the counted operations make, with
    their peak (``peak_live``).  Storages of the arguments (``args``) are
    known before the step and are not counted as made by it."""

    def __init__(self, args: Any = ()):
        super().__init__()
        self.flops = 0
        self.bytes_accessed = 0
        self.collective_bytes: dict[str, float] = {}
        self.collectives: list[tuple[str, str, tuple, int]] = []
        self.live = 0
        self.peak_live = 0
        self._made: dict[int, tuple[weakref.ref, int]] = {}
        self._dtensor_op = ""
        self._known: set[int] = set()
        for t in tree_leaves(args):
            if isinstance(t, torch.Tensor):
                local = t.to_local() if isinstance(t, DTensor) else t
                self._known.add(id(local.untyped_storage()))

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._known or key in self._made:
            return
        n = st.nbytes()
        self._made[key] = (weakref.ref(st, lambda _, k=key: self._free(k)), n)
        self.live += n
        self.peak_live = max(self.peak_live, self.live)

    def _free(self, key: int) -> None:
        entry = self._made.pop(key, None)
        if entry is not None:
            self.live -= entry[1]

    def made_bytes(self, tree: Any) -> int:
        """The bytes of the storages that ``tree``'s tensors hold and the
        step made (each storage once)."""
        seen, total = set(), 0
        for t in tree_leaves(tree):
            if isinstance(t, torch.Tensor):
                local = t.to_local() if isinstance(t, DTensor) else t
                key = id(local.untyped_storage())
                if key in self._made and key not in seen:
                    seen.add(key)
                    total += self._made[key][1]
        return total

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, FakeTensor) for t in types):
            return func(*args, **kwargs)  # DTensor working out a global shape: no card's work
        if any(issubclass(t, DTensor) for t in types):
            self._dtensor_op = str(func)  # what the collectives that follow serve
            return NotImplemented
        out = func(*args, **kwargs)
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if any(isinstance(t, FakeTensor) for t in outs):
            return out  # a factory making DTensor's global-shape stand-ins
        kind = collective_kind(func)
        if kind is not None:
            n = sum(_nbytes(t) for t in outs)
            self.collective_bytes[kind] = self.collective_bytes.get(kind, 0.0) + float(n)
            self.collectives.append((kind, self._dtensor_op, tuple(outs[0].shape) if outs else (), n))
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += int(formula(*args, **kwargs, out_val=out))
        if not func.is_view:
            ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
            self.bytes_accessed += sum(_nbytes(t) for t in ins + outs)
        for t in outs:
            self._track(t)
        return out


# --------------------------------------------------------------- inputs
def _meta(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


def _tree_map(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def input_specs(cfg: ModelConfig, shape: InputShape, model: Model) -> dict:
    """Meta-tensor stand-ins (shapes and types, no data) for every model
    input, as the reference's ``input_specs``: a ``batch`` for train and
    prefill; ``tokens``, the bfloat16 ``cache`` (the port's per-layer
    list, KV caches in (B, KV, S, hd)) and ``pos`` for decode."""
    b, s = shape.global_batch, shape.seq_len
    f, i = torch.float32, torch.int32
    front = cfg.n_frontend_tokens

    def sd(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    if shape.kind in ("train", "prefill"):
        batch: dict = {}
        if cfg.frontend == "audio":
            batch["frontend_embeds"] = sd((b, s, model.frontend_dim), f)
        elif cfg.frontend == "vision":
            batch["frontend_embeds"] = sd((b, front, model.frontend_dim), f)
            batch["tokens"] = sd((b, s - front), i)
        else:
            batch["tokens"] = sd((b, s), i)
        if shape.kind == "train":
            batch["labels"] = sd((b, s), i)
        return {"batch": batch}
    tok = sd((b, 1, model.frontend_dim), f) if cfg.frontend == "audio" else sd((b, 1), i)
    with FakeTensorMode():
        cache = model.init_cache(b, cache_len=s, dtype=torch.bfloat16)
    return {"tokens": tok, "cache": _tree_map(_meta, cache), "pos": sd((), i)}


def param_shapes(model: Model) -> Any:
    """The model's parameters as meta tensors of their global shapes, drawn
    without memory (under ``FakeTensorMode``)."""
    with FakeTensorMode():
        params = model.init(torch.Generator(device=model.device).manual_seed(0))
    return _tree_map(_meta, params)


# ------------------------------------------------------------ dry runs
@dataclasses.dataclass
class DryRunResult:
    arch: str
    shape: str
    mesh: str
    ok: bool
    seconds: float
    flops: float = 0.0
    bytes_accessed: float = 0.0
    collective_bytes: dict = dataclasses.field(default_factory=dict)
    per_device_memory: dict = dataclasses.field(default_factory=dict)
    error: str = ""
    n_params: int = 0
    # The reference adds a scanned body's cost (L - 1) times over; the port
    # runs its layers as a Python loop, every layer counted, so these equal
    # the raw fields (see run_with_correction).
    flops_corrected: float = 0.0
    bytes_corrected: float = 0.0
    collective_corrected: dict = dataclasses.field(default_factory=dict)
    n_layers: int = 0
    scanned: bool = False
    fits: bool = False  # the peak within HBM_BYTES

    def row(self) -> str:
        st = "OK " if self.ok else "FAIL"
        peak = self.per_device_memory.get("peak_memory_in_bytes", 0) / 1e9
        return (
            f"{self.arch:18s} {self.shape:12s} {self.mesh:10s} {st} "
            f"{self.seconds:7.1f}s flops={self.flops:.3e} "
            f"coll={sum(self.collective_bytes.values()):.3e}B "
            f"peak={peak:.2f}GB {'fits' if self.fits else 'DOES NOT FIT'} 80GB"
        )


def _logits_placement(out, cfg: ModelConfig, mesh, global_batch: int):
    """The logits in the reference's output sharding (batch over (pod,
    data), vocabulary over ``model``), as its ``out_shardings`` asks."""
    spec = batch_logits_spec(cfg, mesh, global_batch)
    return out.redistribute(mesh, to_placements(mesh, spec))


def dry_run(
    cfg: ModelConfig,
    shape: InputShape,
    mesh,
    *,
    arch: str = "",
    decode_cache_layout: str = "",
    moe_ff_axis: str = "",
    serve_params_bf16: bool = False,
) -> tuple[DryRunResult, DeviceCounter | None]:
    """Run ``cfg``'s step of ``shape`` on the device mesh ``mesh`` (fake or
    real: the shards are meta tensors, nothing runs on a device) and return
    its result and the counter of one card's work."""
    # DTensor warns of every Partial reduced over two mesh dimensions in
    # turn; the dry-run counts those collectives and says nothing more.
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)
    model = Model(cfg, device="cpu")
    t0 = time.perf_counter()
    res = DryRunResult(arch=arch or cfg.name, shape=shape.name, mesh=mesh_name(mesh),
                       ok=False, seconds=0)
    counter = None
    try:
        params = param_shapes(model)
        if serve_params_bf16 and shape.kind != "train":
            params = _tree_map(
                lambda t: t.to(torch.bfloat16) if t.dtype == torch.float32 else t, params)
        res.n_params = sum(t.numel() for t in leaves(params))
        p = place(params, mesh, param_specs(cfg, params, mesh, moe_ff_axis=moe_ff_axis or None))
        ins = input_specs(cfg, shape, model)
        b = shape.global_batch
        with implicit_replication():
            if shape.kind == "train":
                for t in leaves(p):
                    t.requires_grad_(True)
                opt = adamw_init(p)
                batch = place(ins["batch"], mesh, input_batch_specs(cfg, mesh, ins["batch"], b))
                args = (p, opt, batch)
                step = make_train_step(model, AdamWConfig())
                counter = DeviceCounter(args)
                with counter:
                    out = step(*args)
            elif shape.kind == "prefill":
                batch = place(ins["batch"], mesh, input_batch_specs(cfg, mesh, ins["batch"], b))
                args = (p, batch)
                counter = DeviceCounter(args)
                with counter, torch.no_grad():
                    logits, _ = model.prefill(p, batch, cache_len=shape.seq_len)
                    out = _logits_placement(logits, cfg, mesh, b)
            else:
                seq_shard, seq_axis = shape.name == "long_500k", "data"
                if decode_cache_layout == "seq_model":
                    seq_shard, seq_axis = True, "model"
                elif decode_cache_layout == "seq_data":
                    seq_shard, seq_axis = True, "data"
                elif decode_cache_layout == "batch":
                    seq_shard = False
                cache = place(ins["cache"], mesh,
                              cache_specs(cfg, mesh, ins["cache"], b, seq_shard, seq_axis))
                tok = {"tokens": ins["tokens"]}
                tokens = place(tok, mesh, input_batch_specs(cfg, mesh, tok, b))["tokens"]
                args = (p, tokens, cache)
                counter = DeviceCounter(args)
                with counter, torch.no_grad():
                    logits, cache = model.decode_step(p, tokens, cache, ins["pos"])
                    out = (_logits_placement(logits, cfg, mesh, b), cache)
        arg_bytes = sum(_local_bytes(t) for t in tree_leaves(args))
        out_bytes = counter.made_bytes(out)
        res.per_device_memory = {
            "argument_size_in_bytes": arg_bytes,
            "output_size_in_bytes": out_bytes,
            "temp_size_in_bytes": max(counter.peak_live - out_bytes, 0),
            "peak_memory_in_bytes": arg_bytes + counter.peak_live,
        }
        res.flops = float(counter.flops)
        res.bytes_accessed = float(counter.bytes_accessed)
        res.collective_bytes = dict(counter.collective_bytes)
        res.fits = res.per_device_memory["peak_memory_in_bytes"] <= HBM_BYTES
        res.n_layers = cfg.n_layers
        _fill_corrected(res)
        res.ok = True
    except Exception:
        res.error = traceback.format_exc()[-4000:]
    res.seconds = time.perf_counter() - t0
    return res, counter


def _local_bytes(t) -> int:
    if not isinstance(t, torch.Tensor):
        return 0
    return _nbytes(t.to_local() if isinstance(t, DTensor) else t)


def run_one(
    arch: str,
    shape_name: str,
    multi_pod: bool,
    keep_collectives: bool = False,
    save: bool = True,
    cfg_override=None,
    tag: str = "",
    decode_cache_layout: str = "",
    moe_ff_axis: str = "",
    serve_params_bf16: bool = False,
) -> DryRunResult:
    """One (arch × shape) on the 16×16 (or, ``multi_pod``, the 2×16×16)
    production mesh.  ``keep_collectives`` writes every collective one card
    issues to ``<stem>.collectives.txt`` (in place of the reference's
    ``keep_hlo``)."""
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    cfg = for_shape(get_config(arch), shape)
    if cfg_override:
        cfg = dataclasses.replace(cfg, **cfg_override)
    res, counter = dry_run(cfg, shape, mesh, arch=arch, decode_cache_layout=decode_cache_layout,
                           moe_ff_axis=moe_ff_axis, serve_params_bf16=serve_params_bf16)
    stem = f"{arch}_{shape_name}_{res.mesh}" + (f"_{tag}" if tag else "")
    if keep_collectives and counter is not None:
        ART_DIR.mkdir(parents=True, exist_ok=True)
        lines = [f"{k}\t{op}\t{list(shp)}\t{n}" for k, op, shp, n in counter.collectives]
        (ART_DIR / f"{stem}.collectives.txt").write_text("\n".join(lines) + "\n")
    _save(res, save, stem)
    return res


def _fill_corrected(res: DryRunResult) -> None:
    res.flops_corrected = res.flops
    res.bytes_corrected = res.bytes_accessed
    res.collective_corrected = dict(res.collective_bytes)
    res.scanned = False


def run_with_correction(
    arch: str,
    shape_name: str,
    multi_pod: bool,
    l0: int = 3,
    keep_collectives: bool = False,
    save: bool = True,
    tag: str = "",
    **kw,
) -> DryRunResult:
    """The reference's full dry-run plus its scan-FLOP correction.  XLA's
    cost analysis counts a ``lax.scan`` body once, so the reference adds
    the body's cost (L - 1) times, measured from an L0-layer pair of
    compiles.  The port runs its layers as a Python loop and counts every
    layer's operations, so there is nothing to add: this is
    :func:`run_one`, with the ``*_corrected`` fields equal to the raw ones
    (``l0`` is accepted and unused)."""
    del l0
    return run_one(arch, shape_name, multi_pod, keep_collectives=keep_collectives, save=save,
                   tag=tag, **kw)


def _save(res: DryRunResult, save: bool, stem: str) -> None:
    if not save:
        return
    ART_DIR.mkdir(parents=True, exist_ok=True)
    (ART_DIR / f"{stem}.json").write_text(json.dumps(dataclasses.asdict(res), indent=2))


def _run_combo(job: tuple) -> dict:
    arch, shape, multi, keep = job
    r = run_one(arch, shape, multi, keep_collectives=keep)
    return dataclasses.asdict(r)


def main(argv: list[str] | None = None) -> list[DryRunResult]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all", help="shape id or 'all'")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--keep-collectives", action="store_true",
                    help="write each collective one card issues next to the result")
    ap.add_argument("--fast", action="store_true",
                    help="accepted for the reference's CLI: the port has no scan correction")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--workers", type=int, default=1,
                    help="combinations run in this many processes at once")
    args = ap.parse_args(argv)

    archs = [a for a in ARCHS if a != "orloj_gpt"] if args.arch == "all" else [
        args.arch.replace("-", "_")
    ]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    jobs = []
    for arch in archs:
        for shape in shapes:
            for multi in meshes:
                if args.skip_existing:
                    p = ART_DIR / f"{arch}_{shape}_{'2x16x16' if multi else '16x16'}.json"
                    if p.exists() and json.loads(p.read_text()).get("ok"):
                        print(f"skip {p.stem} (cached)", flush=True)
                        continue
                jobs.append((arch, shape, multi, args.keep_collectives))

    results = []

    def report(d: dict) -> None:
        r = DryRunResult(**d)
        print(r.row(), flush=True)
        if not r.ok:
            print(r.error, flush=True)
        results.append(r)

    if args.workers > 1:
        import multiprocessing as mp

        # Each process holds its own fake process group.
        with mp.get_context("spawn").Pool(args.workers, maxtasksperchild=1) as pool:
            for d in pool.imap_unordered(_run_combo, jobs):
                report(d)
    else:
        for job in jobs:
            report(_run_combo(job))
    n_ok = sum(r.ok for r in results)
    print(f"\n{n_ok}/{len(results)} dry-runs OK")
    if n_ok != len(results):
        raise SystemExit(1)
    return results


if __name__ == "__main__":
    main()
