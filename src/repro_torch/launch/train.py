"""Training entry point of the port: ``python -m repro_torch.launch.train
--arch olmo_1b --steps 50``.

The counterpart of :mod:`repro.launch.train`, with its flags and its
lines: config → model → data pipeline → AdamW → checkpoints.  Without
``--full`` it trains the arch's ``reduced()`` variant with a vocabulary of
at most 8192, as the reference does.  It runs on the card (``--device
cuda``, the default, raises without one); ``--device cpu`` runs the plain
PyTorch path.  As the reference, it lays the parameters and the batches
out on the debug mesh by ``param_specs`` and the batch spec, and its
header names the mesh: launched as one process per card (``torchrun``,
which sets up the process group), the parameters and batches are
DTensors on :func:`.mesh.make_debug_mesh`; in a process of its own it
has one device, the (1, 1) mesh, on which every spec resolves to
``None``, so the loop keeps plain tensors and builds no process group.
A step is ``Model.loss``, ``torch.autograd.grad`` (through the backward
kernels on the card), then the in-place AdamW update
(:func:`make_train_step`).  On one device the loop runs it as a
:class:`TrainProgram`, the counterpart of the reference's ``@jax.jit``
step: on the card the first step runs eagerly and every later one
replays a CUDA graph of the same step.  The multi-process DTensor step
runs eagerly: its collectives are not captured.

A restore from ``--ckpt-dir`` resumes the parameters only, with a fresh
optimizer state and the data stream from its start, as the reference's
does.  :func:`train` is the body of :func:`main`, for callers that train
without a subprocess.
"""

from __future__ import annotations

import argparse
import time
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from ..checkpoint import latest_step, restore_checkpoint, save_checkpoint
from ..configs import get_config
from ..data import DataConfig, make_train_iterator
from ..device import resolve_device
from ..kernels import ops
from ..models import Model
from ..models.config import ModelConfig
from ..models.sharding import param_specs, place
from ..optim import AdamWConfig, adamw_init, adamw_update
from ..optim.adamw import leaves
from .mesh import make_debug_mesh


def make_train_step(model: Model, opt_cfg: AdamWConfig):
    """``step(params, opt_state, batch) -> (params, opt_state, loss)``: the
    loss and its gradient with respect to every leaf of ``params`` (zeros
    for a leaf the loss does not reach, as ``jax.value_and_grad`` gives),
    then one AdamW update in place."""

    def train_step(params, opt_state, batch):
        flat = leaves(params)
        loss = model.loss(params, batch)
        grads = torch.autograd.grad(loss, flat, allow_unused=True, materialize_grads=True)
        params, opt_state = adamw_update(opt_cfg, params, list(grads), opt_state)
        return params, opt_state, loss.detach()

    return train_step


class TrainProgram:
    """The train step as one program, the counterpart of the reference's
    ``@jax.jit`` step: ``program(params, opt_state, batch) -> (params,
    opt_state, loss)``, as :func:`make_train_step`'s step, over the
    ``params`` and ``opt_state`` it was built with (other trees raise: a
    graph reads the tensors it captured) and batches of ``shape``.

    Each call copies the batch into static int64 ``tokens`` and ``labels``
    buffers and runs :func:`make_train_step`'s body on them.  On a CUDA
    device the first call runs the body eagerly on the program's stream
    (step 1 of the run, which also loads the kernels and gives cuBLAS its
    workspace), then captures the same body into a CUDA graph whose memory
    comes from the program's own pool; every later call replays the graph
    and returns the graph's static loss, which the next replay overwrites.
    The state's tensors are updated in place, ``step`` included, so the
    replays go through the same parameter states as an eager loop.  The
    capture's kernel calls launch nothing: their launch counts are taken
    back and added again at each replay (:func:`ops.captured_launches`).  A
    capture that fails raises; nothing runs eagerly in its place.  On the
    CPU every call runs the body eagerly."""

    def __init__(self, model: Model, opt_cfg: AdamWConfig, params, opt_state: dict,
                 shape: tuple[int, int]):
        self.params, self.opt_state = params, opt_state
        self.device = model.device
        self.body = make_train_step(model, opt_cfg)
        self.tokens = torch.zeros(shape, dtype=torch.int64, device=self.device)
        self.labels = torch.zeros(shape, dtype=torch.int64, device=self.device)
        self.graph = None
        if self.device.type == "cuda":
            self.stream = torch.cuda.Stream(self.device)
            self.pool = torch.cuda.graph_pool_handle()

    def _step(self) -> torch.Tensor:
        _, _, loss = self.body(self.params, self.opt_state, {"tokens": self.tokens, "labels": self.labels})
        return loss

    def __call__(self, params, opt_state: dict, batch: dict[str, torch.Tensor]):
        if params is not self.params or opt_state is not self.opt_state:
            raise ValueError("a TrainProgram steps the parameters and optimizer state it was built with")
        self.tokens.copy_(batch["tokens"])
        self.labels.copy_(batch["labels"])
        if self.device.type != "cuda":
            return params, opt_state, self._step()
        caller = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(caller)
        if self.graph is None:
            loss = self._capture()
        else:
            with torch.cuda.stream(self.stream):
                self.graph.replay()
            ops.add_launches(self.launches)
            loss = self.loss
        caller.wait_stream(self.stream)
        return params, opt_state, loss

    def _capture(self) -> torch.Tensor:
        """Step 1 eagerly on the stream, then the capture of the step."""
        with torch.cuda.stream(self.stream):
            loss = self._step()
        self.stream.synchronize()
        torch.cuda.empty_cache()  # the eager step's cached blocks, beside the graph's pool
        graph = torch.cuda.CUDAGraph()
        with ops.captured_launches() as self.launches, torch.cuda.graph(
            graph, pool=self.pool, stream=self.stream
        ):
            self.loss = self._step()
        self.graph = graph
        return loss


def _device_name(dev: torch.device) -> str:
    if dev.type == "cuda" and dev.index is None:
        return f"cuda:{torch.cuda.current_device()}"
    return str(dev)


def train(
    cfg: ModelConfig,
    *,
    steps: int = 50,
    batch: int = 8,
    seq: int = 256,
    lr: float = 3e-4,
    ckpt_dir: str = "",
    log_every: int = 10,
    device: str | torch.device = "cuda",
    record: dict[str, Any] | None = None,
) -> list[float]:
    """Train ``cfg`` for ``steps`` steps and return each step's loss.  With a
    ``record`` dict, also leaves there the model, the parameters, the
    optimizer state, the step function (a :class:`TrainProgram` on one
    device) and the data iterator after the last step, and each step's wall time and the data pipeline's share of
    it (``step_ms``, ``data_ms``: host clock, the step ending in the
    loss's read-back)."""
    if cfg.frontend:
        raise SystemExit(f"{cfg.name} needs frontend embeddings; use the dry-run or serve driver")
    dev = resolve_device(device)
    model = Model(cfg, device=dev)
    multi = dist.is_initialized() and dist.get_world_size() > 1
    mesh = make_debug_mesh(device_type=dev.type) if multi else None
    axes = dict(zip(mesh.mesh_dim_names, mesh.shape)) if mesh else {"data": 1, "model": 1}
    print(f"arch={cfg.name} params≈{cfg.n_params_estimate/1e6:.1f}M mesh={axes} "
          f"device={_device_name(dev)}")

    params = model.init(torch.Generator(device=dev).manual_seed(0))
    specs = param_specs(cfg, params, mesh) if mesh else None
    if mesh:
        params = place(params, mesh, specs)
    for p in leaves(params):
        p.requires_grad_(True)
    opt_cfg = AdamWConfig(lr=lr, total_steps=steps, warmup_steps=max(steps // 10, 1))
    opt_state = adamw_init(params)

    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, batch_size=batch)
    it = make_train_iterator(data_cfg, dev, mesh=mesh)

    start = 0
    if ckpt_dir:
        got = latest_step(ckpt_dir)
        if got is not None:
            params = restore_checkpoint(ckpt_dir, got, params, cfg, shardings=specs, mesh=mesh)
            for p in leaves(params):
                p.requires_grad_(True)
            start = got
            print(f"restored step {got}")
    if mesh is None:  # built over the restored parameters
        train_step = TrainProgram(model, opt_cfg, params, opt_state, (batch, seq))
    else:
        train_step = make_train_step(model, opt_cfg)

    losses: list[float] = []
    step_ms: list[float] = []
    data_ms: list[float] = []
    t0 = time.time()
    for step in range(start, steps):
        t_step = time.perf_counter()
        b = next(it)
        data_ms.append((time.perf_counter() - t_step) * 1e3)
        params, opt_state, loss = train_step(params, opt_state, b)
        losses.append(float(loss))
        step_ms.append((time.perf_counter() - t_step) * 1e3)
        if (step + 1) % log_every == 0:
            dt = (time.time() - t0) / log_every
            print(f"step {step+1:5d} loss {np.mean(losses[-log_every:]):.4f} {dt*1e3:.0f} ms/step")
            t0 = time.time()
        if ckpt_dir and (step + 1) % 100 == 0:
            save_checkpoint(ckpt_dir, step + 1, params, cfg)

    if ckpt_dir:
        save_checkpoint(ckpt_dir, steps, params, cfg)
    first = np.mean(losses[: max(len(losses) // 5, 1)])
    last = np.mean(losses[-max(len(losses) // 5, 1) :])
    print(f"loss {first:.4f} → {last:.4f} ({'improved' if last < first else 'NOT improved'})")
    if record is not None:
        record.update(model=model, params=params, opt_state=opt_state, train_step=train_step,
                      iterator=it, step_ms=step_ms, data_ms=data_ms)
    return losses


def main(argv: list[str] | None = None) -> list[float]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="orloj_gpt")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--full", action="store_true", help="full (non-reduced) config")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced(vocab_size=min(cfg.vocab_size, 8192))
    return train(cfg, steps=args.steps, batch=args.batch, seq=args.seq, lr=args.lr,
                 ckpt_dir=args.ckpt_dir, log_every=args.log_every, device=args.device)


if __name__ == "__main__":
    main()
