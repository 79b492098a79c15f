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
The step is eager: ``Model.loss``, ``torch.autograd.grad`` (through the
backward kernels on the card), then the in-place AdamW update.

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
    optimizer state, the step function and the data iterator after the
    last step, and each step's wall time and the data pipeline's share of
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
    train_step = make_train_step(model, opt_cfg)

    start = 0
    if ckpt_dir:
        got = latest_step(ckpt_dir)
        if got is not None:
            params = restore_checkpoint(ckpt_dir, got, params, cfg, shardings=specs, mesh=mesh)
            for p in leaves(params):
                p.requires_grad_(True)
            start = got
            print(f"restored step {got}")

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
