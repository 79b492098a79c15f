"""Serving entry point of the port: the paper's system end to end, with the
model executed by PyTorch and the hand-written Hopper kernels.

``python -m repro_torch.launch.serve --scheduler orloj --n 200``

Profiles the model's Eq.-3 latency curve on the card, generates a
length-skewed request trace (the paper's dynamic-NLP case), serves it with
the selected scheduler against measured execution, and reports the finish
rate.  Runs on the CUDA device; ``--device cpu`` runs the plain PyTorch
path instead.
"""

from __future__ import annotations

import argparse

import numpy as np

from ..configs import ARCHS, get_config
from ..core import (
    ClipperScheduler,
    ClockworkScheduler,
    EDFScheduler,
    EmpiricalDistribution,
    NexusScheduler,
    OrlojScheduler,
    SchedulerConfig,
)
from ..serving.engine import EngineConfig, TorchServingEngine


def make_scheduler(name: str, lm, hist, batch_sizes):
    warm = np.concatenate(list(hist.values()))
    if name == "orloj":
        dists = {
            app: EmpiricalDistribution.from_samples(xs, n_bins=12)
            for app, xs in hist.items()
            if len(xs) >= 2
        }
        return OrlojScheduler(
            lm, cfg=SchedulerConfig(batch_sizes=batch_sizes), initial_dists=dists
        )
    cls = {
        "clockwork": ClockworkScheduler,
        "nexus": NexusScheduler,
        "clipper": ClipperScheduler,
        "edf": EDFScheduler,
    }[name]
    return cls(lm, batch_sizes=batch_sizes, init_samples=warm)


def length_sampler(rng: np.random.Generator) -> int:
    """Bimodal prompt lengths: chat-style short prompts + long documents."""
    if rng.random() < 0.7:
        return int(np.clip(rng.normal(40, 12), 4, 256))
    return int(np.clip(rng.normal(200, 30), 4, 256))


def serve_config(arch: str):
    """The config the CLI serves: the reference CLI's size rule, which cuts
    an arch above 500 M parameters to ``reduced()`` with a vocabulary of at
    most 8192 (``repro.launch.serve``).  A full-width model is served by
    building :class:`TorchServingEngine` directly."""
    cfg = get_config(arch)
    if cfg.n_params_estimate > 500e6:
        cfg = cfg.reduced(vocab_size=min(cfg.vocab_size, 8192))
    return cfg


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="orloj_gpt", choices=ARCHS)
    ap.add_argument(
        "--scheduler",
        default="orloj",
        choices=["orloj", "clockwork", "nexus", "clipper", "edf", "all"],
    )
    ap.add_argument("--n", type=int, default=150)
    ap.add_argument("--slo-scale", type=float, default=3.0)
    ap.add_argument("--utilization", type=float, default=0.7)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    cfg = serve_config(args.arch)
    ecfg = EngineConfig()
    engine = TorchServingEngine(cfg, ecfg, seed=args.seed, device=args.device)
    print(f"profiling {cfg.name} latency curve on {engine.device} ...")
    lm = engine.profile_latency_model()
    print(f"Eq.3 fit: c0={lm.c0:.2f} ms, c1={lm.c1*1e3:.3f} ms/ktok")

    names = (
        ["orloj", "clockwork", "nexus", "clipper"]
        if args.scheduler == "all"
        else [args.scheduler]
    )
    for name in names:
        reqs, hist = engine.make_requests(
            args.n,
            lm,
            length_sampler=length_sampler,
            slo_scale=args.slo_scale,
            utilization=args.utilization,
            seed=args.seed,
        )
        sched = make_scheduler(name, lm, hist, ecfg.batch_sizes)
        res = engine.serve(reqs, sched)
        print(f"{name:10s} {res.summary()}")


if __name__ == "__main__":
    main()
