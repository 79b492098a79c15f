#!/usr/bin/env python3
"""Time versions of the flash-attention forward against each other, and probe
the current one, on one card.

    python3 scripts/flash_variants.py [LABEL=SOURCE ...] [--probe [ablate] [plans]]

Each SOURCE is a ``flash_attention.cu``: a path (the current one, or an
older one written out with ``git show <rev>:src/repro_torch/kernels/csrc/flash_attention.cu``),
or ``git:<rev>``, which this script writes out itself where the checkout is
a git repository.  Every library the script needs is built with the port's
nvcc flags into ``build/flash_variants/``, all at once.  A version runs
through the port's own wrapper, ``flash_attention.flash_attention_cuda``,
with its C entry point put in the place of the port's
(``flash_attention._entry``), so that ``ops.flash_attention`` and the
models run it too.  An older entry point, which plans its own launch, is
handed the shapes alone.

The versions, when given, are first held against the plain version at
every shape they are timed at (float32 to 1e-4, bf16 to 2e-2).  Then, in
turns (the order reversed every round: A B B A for two versions), each
runs at every shape of SHAPES (the kernel entries' flash shapes, causal) by
``kernel_table.time_ms`` (20 launches replayed in a CUDA graph), printed
beside SDPA's time on the same inputs (its keys repeated over the group)
and the tensor-core bound (``kernel_table.flash_tc_bound``).

``--models`` times, with each version in turns, the (8, 256) forward of
four models the port serves, each replayed as a CUDA graph (logits, no
gradient, weights in float32 from seed 0), and orloj_gpt's (1, 32) one
too (the shape nearest the serving profile's c0): orloj_gpt at full size,
GLM-4-9B at full depth and width (40 layers; ~38 GB, nothing else may
hold the card), Nemotron-4-340B at full width cut to one layer (~52 GB)
and MusicGen-large computing in bf16 (256 audio frames a row).

``--probe`` (with no names, both) probes the current source:

- ``ablate``: the kernel, and the kernel built again with its K/V tile
  loads taken out (``products``: the producer marks each stage full at
  once, and the split pass and products run on whatever the ring holds)
  or with its split pass and products taken out (``loads``: the tiles
  still land and are released), at ABLATE_SHAPES, each by
  ``kernel_table.time_ms``.  A variant computes garbage; only its time is
  read.  The edits are asserted to apply, so a changed source fails
  loudly;
- ``plans``: every plan that the launcher takes at PLAN_SHAPES (the wgmma
  route at 1 and 2 warpgroups and 2 to 4 stages, or the mma_sync route at
  2 and 4 warps, whichever is built there), timed by
  ``kernel_table.time_ms``, beside ``flash_plan``'s choice.

Prints the card first; writes the versions' rounds to
``build/flash_variants/runs.json``.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

import kernel_table  # noqa: E402  (beside this script; puts src/ on the path)

OUT_DIR = ROOT / "build" / "flash_variants"
SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
ROUNDS = 2
# (B, H, KV, S, hd, type, window): the kernel entries' flash shapes, causal.
SHAPES = (
    (8, 12, 12, 256, 64, "float32", 0),  # orloj_gpt's (8, 256) batch, the main path
    (8, 56, 8, 256, 128, "float32", 0),  # Arctic, g 7
    (8, 48, 8, 256, 128, "float32", 0),  # DBRX, g 6
    (8, 48, 1, 256, 128, "float32", 0),  # Granite-34B, g 48
    (8, 32, 2, 256, 128, "float32", 0),  # GLM-4-9B, g 16
    (4, 4, 4, 32, 16, "float32", 0),  # the engine-smoke toy
    (8, 96, 8, 256, 192, "float32", 0),  # Nemotron-4-340B, g 12
    (8, 25, 5, 256, 64, "float32", 1024),  # Hymba-1.5B, g 5
    (1, 25, 5, 2048, 64, "float32", 1024),  # Hymba past its window
    (8, 14, 2, 256, 64, "float32", 0),  # InternVL2-1B, g 7
    (8, 32, 32, 256, 64, "bfloat16", 0),  # MusicGen-large, which serves in bf16
    (8, 12, 12, 256, 64, "bfloat16", 0),  # orloj_gpt in bf16
    (8, 96, 8, 256, 192, "bfloat16", 0),  # Nemotron in bf16
    (2, 32, 2, 1024, 128, "float32", 0),  # T2: GLM-4-9B's training forward
    (8, 12, 12, 32, 64, "float32", 0),  # orloj_gpt's smallest bucket
    (8, 32, 2, 32, 128, "float32", 0),  # GLM-4-9B's smallest bucket
)
ABLATE_SHAPES = (
    (8, 12, 12, 256, 64, "float32", 0),
    (8, 32, 2, 256, 128, "float32", 0),
    (8, 56, 8, 256, 128, "float32", 0),
    (8, 32, 32, 256, 64, "bfloat16", 0),
    (8, 12, 12, 256, 64, "bfloat16", 0),
)
PLAN_SHAPES = (
    (8, 12, 12, 256, 64, "float32", 0),
    (8, 56, 8, 256, 128, "float32", 0),
    (8, 48, 8, 256, 128, "float32", 0),
    (8, 48, 1, 256, 128, "float32", 0),
    (8, 32, 2, 256, 128, "float32", 0),
    (4, 4, 4, 32, 16, "float32", 0),
    (8, 96, 8, 256, 192, "float32", 0),
    (8, 25, 5, 256, 64, "float32", 1024),
    (1, 25, 5, 2048, 64, "float32", 1024),
    (8, 14, 2, 256, 64, "float32", 0),
    (8, 32, 32, 256, 64, "bfloat16", 0),
    (8, 12, 12, 256, 64, "bfloat16", 0),
    (8, 96, 8, 256, 192, "bfloat16", 0),
    (2, 32, 2, 1024, 128, "float32", 0),
    (8, 12, 12, 32, 64, "float32", 0),
    (8, 32, 2, 32, 128, "float32", 0),
)
# The source edits of ``ablate``: (what to find, what to put), each found once.
ABLATIONS = {
    "products": [  # no K/V tile is loaded: each stage is marked full at once
        ("        mbar_expect_tx(full, 2 * L::kTileBytes);\n", "        mbar_arrive(full);\n"),
        ("          tma_load_4d(smem_addr(ks + c * BK * CB), &map_k, full, c * L::kChunkElems, k0, kvh, b);\n", ""),
        ("          tma_load_4d(smem_addr(ks + L::kTileBytes + c * BK * CB), &map_v, full, c * L::kChunkElems,\n"
         "                      k0, kvh, b);\n", ""),
    ],
    "loads": [  # the tiles land and are released unread; no split pass, no product
        ("          split_stage<HD>(stage0 + st * L::kStageBytes, sid, kSplitThreads);\n", ""),
        ("  if (slab_on && slab_end > k_begin) {\n", "  if (false) {\n"),
    ],
}


def read_source(spec: str) -> str:
    """A version's source text: a path, or ``git:<rev>`` (needs git)."""
    if spec.startswith("git:"):
        rev = spec[4:]
        return subprocess.run(["git", "show", f"{rev}:{SOURCE}"], cwd=ROOT, capture_output=True, text=True,
                              check=True).stdout
    return (ROOT / spec).resolve().read_text()


def build(sources: dict[str, str]) -> dict[str, Path]:
    """Each distinct source text built into its own library, all at once
    (labels with the same text share one)."""
    from repro_torch.kernels import _build

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs, first = {}, {}
    for label, text in sources.items():
        if text in first:
            continue
        first[text] = label
        src, lib = OUT_DIR / f"{label}.cu", OUT_DIR / f"lib{label}.so"
        src.write_text(text)
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}", "-o", str(lib), str(src)]
        procs[label] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for label, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed to build {label}:\n{out}")
        built[label] = lib
    return {label: built[first[text]] for label, text in sources.items()}


def entry(lib: Path, source: str):
    """The library's C entry point with the port's argument list: an older
    one without ``int prefix`` among its parameters is handed the rest, and
    one that takes no plan (no ``int route``) the shapes and the stream
    alone."""
    c_int, c_ll, c_ptr = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
    fn = ctypes.CDLL(str(lib)).flash_attention_launch
    fn.restype = c_int
    params = re.search(r"flash_attention_launch\(([^)]*)\)", source).group(1)
    prefix = "int prefix" in params
    head = [c_ptr] * 6 + [c_int] * 6 + [c_ll] * 9 + [c_int, c_int] + [c_int] * prefix + [ctypes.c_float]

    def taken(args):  # the port's arguments: ..., causal, window, prefix, softcap, ...
        return args if prefix else (*args[:23], *args[24:])

    if "int route" in params:
        fn.argtypes = head + [c_int] * 6 + [c_ll, c_ptr]
        return lambda *args: fn(*taken(args))
    fn.argtypes = head + [c_ptr]
    return lambda *args: fn(*taken(args)[:len(head)], args[-1])


def use(fn) -> None:
    """The port's wrapper launches ``fn`` from now on."""
    from repro_torch.kernels import flash_attention as fa

    fa._entry = lambda: fn


@contextlib.contextmanager
def planned(plan):
    """The port's wrapper launches ``plan`` while this holds."""
    from repro_torch.kernels import flash_attention as fa

    chosen = fa.flash_plan
    fa.flash_plan = lambda *args: plan
    try:
        yield
    finally:
        fa.flash_plan = chosen


def inputs(gen, shape):
    import torch

    b, h, kv, s, hd, dt, _ = shape
    q = kernel_table.randn(gen, (b, h, s, hd), getattr(torch, dt))
    k, v = (kernel_table.randn(gen, (b, kv, s, hd), getattr(torch, dt)) for _ in range(2))
    return q, k, v


def call(q, k, v, window):
    from repro_torch.kernels import flash_attention as fa

    return fa.flash_attention_cuda(q, k, v, window=window)


def plan_of(q, k, window):
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa

    b, h, s, hd = q.shape
    return fa.flash_plan(b, h, k.shape[1], s, hd, q.dtype, window, _build.sm_count(q.device))


def sdpa_ms(q, k, v, window) -> float:
    import torch
    import torch.nn.functional as F

    g = q.shape[1] // k.shape[1]
    kr, vr = (t.repeat_interleave(g, dim=1) for t in (k, v))
    s = q.shape[2]
    mask = None
    if window > 0:
        i, j = torch.arange(s, device="cuda")[:, None], torch.arange(s, device="cuda")[None, :]
        mask = (j <= i) & (j > i - window)
    return kernel_table.time_ms(lambda: F.scaled_dot_product_attention(q, kr, vr, attn_mask=mask,
                                                                     is_causal=mask is None))


def compare(fns: dict) -> None:
    import torch

    from repro_torch.kernels import ref

    gen = torch.Generator(device="cuda").manual_seed(0)
    args = {shape: inputs(gen, shape) for shape in SHAPES}
    for label, fn in fns.items():
        use(fn)
        for shape, (q, k, v) in args.items():
            out = call(q, k, v, shape[-1])
            want = ref.flash_attention_ref(q, k, v, window=shape[-1])
            err = (out.float() - want.float()).abs().max().item()
            if not err <= (2e-2 if shape[5] == "bfloat16" else 1e-4):
                raise SystemExit(f"{label} disagrees with the plain version at {shape}: {err:.3e}")
    print(f"every version agrees with the plain version at {len(SHAPES)} shapes", flush=True)
    labels = list(fns)
    runs = {label: {str(s): [] for s in SHAPES} for label in labels}
    for r in range(ROUNDS):
        for label in labels if r % 2 == 0 else labels[::-1]:
            use(fns[label])
            for shape, (q, k, v) in args.items():
                runs[label][str(shape)].append(kernel_table.time_ms(lambda q=q, k=k, v=v: call(q, k, v, shape[-1])))
    sdpa = {}
    for shape, (q, k, v) in args.items():
        sdpa[str(shape)] = sdpa_ms(q, k, v, shape[-1])
        tc, by = kernel_table.flash_tc_bound(q, k, None, True, shape[-1])
        plan = plan_of(q, k, shape[-1])
        for label in labels:
            ms = runs[label][str(shape)]
            med = statistics.median(ms)
            print(f"flash {shape} {label}: median {med:.6f} ms {[round(x, 6) for x in ms]}, SDPA "
                  f"{sdpa[str(shape)]:.6f} ms (/SDPA {med / sdpa[str(shape)]:.3f}), tc bound {tc:.6f} ms ({by}, "
                  f"/tc_bound {med / tc:.3f}); current plan {plan}", flush=True)
    out = OUT_DIR / "runs.json"
    out.write_text(json.dumps({"card": kernel_table.card_line(), "variants": labels, "runs": runs, "sdpa_ms": sdpa},
                              indent=1))
    print(f"every round's numbers: {out}", flush=True)


MODELS = (("orloj_gpt", (8, 256)), ("orloj_gpt", (1, 32)), ("glm4_9b", (8, 256)), ("nemotron_4_340b", (8, 256)),
          ("musicgen_large", (8, 256)))


def models(fns: dict) -> None:
    """Each model's forward at its (batch, sequence) of MODELS replayed as a
    CUDA graph, with each version in turns (A B B A)."""
    import dataclasses
    import gc

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import Model

    labels = list(fns)
    for name, (b, s) in MODELS:
        cfg = get_config(name)
        if name == "nemotron_4_340b":
            cfg = dataclasses.replace(cfg, n_layers=1)
        model = Model(cfg, device="cuda")
        params = model.init(torch.Generator(device="cuda").manual_seed(0))
        rng = np.random.default_rng(0)
        if cfg.frontend == "audio":
            batch = {"frontend_embeds": torch.from_numpy(rng.normal(size=(b, s, 512)).astype(np.float32)).cuda()}
        else:
            batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(b, s))).cuda()}

        def forward():
            with torch.no_grad():
                model.logits(params, batch)

        times = {label: [] for label in labels}
        for r in range(ROUNDS):
            for label in labels if r % 2 == 0 else labels[::-1]:
                use(fns[label])
                forward()
                times[label].append(kernel_table.time_ms(forward, reps=1, graphs=5))
        for label in labels:
            print(f"model {name} ({cfg.n_layers} layers) ({b},{s}) forward, replayed, {label}: median "
                  f"{statistics.median(times[label]):.4f} ms {[round(x, 4) for x in times[label]]}", flush=True)
        del model, params, batch
        gc.collect()
        torch.cuda.empty_cache()


def ablate(fns: dict) -> None:
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    for shape in ABLATE_SHAPES:
        q, k, v = inputs(gen, shape)
        ms = {}
        for label, fn in fns.items():
            use(fn)
            ms[label] = kernel_table.time_ms(lambda: call(q, k, v, shape[-1]))
        tc, by = kernel_table.flash_tc_bound(q, k, None, True, shape[-1])
        print(f"ablate {shape}: kernel {ms['kernel']:.6f} ms, its loads alone {ms['loads']:.6f}, its split and "
              f"products alone {ms['products']:.6f}; tc bound {tc:.6f} ms ({by}); plan {plan_of(q, k, shape[-1])}",
              flush=True)


def candidate_plans(shape) -> list:
    """Every plan the launcher takes at ``shape``: the mma_sync route at 2
    and 4 warps where it is built (float32 at head size 192), else the
    wgmma route at 1 and 2 warpgroups and 2 to 4 stages."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    b, h, kv, s, hd, dt, _ = shape
    dtype = getattr(torch, dt)
    if fa.mma_sync_faster(hd, dtype):
        return [fa.mma_sync_plan(h, kv, 32 if warps == 2 else 256, hd) for warps in (2, 4)]
    out = []
    for wgs in (1, 2):
        for stages in range(2, fa.MAX_STAGES + 1):
            plan = fa.wgmma_plan(b, h, kv, s, hd, dtype, 132, warpgroups=wgs, stages=stages)
            if plan is not None:
                out.append(plan)
    return out


def plans(fn) -> None:
    import torch

    use(fn)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for shape in PLAN_SHAPES:
        q, k, v = inputs(gen, shape)
        chosen = plan_of(q, k, shape[-1])
        times = []
        for plan in candidate_plans(shape):
            with planned(plan):
                times.append((kernel_table.time_ms(lambda: call(q, k, v, shape[-1])), plan))
        now = next(t for t, p in times if p == chosen)
        times.sort(key=lambda x: x[0])
        best = "; ".join(f"{t:.6f} ms ({p.route}, warps {p.warps}, stages {p.stages}, {p.heads}x{p.positions} rows)"
                         for t, p in times[:4])
        print(f"plans {shape}: flash_plan's ({chosen.route}, warps {chosen.warps}, stages {chosen.stages}) "
              f"{now:.6f} ms; fastest of {len(times)}: {best}", flush=True)


def main() -> int:
    import torch

    from repro_torch.kernels import _build

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("variants", nargs="*", metavar="LABEL=SOURCE")
    parser.add_argument("--probe", nargs="*", choices=("ablate", "plans"))
    parser.add_argument("--models", action="store_true", help="time four models' (8, 256) forward with each version")
    args = parser.parse_args()
    probes = ["ablate", "plans"] if args.probe == [] else args.probe or []
    if not args.variants and not probes:
        parser.error("give versions to compare, --probe, or both")
    if not torch.cuda.is_available():
        print("flash_variants: no CUDA device is visible", file=sys.stderr)
        return 2
    print(kernel_table.card_line(), flush=True)

    sources = {}
    for spec in args.variants:
        label, _, src = spec.partition("=")
        if not label or not src or label in ("kernel", *ABLATIONS):
            raise SystemExit(f"expected LABEL=SOURCE with a label other than the probes' own, got {spec!r}")
        sources[label] = read_source(src)
    current = (_build.CSRC / "flash_attention.cu").read_text()
    if probes:
        sources["kernel"] = current
    if "ablate" in probes:
        for label, edits in ABLATIONS.items():
            text = current
            for old, new in edits:
                if text.count(old) != 1:
                    raise SystemExit(f"the {label} ablation does not apply to this source: {old!r}")
                text = text.replace(old, new)
            sources[label] = text
    libs = build(sources)
    fns = {label: entry(libs[label], sources[label]) for label in sources}

    versions = {spec.partition("=")[0]: fns[spec.partition("=")[0]] for spec in args.variants}
    if args.variants:
        compare(versions)
    if args.models:
        models(versions)
    if "ablate" in probes:
        ablate({label: fns[label] for label in ("kernel", *ABLATIONS)})
    if "plans" in probes:
        plans(fns["kernel"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
