#!/usr/bin/env python3
"""Time versions of the decode-attention kernel against each other, and probe
the current one, on one card.

    python3 scripts/decode_variants.py [LABEL=SOURCE ...] [--probe [clusters] [ablate] [plans]]

Each SOURCE is a ``decode_attention.cu`` (the current one, or an older one
written out with ``git show <commit>:src/repro_torch/kernels/csrc/decode_attention.cu``).
Every library this script needs is built with the port's nvcc flags into
``build/decode_variants/``, all at once.  A version runs through the port's
own wrapper, ``decode_attention.decode_attention_cuda``, with its C entry
point put in the place of the port's (``decode_attention._entry``), so
that ``ops.decode_attention`` and the models' decode step run it too.  An
older entry point, which plans its own launch, is handed the shapes alone.

The versions, when given, are first held against the plain version at
every shape they are timed at (float32 queries to 1e-4, bf16 ones to
2e-2).  Then, in turns (the order reversed every round: A B B A for two
versions):

- the kernel at each shape of SHAPES, every cache slot valid, by
  ``kernel_table.time_ms`` (20 launches replayed in a CUDA graph), beside its
  bound on its route (``kernel_table.decode_bound``);
- GLM-4-9B's decode step at full depth and width (40 layers, float32
  weights from seed 0) at B 8 over its default bf16 cache at decode_32k's
  32,768 slots, every slot valid: the median of 15 eager steps on the
  host's clock to a synchronise, and the step replayed as a CUDA graph,
  beside the bytes a step must move (``kernel_table.decode_steps``'s
  bound).

``--probe`` (with no names, all three) probes the current source:

- ``clusters``: how many thread-block clusters of 1 to 8 blocks the card
  holds at once (``cudaOccupancyMaxActiveClusters``) for the tensor-core
  kernel at one block an SM (165 KB of shared memory) and at two (100 KB):
  the numbers behind ``decode_attention.CLUSTERS_AT_ONE_A_SM``;
- ``ablate``: the kernel, and the kernel built again with its cache loads
  taken out (``products``) or its products taken out (``loads``), at
  ABLATE_SHAPES, every slot valid, each by ``kernel_table.time_ms``.  A
  variant computes garbage; only its time is read.  The edits are asserted
  to apply, so a changed source fails loudly;
- ``plans``: every launch plan the launcher takes at PLAN_SHAPES (key
  warps, ring stages, cluster size), timed by ``kernel_table.time_ms``,
  beside ``decode_plan``'s choice.

Prints the card first; writes the versions' rounds to
``build/decode_variants/runs.json``.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import itertools
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

import kernel_table  # noqa: E402  (beside this script; puts src/ on the path)

OUT_DIR = ROOT / "build" / "decode_variants"
ROUNDS = 2
# (B, H, KV, S, hd, query type, cache type): the kernel's entries in PERF.md.
SHAPES = (
    (8, 12, 12, 256, 64, "float32", "float32"),  # orloj_gpt's step (SIMT route)
    (8, 32, 2, 256, 128, "float32", "float32"),  # GLM-4-9B, g 16
    (8, 32, 2, 4096, 128, "float32", "bfloat16"),
    (8, 32, 2, 32768, 128, "float32", "bfloat16"),
    (8, 96, 8, 256, 192, "float32", "float32"),  # Nemotron-4-340B, g 12
    (4, 48, 1, 4096, 128, "float32", "float32"),  # Granite-34B, g 48
    (8, 48, 8, 256, 128, "float32", "float32"),  # DBRX, g 6
    (8, 56, 8, 256, 128, "float32", "float32"),  # Arctic, g 7
    (8, 4, 4, 256, 512, "float32", "float32"),  # xLSTM-1.3B, head size 512
)
STEP = (8, 32768, "bfloat16")  # GLM-4-9B's decode step: rows, cache slots, cache type
ABLATE_SHAPES = (
    (8, 32, 2, 4096, 128, "float32", "bfloat16"),  # GLM-4-9B over its bf16 cache
    (8, 32, 2, 32768, 128, "float32", "bfloat16"),
    (8, 96, 8, 256, 192, "float32", "float32"),  # Nemotron-4-340B
    (4, 48, 1, 4096, 128, "float32", "float32"),  # Granite-34B
    (8, 56, 8, 256, 128, "float32", "float32"),  # Arctic
)
PLAN_SHAPES = (
    (8, 32, 2, 4096, 128, "float32", "bfloat16"),
    (7, 32, 2, 4096, 128, "float32", "bfloat16"),  # 14 clusters of 8: all fit at one block an SM
    (7, 32, 2, 32768, 128, "float32", "bfloat16"),
    (8, 96, 8, 256, 192, "float32", "float32"),
    (8, 56, 8, 256, 128, "float32", "float32"),
    (8, 25, 5, 1024, 64, "float32", "bfloat16"),  # Hymba-1.5B
)
# The source edits of ``ablate``: (what to find, what to put), within the
# text from TC_BODY[0] to TC_BODY[1].
TC_BODY = ("    decode_tc_kernel(const TQ* __restrict__ q,",
           "// ------------------------------------------------------------ head size 512")
ABLATIONS = {
    "products": [  # the cache's stages never load: the products run on whatever shared memory holds
        ("    if (step + ahead < nsteps) load_stage(step + ahead);\n", ""),
        ("    if (p < nsteps) load_stage(p);\n", ""),
    ],
    "loads": [("    if (key0 >= end) continue;\n", "    continue;\n")],  # every warp skips its products
}
CLUSTERS_CU = r"""
extern "C" int probe_max_clusters(int warps, int cluster, long long smem) {
  auto k = repro_torch::decode_tc_kernel<float, __nv_bfloat16, 128, false>;
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, 2, 8);
  cfg.blockDim = dim3(32 * warps);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = -1;
  return cudaOccupancyMaxActiveClusters(&n, (void*)k, &cfg) == cudaSuccess ? n : -1;
}
"""


def build(sources: dict[str, str]) -> dict[str, Path]:
    """Each source text built into its own library, all at once."""
    from repro_torch.kernels import _build

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for label, text in sources.items():
        src, lib = OUT_DIR / f"{label}.cu", OUT_DIR / f"lib{label}.so"
        src.write_text(text)
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}", "-o", str(lib), str(src)]
        procs[label] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for label, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed to build {label}:\n{out}")
        libs[label] = lib
    return libs


def entry(lib: Path, source: str):
    """The library's C entry point with the port's argument list: an older
    one, which takes no plan (no ``int route`` among its parameters), is
    handed the shapes and the stream alone."""
    fn = ctypes.CDLL(str(lib)).decode_attention_launch
    fn.restype = ctypes.c_int
    if re.search(r"decode_attention_launch\([^)]*int route", source):
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_float] + [ctypes.c_int] * 4 + [
            ctypes.c_longlong, ctypes.c_void_p]
        return fn
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
    return lambda *args: fn(*args[:13], args[-1])


def use(fn) -> None:
    """The port's wrapper launches ``fn`` from now on."""
    from repro_torch.kernels import decode_attention as dec

    dec._entry = lambda: fn


@contextlib.contextmanager
def planned(plan):
    """The port's wrapper launches ``plan`` while this holds."""
    from repro_torch.kernels import decode_attention as dec

    chosen = dec.decode_plan
    dec.decode_plan = lambda *args: plan
    try:
        yield
    finally:
        dec.decode_plan = chosen


def inputs(gen, shape):
    import torch

    b, h, kv, s, hd, qt, ct = shape
    q = kernel_table.randn(gen, (b, h, hd), getattr(torch, qt))
    k, v = (kernel_table.randn(gen, (b, kv, s, hd), getattr(torch, ct)) for _ in range(2))
    return q, k, v, torch.full((b,), s, dtype=torch.int32, device="cuda")


def bound(q, k, vl) -> tuple[float, str]:
    """``kernel_table.decode_bound`` on ``decode_plan``'s route."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as dec

    b, h, hd = q.shape
    plan = dec.decode_plan(b, h, k.shape[1], k.shape[2], hd, q.dtype, k.dtype, _build.sm_count(q.device))
    return kernel_table.decode_bound(q, k, vl, plan.route)


def compare(fns: dict) -> None:
    import torch

    from repro_torch.configs.glm4_9b import CONFIG
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import ref
    from repro_torch.models import Model
    from repro_torch.optim.adamw import leaves

    gen = torch.Generator(device="cuda").manual_seed(0)
    args = {shape: inputs(gen, shape) for shape in SHAPES}
    for label, fn in fns.items():
        use(fn)
        for shape, a in args.items():
            err = (dec.decode_attention_cuda(*a).float() - ref.decode_attention_ref(*a).float()).abs().max()
            if not err.item() <= (2e-2 if shape[-2] == "bfloat16" else 1e-4):
                raise SystemExit(f"{label} disagrees with the plain version at {shape}: {err.item():.3e}")
    print(f"every version agrees with the plain version at {len(SHAPES)} shapes", flush=True)

    model = Model(CONFIG, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    rows, slots, ct = STEP
    cache = model.init_cache(rows, slots, dtype=getattr(torch, ct))
    tokens = torch.ones((rows, 1), dtype=torch.long, device="cuda")
    nbytes = lambda tree: sum(t.numel() * t.element_size() for t in leaves(tree))  # noqa: E731
    step_bytes = (nbytes(params) - nbytes(params["embed"]["table"]) + rows * CONFIG.d_model * 4 + nbytes(cache)
                  + rows * CONFIG.vocab_size * 4)
    step_bound = step_bytes / kernel_table.HBM_BYTES_PER_S * 1e3

    def step():
        with torch.no_grad():
            model.decode_step(params, tokens, cache, slots - 1)

    labels = list(fns)
    runs = {label: {"kernel_ms": {str(s): [] for s in SHAPES}, "step_eager_ms": [], "step_graph_ms": []}
            for label in labels}
    for r in range(ROUNDS):
        for label in labels if r % 2 == 0 else labels[::-1]:
            use(fns[label])
            for shape, a in args.items():
                runs[label]["kernel_ms"][str(shape)].append(kernel_table.time_ms(lambda a=a: dec.decode_attention_cuda(*a)))
            for _ in range(3):
                step()
            torch.cuda.synchronize()
            times = []
            for _ in range(15):
                t0 = time.perf_counter()
                step()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            runs[label]["step_eager_ms"].append(statistics.median(times))
            runs[label]["step_graph_ms"].append(kernel_table.time_ms(step, reps=3, graphs=3))
    for shape, (q, k, v, vl) in args.items():
        b_ms, by = bound(q, k, vl)
        for label in labels:
            ms = runs[label]["kernel_ms"][str(shape)]
            print(f"decode {shape} {label}: median {statistics.median(ms):.6f} ms {[round(x, 6) for x in ms]}, "
                  f"bound {b_ms:.6f} ms ({by}), /bound {statistics.median(ms) / b_ms:.3f}", flush=True)
    for label in labels:
        eager, graph = runs[label]["step_eager_ms"], runs[label]["step_graph_ms"]
        print(f"glm4 decode step B {rows}, cache {slots} {ct}, {label}: eager median {statistics.median(eager):.4f} "
              f"ms {[round(x, 4) for x in eager]}, graph {statistics.median(graph):.4f} ms "
              f"{[round(x, 4) for x in graph]}; step byte bound {step_bound:.4f} ms ({step_bytes} bytes), "
              f"graph /bound {statistics.median(graph) / step_bound:.3f}", flush=True)
    out = OUT_DIR / "runs.json"
    out.write_text(json.dumps({"card": kernel_table.card_line(), "variants": labels, "step_bound_ms": step_bound,
                               "runs": runs}, indent=1))
    print(f"every round's numbers: {out}", flush=True)


def clusters(lib: Path) -> None:
    fn = ctypes.CDLL(str(lib)).probe_max_clusters
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_longlong]
    fn.restype = ctypes.c_int
    for c in range(1, 9):
        print(f"clusters of {c} held at once: {fn(4, c, 165_000)} at one block an SM (165 KB), "
              f"{fn(4, c, 100_000)} at two (100 KB)", flush=True)


def ablate(fns: dict) -> None:
    import torch

    from repro_torch.kernels import decode_attention as dec

    gen = torch.Generator(device="cuda").manual_seed(0)
    for shape in ABLATE_SHAPES:
        q, k, v, vl = inputs(gen, shape)
        ms = {}
        for label, fn in fns.items():
            use(fn)
            ms[label] = kernel_table.time_ms(lambda: dec.decode_attention_cuda(q, k, v, vl))
        b_ms, by = bound(q, k, vl)
        print(f"ablate {shape}: kernel {ms['kernel']:.6f} ms, its loads alone {ms['loads']:.6f}, its products "
              f"alone {ms['products']:.6f}; bound {b_ms:.6f} ms ({by})", flush=True)


def plans(fn) -> None:
    import torch

    from repro_torch.kernels import decode_attention as dec

    use(fn)
    gen = torch.Generator(device="cuda").manual_seed(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for shape in PLAN_SHAPES:
        b, h, kv, s, hd, qt, ct = shape
        q, k, v, vl = inputs(gen, shape)
        chosen = dec.decode_plan(b, h, kv, s, hd, q.dtype, k.dtype, sms)
        m_tiles = chosen.m_tiles
        times = []
        for key_warps, stages, cluster in itertools.product((1, 2, 4), (1, 2, 3, 4), (1, 2, 4, 8)):
            per = -(-s // cluster)
            if key_warps * m_tiles > dec.TC_MAX_WARPS or (stages == 1 and per > dec.TC_KEYS * key_warps):
                continue
            smem = dec.tc_shared_bytes(h, kv, hd, q.dtype, k.dtype, key_warps, stages)
            if smem > dec.MAX_SHARED:
                continue
            plan = dataclasses.replace(chosen, warps=key_warps * m_tiles, stages=stages, cluster=cluster,
                                       stage_keys=dec.TC_KEYS * key_warps, dynamic_bytes=smem)
            with planned(plan):
                times.append((kernel_table.time_ms(lambda: dec.decode_attention_cuda(q, k, v, vl)), key_warps,
                              stages, cluster, smem))
        times.sort()
        best = ", ".join(f"{t:.6f} ms (key warps {w}, stages {st}, cluster {c}, {sm} B)"
                         for t, w, st, c, sm in times[:4])
        now = next(t for t, w, st, c, sm in times
                   if (w * m_tiles, st, c) == (chosen.warps, chosen.stages, chosen.cluster))
        print(f"plans {shape}: decode_plan's (warps {chosen.warps}, stages {chosen.stages}, cluster "
              f"{chosen.cluster}) {now:.6f} ms; fastest of {len(times)}: {best}", flush=True)


def main() -> int:
    import torch

    from repro_torch.kernels import _build

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("variants", nargs="*", metavar="LABEL=SOURCE")
    parser.add_argument("--probe", nargs="*", choices=("clusters", "ablate", "plans"))
    args = parser.parse_args()
    probes = ["clusters", "ablate", "plans"] if args.probe == [] else args.probe or []
    if not args.variants and not probes:
        parser.error("give versions to compare, --probe, or both")
    if not torch.cuda.is_available():
        print("decode_variants: no CUDA device is visible", file=sys.stderr)
        return 2
    print(kernel_table.card_line(), flush=True)

    sources = {}
    for spec in args.variants:
        label, _, src = spec.partition("=")
        if not label or not src or label in ("kernel", "clusters", *ABLATIONS):
            raise SystemExit(f"expected LABEL=SOURCE with a label other than the probes' own, got {spec!r}")
        sources[label] = (ROOT / src).resolve().read_text()
    current = (_build.CSRC / "decode_attention.cu").read_text()
    if "ablate" in probes or "plans" in probes:
        sources["kernel"] = current
    if "ablate" in probes:
        # The edits apply to the tensor-core kernel's body alone.
        start, end = current.index(TC_BODY[0]), current.index(TC_BODY[1])
        for label, edits in ABLATIONS.items():
            body = current[start:end]
            for old, new in edits:
                if body.count(old) != 1:
                    raise SystemExit(f"the {label} ablation does not apply to this source: {old!r}")
                body = body.replace(old, new)
            sources[label] = current[:start] + body + current[end:]
    if "clusters" in probes:
        sources["clusters"] = current + CLUSTERS_CU
    libs = build(sources)
    fns = {label: entry(libs[label], sources[label]) for label in sources if label != "clusters"}

    if args.variants:
        compare({spec.partition("=")[0]: fns[spec.partition("=")[0]] for spec in args.variants})
    if "clusters" in probes:
        clusters(libs["clusters"])
    if "ablate" in probes:
        ablate({label: fns[label] for label in ("kernel", *ABLATIONS)})
    if "plans" in probes:
        plans(fns["kernel"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
