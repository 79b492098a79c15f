#!/usr/bin/env python3
"""Time versions of the MoE gating kernel against each other on one card.

    python3 scripts/gating_variants.py LABEL=SOURCE[:WARPS] ...

Each SOURCE is a ``moe_gating.cu`` with the C entry point
``moe_gating_launch`` (the current one, or an older one written out with
``git show <commit>:src/repro_torch/kernels/csrc/moe_gating.cu``); WARPS,
where given, builds it with ``-DMOE_GATING_WARPS=WARPS`` (rows a block).
Every version is built with the port's nvcc flags into
``build/gating_variants/``, all at once, and run through the port's own
wrapper.  Each is first held against the plain version (ids equal, gates
within 1e-5) at every shape it is timed at and on rows of ties; then, at
T = 8, 32, 256 and 2048 rows of 128 experts, k 2, float32 (Arctic's serve
range and one block), the versions are timed in turns, the order reversed
every round: ``time_ms`` (20 launches replayed in a CUDA graph) and
``own_ms`` (the kernel's duration from the profiler).  In the same turns,
two floors on the grid of 4 rows a block: a kernel that does nothing, and
one that makes the gating's loads and stores and nothing between them
(each lane loads its float4 of the row, two lanes store).  Prints the card,
the registers of each build, every round's numbers and each version's
median, and writes them all to ``build/gating_variants/runs.json``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (puts src/ on the path)

SHAPES = (8, 32, 256, 2048)
E, K, ROUNDS = 128, 2, 5
OUT_DIR = ROOT / "build" / "gating_variants"
FLOOR_WARPS = 4
FLOOR_CU = r"""
#include <cuda_runtime.h>
__global__ void floor_empty_kernel() {}
__global__ void floor_touch_kernel(const float* __restrict__ x, float* __restrict__ y, int rows) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= rows) return;
  const float4 v = reinterpret_cast<const float4*>(x + static_cast<size_t>(row) * 128)[lane];
  if (lane < 2) y[2 * row + lane] = v.x + v.y + v.z + v.w;
}
// which 0: the empty kernel, 1: the loads and stores of (rows, 128) k 2.
extern "C" int floor_launch(int which, const float* x, float* y, int rows, int warps, void* stream) {
  const int blocks = (rows + warps - 1) / warps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (which == 0) floor_empty_kernel<<<blocks, 32 * warps, 0, s>>>();
  else floor_touch_kernel<<<blocks, 32 * warps, 0, s>>>(x, y, rows);
  return cudaGetLastError();
}
"""


def parse(spec: str) -> tuple[str, Path, int | None]:
    label, _, rest = spec.partition("=")
    src, _, warps = rest.partition(":")
    if not label or not src:
        raise SystemExit(f"expected LABEL=SOURCE[:WARPS], got {spec!r}")
    return label, (ROOT / src).resolve(), int(warps) if warps else None


def build(variants) -> dict[str, Path]:
    from repro_torch.kernels import _build

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for label, src, warps in variants:
        lib = OUT_DIR / f"lib{label}.so"
        define = [] if warps is None else [f"-DMOE_GATING_WARPS={warps}"]
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, *define, f"-I{_build.CSRC}", "-o", str(lib), str(src)]
        procs[label] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    floor_src = OUT_DIR / "floor.cu"
    floor_src.write_text(FLOOR_CU)
    floor_cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(OUT_DIR / "libfloor.so"), str(floor_src)]
    procs["floor"] = (OUT_DIR / "libfloor.so", subprocess.Popen(
        floor_cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for label, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed to build {label}:\n{out}")
        for fn, props in chip_smoke.ptxas_report(out):
            print(f"ptxas: {label}: {fn}: {props}", flush=True)
        libs[label] = lib
    return libs


def main() -> int:
    import ctypes

    import torch

    from repro_torch.kernels import moe_gating as gating
    from repro_torch.kernels import ref

    if not torch.cuda.is_available():
        print("gating_variants: no CUDA device is visible", file=sys.stderr)
        return 2
    variants = [parse(a) for a in sys.argv[1:]]
    if not variants:
        raise SystemExit(__doc__)
    print(chip_smoke.card_line(), flush=True)
    entries = {}
    libs = build(variants)
    floor_fn = ctypes.CDLL(str(libs.pop("floor"))).floor_launch
    floor_fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    floor_fn.restype = ctypes.c_int
    for label, lib in libs.items():
        fn = ctypes.CDLL(str(lib)).moe_gating_launch
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        entries[label] = fn

    def use(label: str) -> None:
        gating._entry = lambda: entries[label]  # the wrapper launches this version

    gen = torch.Generator(device="cuda").manual_seed(0)
    inputs = {t: torch.randn((t, E), generator=gen, device="cuda") * 2 for t in SHAPES}
    ties = torch.zeros((6, 16), device="cuda")
    ties[1] = 3.0
    ties[2, [3, 9, 12]] = 5.0
    ties[4] = torch.arange(16, device="cuda") % 4
    for label in entries:
        use(label)
        for x, k in [*((x, K) for x in inputs.values()), (ties, 4)]:
            gates, ids = gating.moe_gating_cuda(x, k)
            want_g, want_i = ref.moe_gating_ref(x, k)
            err = (gates - want_g).abs().max().item()
            if not torch.equal(ids, want_i) or not err <= 1e-5:
                raise SystemExit(f"{label} disagrees with the plain version at {tuple(x.shape)} k {k}")
    print(f"every version agrees with the plain version at T = {SHAPES} and on ties", flush=True)

    floor_out = torch.empty((SHAPES[-1], K), device="cuda")

    def floor(which: int, x) -> None:
        stream = torch.cuda.current_stream().cuda_stream
        if floor_fn(which, x.data_ptr(), floor_out.data_ptr(), x.shape[0], FLOOR_WARPS, stream) != 0:
            raise SystemExit("the floor kernels failed to launch")

    labels = [*entries, "floor_empty", "floor_touch"]
    runs = {label: {t: {"ms": [], "own_ms": []} for t in SHAPES} for label in labels}
    for r in range(ROUNDS):
        for t in SHAPES:
            for label in labels if r % 2 == 0 else labels[::-1]:
                x = inputs[t]
                if label.startswith("floor_"):
                    which = int(label == "floor_touch")
                    fn, name = (lambda x=x, w=which: floor(w, x)), label + "_kernel"
                else:
                    use(label)
                    fn, name = (lambda x=x: gating.moe_gating_cuda(x, K)), "moe_gating_kernel"
                runs[label][t]["ms"].append(chip_smoke.time_ms(fn))
                runs[label][t]["own_ms"].append(chip_smoke.own_ms(fn, name))
    for t in SHAPES:
        bound, by = chip_smoke.gating_bound(inputs[t], K)
        for label in labels:
            ms, own = runs[label][t]["ms"], runs[label][t]["own_ms"]
            print(f"({t},{E}) k {K} f32 {label}: graph replay median {statistics.median(ms):.6f} ms "
                  f"{[round(v, 6) for v in ms]}, own duration median {statistics.median(own):.6f} ms "
                  f"{[round(v, 6) for v in own]}, bound {bound:.6f} ms ({by})", flush=True)
    out = OUT_DIR / "runs.json"
    out.write_text(json.dumps({"card": chip_smoke.card_line(), "variants": sys.argv[1:], "runs": runs}, indent=1))
    print(f"every round's numbers: {out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
