"""The benchmark's command: one run of one cell of ``BENCHMARK.json``.

    python3 orloj_bench/run.py --workload glm4_9b.bimodal.r80 --seed 7 --seconds 30 --trace 0

Run from the root of a checkout on a machine with an NVIDIA GPU.  Prints
the numbers compared with their limits as the last lines of standard error
and one JSON object as the last line of standard output.  Exits with a code
other than 0, and prints no result, without a CUDA device, or when the
process holds ``jax``, ``jaxlib``, ``flax`` or the JAX package ``repro``
once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parents[1]
CACHE = CHECKOUT / "build" / "orloj_bench"
# Every build and kernel cache at a fixed path inside the checkout: only the
# first run of a checkout builds.  (The program's kernels build into the
# checkout's build/repro_torch_kernels/ by themselves.)
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = str(CACHE / sub)
sys.path[:0] = [str(CHECKOUT), str(CHECKOUT / "src")]

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20,
        )
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from orloj_bench import harness

    cell = harness.load_cell(args.workload)
    need = 1
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"needs {need} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result, lines = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), device,
                                     T_START)
    held = sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
    if held:
        print("the process holds forbidden modules: " + ", ".join(held), file=sys.stderr)
        return 3
    result["device"]["power_limit"] = power_limit()
    print(f"device: {result['device']['kind']}, {result['device']['power_limit']}",
          file=sys.stderr)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
