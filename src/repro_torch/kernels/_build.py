"""Builds the port's CUDA kernels with ``nvcc`` and loads them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface, for ``sm_90a`` (Hopper, with its ``a`` features).  The
libraries go to ``build/repro_torch_kernels/`` at the root of the checkout,
named by a hash of their sources and flags, so an edit never loads a stale
build.  The first use builds; :func:`build_all` builds every kernel at
once, one ``nvcc`` process per source, all started together.

Nothing here runs at import time: the CPU tests import every module of the
package on hosts without ``nvcc``.

:func:`refuse_autograd` is the raw launchers' shared guard: a launcher
writes into a fresh tensor that autograd does not track, so a launch on
inputs that need a gradient raises instead of handing back a tensor that
carries no graph.  :mod:`.ops` makes each kernel a ``torch.library``
operator and differentiates flash attention, RMSNorm and the gates through
the operators' autograd formulas, whose forwards launch below autograd and
whose backwards are the ``*_bwd`` operators; the decode kernel has no
backward.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
# The four forwards, each the counterpart of a Pallas TPU kernel, the
# backwards of the three that training differentiates through, the
# float32 GEMM of the models' weight products and Mamba's selective scan
# (neither has a TPU counterpart).
KERNELS = ("flash_attention", "decode_attention", "rmsnorm", "moe_gating",
           "flash_attention_bwd", "rmsnorm_bwd", "moe_gating_bwd", "gemm", "selective_scan")
# --split-compile=0 runs the device optimisations of one source on every
# core: the attention sources instantiate 22 and 121 kernels (head sizes
# 16 to 512, both softcap flags), and split they build in about half the time.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
    "--split-compile=0",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# The ``kernels.build`` counter, beside the kernels' launch counters: the
# ``nvcc`` runs of this process and the wall seconds that the
# :func:`build_all` calls which ran one spent building.  A count above
# zero means that a run of this checkout built its kernels first.
nvcc_runs = 0
nvcc_seconds = 0.0


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else the toolkit's default install location."""
    home = os.environ.get("CUDA_HOME")
    if home and Path(home, "bin", "nvcc").exists():
        return str(Path(home, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the port's CUDA "
        "kernels are built from source on first use"
    )


def _sources(name: str) -> list[Path]:
    return [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]


def library_path(name: str) -> Path:
    """Where the library of kernel ``name`` is built, keyed by the hash of
    its sources and of the compiler flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources(name):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def nvcc_command(name: str, output: Path) -> list[str]:
    return [nvcc_path(), *NVCC_FLAGS, "-o", str(output), str(CSRC / f"{name}.cu")]


def _start(name: str) -> tuple[Path, Path, subprocess.Popen] | None:
    lib = library_path(name)
    if lib.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.Popen(
        nvcc_command(name, tmp),
        stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT,
        text=True,
    )
    return lib, tmp, proc


def build_all(names: tuple[str, ...] = KERNELS) -> dict[str, str]:
    """Build every kernel of ``names`` that is not built yet, one ``nvcc``
    each, in parallel.  Returns each kernel's compiler output (the
    ``-Xptxas -v`` register and shared-memory report; empty when the
    library was already built).  Raises with the compiler's output if a
    build fails."""
    global nvcc_runs, nvcc_seconds
    with _lock:
        t0 = time.perf_counter()
        started = {n: _start(n) for n in names}
        ran = sum(job is not None for job in started.values())
        logs: dict[str, str] = {}
        failed: list[str] = []
        for n, job in started.items():
            if job is None:
                logs[n] = ""
                continue
            lib, tmp, proc = job
            out, _ = proc.communicate()
            logs[n] = out
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                failed.append(f"{n} (exit {proc.returncode}):\n{out}")
            else:
                os.replace(tmp, lib)
        if ran:
            nvcc_runs += ran
            nvcc_seconds += time.perf_counter() - t0
        if failed:
            raise RuntimeError("nvcc failed to build " + "\n".join(failed))
        return logs


@functools.cache
def sm_count(device: torch.device) -> int:
    """The multiprocessors of a CUDA device (the launch planners' unit)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def needs_grad(*tensors) -> bool:
    """Whether grad mode is on and any of ``tensors`` requires grad."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def refuse_autograd(name: str, *tensors) -> None:
    """Raise when grad mode is on and any of ``tensors`` requires grad: the
    kernel writes into a fresh tensor that autograd does not track, so its
    output would silently cut every gradient through it."""
    if needs_grad(*tensors):
        raise RuntimeError(
            f"{name}: the raw CUDA launcher carries no backward, and an input requires "
            "grad; call it under torch.no_grad(), or go through repro_torch.kernels.ops, "
            "which differentiates flash attention, rmsnorm and the gates through their "
            "backward kernels (the decode kernel has no backward)"
        )


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if need be."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all((name,))
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(library_path(name)))
        return _libs[name]
