#!/usr/bin/env python3
"""Count the machine instructions of the port's built kernels, by kernel.

    python3 scripts/sass_census.py NAME [NAME ...]

Builds each kernel library NAME (``_build.KERNELS``, e.g.
``flash_attention_bwd``) if it is not built, disassembles it with
``cuobjdump -sass`` and prints, for every kernel function in it, the number
of instructions and of the classes that tell how it computes: tensor-core
products (``HGMMA``: Hopper's wgmma, and ``HMMA``: mma.sync, with their
shapes and types), TMA tile loads (``UTMALDG``) and mbarrier operations
(``SYNCS``), shared-memory loads and stores (``LDS``, ``LDSM``: ldmatrix,
``STS``), global loads and stores, asynchronous copies (``LDGSTS``),
float32 fused multiply-adds (``FFMA``) and barriers (``BAR``).  Needs the CUDA toolkit (``cuobjdump``), not a card.
"""

from __future__ import annotations

import collections
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

CLASSES = ("HGMMA", "HMMA", "UTMALDG", "SYNCS", "LDSM", "LDS", "STS", "LDGSTS", "LDG", "STG", "FFMA", "BAR")


def cuobjdump() -> str:
    from repro_torch.kernels import _build

    found = Path(_build.nvcc_path()).with_name("cuobjdump")
    return str(found) if found.exists() else (shutil.which("cuobjdump") or "cuobjdump")


def census(lib: Path) -> dict[str, collections.Counter]:
    """{kernel function (demangled where c++filt is found): Counter of opcodes}."""
    sass = subprocess.run([cuobjdump(), "-sass", str(lib)], capture_output=True, text=True, check=True).stdout
    out: dict[str, collections.Counter] = {}
    current = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            current = out.setdefault(m.group(1), collections.Counter())
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if m and current is not None:
            current[m.group(1)] += 1
    return out


def demangle(names: list[str]) -> dict[str, str]:
    tool = shutil.which("c++filt") or shutil.which("cu++filt")
    if tool is None:
        return {n: n for n in names}
    res = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True).stdout.splitlines()
    return dict(zip(names, res)) if len(res) == len(names) else {n: n for n in names}


def main() -> int:
    from repro_torch.kernels import _build

    names = sys.argv[1:] or list(_build.KERNELS)
    _build.build_all(tuple(names))
    for name in names:
        counts = census(_build.library_path(name))
        pretty = demangle(list(counts))
        for fn, ops in sorted(counts.items(), key=lambda kv: pretty[kv[0]]):
            short = pretty[fn].replace("repro_torch::(anonymous namespace)::", "").removeprefix("void ")
            short = short.split("(", 1)[0]
            by_class = {c: sum(n for op, n in ops.items() if op.split(".")[0] == c) for c in CLASSES}
            hmma = ", ".join(f"{op} {n}" for op, n in sorted(ops.items()) if op.startswith(("HMMA", "HGMMA")))
            print(f"sass: {name}: {short}: {sum(ops.values())} instructions; "
                  + ", ".join(f"{c} {n}" for c, n in by_class.items()) + (f" ({hmma})" if hmma else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
