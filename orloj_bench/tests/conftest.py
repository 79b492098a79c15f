import sys
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[2]
for p in (str(CHECKOUT), str(CHECKOUT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)
