import sys
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[2]
for p in (str(CHECKOUT), str(CHECKOUT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

# Several test processes share the host's cores: one intra-op thread each
# keeps the CPU runs' Eq.-3 fits from timing other processes' spinning threads.
torch.set_num_threads(1)
