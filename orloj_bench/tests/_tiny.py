"""The tiny configurations of the CPU tests, one file a configuration in
``tiny/``, found by glob: ``TINY`` maps each file's name, without its
``tiny_`` prefix, to its dict.  A new family's tiny file is tested by every
test that runs over ``TINY``."""

import json
from pathlib import Path

TINY = {p.stem.removeprefix("tiny_"): json.loads(p.read_text())
        for p in sorted((Path(__file__).parent / "tiny").glob("*.json"))}
