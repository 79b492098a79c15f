"""Architecture registry + assigned input shapes.

Ten architectures assigned from the public pool (each config cites its
source), plus the paper-scale example model.  ``get_config(name)`` returns
the full published configuration; ``get_config(name).reduced()`` the
CPU-smoke variant.  ``for_shape`` applies shape-driven adaptations (e.g.
the sliding-window variant that makes dense attention sub-quadratic for
``long_500k`` — see DESIGN.md §Shape-coverage).
"""

from __future__ import annotations

import dataclasses
import importlib

from ..models.config import ModelConfig

ARCHS = [
    "glm4_9b",
    "musicgen_large",
    "dbrx_132b",
    "arctic_480b",
    "internvl2_1b",
    "olmo_1b",
    "nemotron_4_340b",
    "hymba_1_5b",
    "xlstm_1_3b",
    "granite_34b",
    "orloj_gpt",  # paper-scale example model (~100M)
]


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    kind: str  # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": InputShape("train_4k", "train", 4_096, 256),
    "prefill_32k": InputShape("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": InputShape("decode_32k", "decode", 32_768, 128),
    "long_500k": InputShape("long_500k", "decode", 524_288, 1),
}


def get_config(name: str) -> ModelConfig:
    name = name.replace("-", "_")
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {ARCHS}")
    mod = importlib.import_module(f".{name}", __package__)
    return mod.CONFIG


def for_shape(cfg: ModelConfig, shape: InputShape) -> ModelConfig:
    """Shape-driven config adaptation.

    ``long_500k`` requires sub-quadratic attention: SSM/hybrid archs run
    natively (O(1) state / built-in SWA); full-attention archs switch to the
    sliding-window variant (ring-buffer KV cache, window 8192).
    """
    if shape.name == "long_500k" and cfg.uses_attention and not cfg.sliding_window:
        cfg = dataclasses.replace(cfg, sliding_window=8_192)
    return cfg
