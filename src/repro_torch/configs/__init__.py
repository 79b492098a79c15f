"""Architecture registry of the port: the attention models of the zoo (dense
and MoE) and the serving path's own model, in the reference's order.

``get_config(name)`` returns the full published configuration, as
:func:`repro.configs.get_config` does.  The SSM and recurrent models and
the two with a frontend are ported later (ROADMAP A8, A9)."""

from __future__ import annotations

import importlib

from ..models.config import ModelConfig

ARCHS = [
    "glm4_9b",
    "dbrx_132b",
    "arctic_480b",
    "olmo_1b",
    "nemotron_4_340b",
    "granite_34b",
    "orloj_gpt",
]


def get_config(name: str) -> ModelConfig:
    name = name.replace("-", "_")
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; the port has: {ARCHS}")
    mod = importlib.import_module(f".{name}", __package__)
    return mod.CONFIG
