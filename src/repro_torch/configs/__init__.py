"""Architecture registry of the port: the serving path's dense model and
Snowflake Arctic (the MoE path).

``get_config(name)`` returns the full published configuration, as
:func:`repro.configs.get_config` does; the rest of the zoo is ported later
(ROADMAP A9)."""

from __future__ import annotations

import importlib

from ..models.config import ModelConfig

ARCHS = ["orloj_gpt", "arctic_480b"]


def get_config(name: str) -> ModelConfig:
    name = name.replace("-", "_")
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; the port has: {ARCHS}")
    mod = importlib.import_module(f".{name}", __package__)
    return mod.CONFIG
