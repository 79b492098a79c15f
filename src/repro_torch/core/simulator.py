"""Discrete-event serving simulator (paper §5 methodology) — compatibility
surface.

The actual loop lives in :mod:`repro.core.eventloop`, the unified
multi-worker engine; :func:`simulate` is its 1-worker case.  This module
keeps the historical import path (``repro.core.simulator``) stable for
callers and re-exports the executor/result types that used to be defined
here.
"""

from __future__ import annotations

from .eventloop import Executor, ModelExecutor, SimResult, simulate

__all__ = ["Executor", "ModelExecutor", "SimResult", "simulate"]
