"""The plain float32 references of the benchmark's configurations, one module
a model family, named by the configuration's ``block_pattern`` (``attn.py``:
GLM-4's decoder, whose ``precision``, ``rmsnorm``, ``rope`` and
``attention`` another family's reference may reuse)."""

import importlib


def logits(cfg: dict, w: dict, tokens, *, tf32: bool = False):
    """tokens: (S,) ids → (S, vocab) float32 logits of one prompt, by the
    reference of the configuration's family."""
    family = importlib.import_module(f"{__name__}.{cfg['block_pattern']}")
    return family.logits(cfg, w, tokens, tf32=tf32)


__all__ = ["logits"]
