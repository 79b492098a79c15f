"""The port's model substrate: the dense attention decoder of the serving
path, in PyTorch, with the reference's parameter layouts."""

from .config import ModelConfig
from .hymba import HymbaConfig
from .model import Model

__all__ = ["ModelConfig", "HymbaConfig", "Model"]
