"""Model zoo for the dense and vlm architectures (PyTorch, one module a layer)."""

from .zoo import Model, build_model

__all__ = ["build_model", "Model"]
