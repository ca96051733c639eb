"""Serving substrate of the port: the greedy ``serve_step`` factory.

The reference's package also carries the optimizer, ``make_train_step``,
checkpointing, the data pipeline and elasticity; those come with the
port's training slice.
"""

from .train_step import make_serve_step

__all__ = ["make_serve_step"]
