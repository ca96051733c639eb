"""Training substrate of the port: optimizer, train/serve steps, data
pipeline and checkpointing, plus the paper-technique integration points
(diffusion-balanced data buckets, MoE expert placement in
``repro_torch.train.moe_balance``). ``repro_torch.train.elastic`` is the
reference's deprecated shim, not imported here."""

from .data import SyntheticTokenPipeline, diffusion_assign_buckets
from .optimizer import AdamWConfig, adamw_init, adamw_update
from .train_step import make_serve_step, make_train_step

__all__ = [
    "AdamWConfig",
    "adamw_init",
    "adamw_update",
    "make_train_step",
    "make_serve_step",
    "SyntheticTokenPipeline",
    "diffusion_assign_buckets",
]
