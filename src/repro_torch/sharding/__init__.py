from .specs import (
    batch_pspecs,
    cache_pspecs,
    param_pspecs,
    opt_state_pspecs,
    BATCH_AXES,
)

__all__ = [
    "param_pspecs",
    "batch_pspecs",
    "cache_pspecs",
    "opt_state_pspecs",
    "BATCH_AXES",
]
