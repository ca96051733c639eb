from .lbm_collide import lbm_stream_collide, lbm_stream_collide_halo
from .ops import make_stream_collide
from .ref import stream_collide_ref

__all__ = [
    "lbm_stream_collide",
    "lbm_stream_collide_halo",
    "make_stream_collide",
    "stream_collide_ref",
]
