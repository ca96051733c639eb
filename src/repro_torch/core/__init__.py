"""Extreme-scale block-structured AMR (Schornbaum & Rüde 2017) — core library.

The paper's contribution as a composable module: distributed forest-of-octrees
domain partitioning, the four-step AMR pipeline with its lightweight proxy
data structure, SFC- and diffusion-based dynamic load balancing, data
migration with user-registered serialization callbacks, checkpoint/restart,
and buddy-based resilience.
"""

from .blockid import ForestGeometry, hilbert_index_3d
from .comm import Comm, CommStats, DeviceComm
from .forest import Block, BlockForest, make_forest_from_levels, make_uniform_forest
from .refine import mark_and_balance_targets
from .proxy import build_proxy, migrate_proxy_blocks
from .migration import BlockDataItem, BlockDataRegistry, migrate_data
from .fields import DeviceResidency, FieldRegistry, FieldSpec, LevelArena, RankArenas
from .pipeline import AMRPipeline, CycleReport, recompute_weights
from .balancing import DiffusionBalancer, SFCBalancer

__all__ = [
    "ForestGeometry",
    "hilbert_index_3d",
    "Comm",
    "CommStats",
    "DeviceComm",
    "Block",
    "BlockForest",
    "make_forest_from_levels",
    "make_uniform_forest",
    "mark_and_balance_targets",
    "build_proxy",
    "migrate_proxy_blocks",
    "BlockDataItem",
    "BlockDataRegistry",
    "FieldSpec",
    "FieldRegistry",
    "LevelArena",
    "RankArenas",
    "DeviceResidency",
    "migrate_data",
    "AMRPipeline",
    "CycleReport",
    "recompute_weights",
    "DiffusionBalancer",
    "SFCBalancer",
]
