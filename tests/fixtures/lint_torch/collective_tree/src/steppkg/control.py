"""A control-plane module excluded by config (never executed)."""

import torch.distributed as dist


def rebalance(t):
    dist.broadcast(t, 0)  # NEG-EXCLUDED 7
