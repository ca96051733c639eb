"""One import hop from the stepping root (never executed)."""

from torch.distributed import isend


def push(payload):
    return isend(payload, 1)  # TP-REACHABLE 7


def allreduce(comm, values):
    return comm.allreduce(values)  # NEG-PROVIDER 11: a fabric implementing itself
