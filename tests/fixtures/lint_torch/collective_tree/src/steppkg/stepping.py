"""Stepping root of the collective fixture (never executed)."""

import torch
import torch.distributed as dist

from . import support


def step(comm, payload, msgs):
    dist.all_reduce(payload)  # TP-DIST-COLLECTIVE 10
    dist.send(payload, 1)  # TP-DIST-P2P 11: torch.distributed.send
    comm.send(0, 1, "halo", payload, nbytes=8)  # NEG-HOST-FABRIC 12: the simulated Comm
    comm.ppermute(msgs)  # TP-PPERMUTE 13: the fabric, unannotated
    # repro: collective-ok(fixture: accounting mirror of in-program payload copies)
    comm.ppermute(msgs)  # NEG-ANNOTATED 15
    torch.distributed.barrier()  # TP-BARRIER 16
    return torch.gather(payload, 0, payload.long())  # NEG-TENSOR-OP 17: torch.gather is no collective
