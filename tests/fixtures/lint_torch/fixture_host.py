"""Seeded violations for the port's host-transfer checker (never executed)."""

import numpy as np
import torch

from repro_torch.device import synchronize


def bad_item(dev: torch.Tensor):
    return dev.mean().item()  # TP-ITEM 10


def bad_copy_out(dev):
    return dev.cpu().numpy()  # TP-CPU-NUMPY 14 (two findings, one line)


def bad_tolist(dev):
    return dev.tolist()  # TP-TOLIST 18


def bad_to_cpu(dev):
    a = dev.to("cpu")  # TP-TO-CPU 22
    b = dev.to(device="cpu")  # TP-TO-DEVICE-CPU 23
    return a, b


def bad_fences(dev, event):
    torch.cuda.synchronize()  # TP-CUDA-SYNC 28
    synchronize(dev.device)  # TP-PORT-SYNC 29
    event.synchronize()  # TP-EVENT-SYNC 30


def bad_asarray(dev):
    return np.asarray(dev)  # TP-ASARRAY 34


def bad_casts(x: torch.Tensor, n):
    total = int(x.sum())  # TP-CAST-PARAM 38
    peak = float(torch.max(n))  # TP-CAST-TORCH 39
    y = torch.zeros(3) + n
    any_pos = bool((y > 0).any())  # TP-CAST-BOUND 41
    return total, peak, any_pos


def sanctioned(dev):
    # repro: host-ok(fixture: documented copy-out contract)
    return np.asarray(dev)  # NEG-ANNOTATED 47


def host_values(x: torch.Tensor, walls):
    lit = np.asarray([1, 2, 3])  # NEG-HOSTVALUE 51: literal argument
    c = np.array([[1, 0, 0], [0, 1, 0]])
    uw = np.array([0.1, 0.0, 0.0])
    lid = float(c[0] @ uw)  # NEG-HOST-CAST 54: numpy lattice constants
    wall = int(walls.WALL)  # NEG-HOST-INT 55: a host enum
    rows = int(x.shape[0])  # NEG-METADATA 56: tensor metadata is a host value
    cells = int(x.numel())  # NEG-METADATA 57
    return lit, lid, wall, rows, cells
