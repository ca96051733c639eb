"""Annotation-hygiene fixture: an allowlist entry with no reason is itself a
finding (never executed)."""

import numpy as np
import torch


def undocumented_sanction(dev: torch.Tensor):
    # repro: host-ok()
    return np.asarray(dev)  # the empty reason above is flagged, the sync is not suppressed
