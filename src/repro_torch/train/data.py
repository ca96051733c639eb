"""Token data pipeline with diffusion-balanced document buckets.

This is the paper-technique integration point for *dense* architectures
(DESIGN.md §4): variable-length document buckets are modeled as blocks of a
1-D block forest (weight = token count) and assigned to data-parallel ranks
with the same :class:`repro.core.DiffusionBalancer` that balances the AMR
mesh — inexpensive, local, iterative. As documents grow/shrink between
epochs the assignment is *re*-balanced incrementally instead of reshuffled
globally (the SFC balancer is available as the global baseline, mirroring
the paper's §2.4.1-vs-§2.4.2 comparison).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core import (
    Comm,
    DiffusionBalancer,
    ForestGeometry,
    SFCBalancer,
    make_uniform_forest,
)

__all__ = ["diffusion_assign_buckets", "SyntheticTokenPipeline"]


def diffusion_assign_buckets(
    bucket_weights: list[float],
    nranks: int,
    *,
    mode: str = "pushpull",
    max_iterations: int = 30,
) -> tuple[list[int], int]:
    """Assign weighted buckets to ranks with the paper's diffusion scheme.

    The buckets become level-0 blocks of a (N,1,1) root-grid forest (a 1-D
    chain graph); the balancer runs exactly as for the AMR mesh. Returns
    (bucket -> rank assignment, main iterations used)."""
    n = len(bucket_weights)
    if n == 0:
        return [], 0
    # a roughly-cubic root grid gives each bucket up to 26 graph neighbors —
    # the denser process graph makes the diffusion converge in a handful of
    # iterations (a 1-D chain needs O(N) hops for the same imbalance)
    def _grid3(n: int) -> tuple[int, int, int]:
        best = (n, 1, 1)
        for a in range(1, int(n ** (1 / 3)) + 2):
            if n % a:
                continue
            m = n // a
            for b in range(a, int(m**0.5) + 1):
                if m % b == 0:
                    best = (m // b, b, a)
        return best

    geom = ForestGeometry(root_grid=_grid3(n), max_level=2)
    forest = make_uniform_forest(geom, nranks, level=0)
    order = sorted(b.bid for b in forest.all_blocks())
    idx_of = {bid: i for i, bid in enumerate(order)}
    for b in forest.all_blocks():
        b.weight = float(bucket_weights[idx_of[b.bid]])
    comm = Comm(nranks)
    balancer = DiffusionBalancer(
        mode=mode, flow_iterations=5, max_main_iterations=max_iterations, per_level=True
    )
    from ..core.forest import BlockForest
    from ..core.proxy import migrate_proxy_blocks  # late import to avoid cycle

    # the bucket forest acts as the proxy; a shallow twin (blocks pinned to
    # their initial ranks) absorbs the bilateral link updates, mirroring the
    # actual/proxy split of the AMR pipeline.
    anchor = BlockForest(geom, nranks)
    for blk in forest.all_blocks():
        blk.source_ranks = [blk.owner]
        blk.target_ranks = [blk.owner]
        blk.data["kind"] = "keep"
        twin = blk.clone_shallow()
        twin.target_ranks = [blk.owner]
        anchor.insert(twin)
    iteration = 0
    while True:
        assignments, again = balancer(forest, comm, iteration)
        migrate_proxy_blocks(forest, anchor, comm, assignments)
        iteration += 1
        if not again:
            break
    out = [0] * n
    for r in range(nranks):
        for bid in forest.local_blocks(r):
            out[idx_of[bid]] = r
    return out, iteration


@dataclass
class SyntheticTokenPipeline:
    """Deterministic synthetic corpus: documents with power-law lengths,
    packed into fixed-length rows per rank after diffusion balancing."""

    vocab: int
    seq_len: int
    global_batch: int
    nranks: int = 1
    seed: int = 0
    n_buckets: int = 64

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        # power-law document buckets (token counts)
        raw = rng.pareto(1.5, size=self.n_buckets) + 1.0
        self.bucket_tokens = (raw / raw.sum() * self.global_batch * self.seq_len).astype(
            np.int64
        )
        self.assignment, self.balance_iters = diffusion_assign_buckets(
            [float(t) for t in self.bucket_tokens], self.nranks
        )

    def rank_load(self) -> list[int]:
        load = [0] * self.nranks
        for b, r in enumerate(self.assignment):
            load[r] += int(self.bucket_tokens[b])
        return load

    def batches(self, steps: int):
        rng = np.random.default_rng(self.seed + 1)
        B, S = self.global_batch, self.seq_len
        for _ in range(steps):
            tokens = rng.integers(0, self.vocab, size=(B, S + 1), dtype=np.int64)
            yield {
                "tokens": tokens[:, :-1].astype(np.int32),
                "labels": tokens[:, 1:].astype(np.int32),
            }

    def structured_batches(self, steps: int):
        """Batches with a learnable structure (for loss-decreases tests):
        token t+1 = (token t + 1) mod vocab with noise."""
        rng = np.random.default_rng(self.seed + 2)
        B, S = self.global_batch, self.seq_len
        for _ in range(steps):
            start = rng.integers(0, self.vocab, size=(B, 1), dtype=np.int64)
            seq = (start + np.arange(S + 1)[None, :]) % self.vocab
            yield {
                "tokens": seq[:, :-1].astype(np.int32),
                "labels": seq[:, 1:].astype(np.int32),
            }
