"""Fully distributed diffusion-based dynamic load balancing (paper §2.4.2).

Two nested iteration levels (paper Alg. 2):

* **flow iterations** — Cybenko's first-order diffusion scheme [18] on the
  distributed process graph with Boillat's edge weights [6]
  ``alpha_ij = 1 / (max(d_i, d_j) + 1)``, computable with next-neighbor
  communication only. They produce the desired load flow ``f_ij`` over every
  process-graph edge (no blocks move yet).
* **main iterations** — after the flow is known, the **push** (Alg. 3) or
  **pull** (Alg. 4) scheme matches whole blocks against the per-edge flows,
  the framework migrates the chosen proxy blocks, and the procedure repeats.
  Alternating push/pull is supported (the paper's "push/pull" configuration).

Per-level balancing (required by the LBM, §3.2) computes loads and flows per
level over the *same* process graph; the candidate blocks for migration are
restricted to the level being balanced.

Every step uses next-neighbor communication only; with a fixed number of
iterations, runtime and memory per rank are independent of the total number
of ranks. Two optional global reductions (total load; balanced-yet flag)
enable early termination — exactly the paper's two reductions.

Block-selection details follow the paper: only blocks *adjacent to the
receiving rank* are candidates ("can be moved to process j"), and among
multiple candidates the block with the weakest connection to its own rank
and the strongest connection to the receiver is preferred, where connection
strength weighs face > edge > corner contacts.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable

from ..comm import BYTES_BLOCK_ID, BYTES_FLOAT, BYTES_RANK, BYTES_WEIGHT, Comm
from ..forest import Block, BlockForest
from .base import is_balanced_per_level, max_level_in_use

__all__ = ["DiffusionBalancer"]

_STRENGTH = {"face": 4.0, "edge": 2.0, "corner": 1.0}
_EPS = 1e-9


def _connection_strengths(
    geom, blk: Block, local_bids: set[int], marked: set[int]
) -> dict[int, float]:
    """Strength of blk's connection to each rank owning one of its neighbors
    (own rank keyed by -1; marked-for-migration blocks excluded from own)."""
    out: dict[int, float] = {}
    for nb, owner in blk.neighbors.items():
        s = _STRENGTH[geom.adjacency_kind(blk.bid, nb)]
        if nb in local_bids and nb not in marked:
            out[-1] = out.get(-1, 0.0) + s
        else:
            out[owner] = out.get(owner, 0.0) + s
    return out


@dataclass
class DiffusionBalancer:
    """Iterative local balancer: push / pull / alternating push-pull."""

    mode: str = "push"  # "push" | "pull" | "pushpull"
    flow_iterations: int = 15  # paper: 15 (push-only), 5 (alternating)
    max_main_iterations: int = 20
    per_level: bool = True
    use_global_reductions: bool = True  # the two optional reductions
    tolerance: float = 0.0
    # filled in by __call__ for introspection/benchmarks:
    last_balanced: bool = field(default=False, init=False)
    _last_progress: bool = field(default=True, init=False)
    # per-main-iteration flow snapshots (property tests pin their invariants):
    # raw Cybenko flows are exactly antisymmetric (f_ij = -f_ji, so every
    # edge's flow sums to zero globally); the adjusted flows bound how much
    # block weight the push/pull selection may move per edge direction.
    last_flows_raw: list[dict[int, list[float]]] = field(default_factory=list, init=False)
    last_flows: list[dict[int, list[float]]] = field(default_factory=list, init=False)

    # -- helpers -----------------------------------------------------------------
    def _neighbor_ranks(self, proxy: BlockForest, r: int) -> list[int]:
        return sorted(proxy.neighbor_ranks(r))

    def _loads(self, proxy: BlockForest, r: int, levels: range) -> list[float]:
        w = [0.0] * len(levels)
        for b in proxy.local_blocks(r).values():
            w[b.level] += b.weight
        return w

    # -- main entry ---------------------------------------------------------------
    def __call__(
        self, proxy: BlockForest, comm: Comm, iteration: int
    ) -> tuple[list[dict[int, int]], bool]:
        R = proxy.nranks
        geom = proxy.geom
        max_level = max_level_in_use(proxy, comm)
        levels = range(max_level + 1) if self.per_level else range(1)

        # -- process graph + degrees (next-neighbor exchange of d_i) ---------
        nbrs = [self._neighbor_ranks(proxy, r) for r in range(R)]
        deg = [len(n) for n in nbrs]
        for r in range(R):
            for j in nbrs[r]:
                comm.send(r, j, "deg", (r, deg[r]), nbytes=BYTES_RANK + BYTES_RANK)
        inbox = comm.exchange()
        deg_of: list[dict[int, int]] = [dict() for _ in range(R)]
        for dst, msgs in inbox.items():
            for _tag, (src, d) in msgs:
                deg_of[dst][src] = d

        # -- per-level process loads ------------------------------------------
        if self.per_level:
            w = [self._loads(proxy, r, levels) for r in range(R)]
        else:
            w = [[sum(b.weight for b in proxy.local_blocks(r).values())] for r in range(R)]
        w_cur = [list(x) for x in w]

        # -- flow iterations (Alg. 2 lines 9-17) -------------------------------
        flows: list[dict[int, list[float]]] = [
            {j: [0.0] * len(levels) for j in nbrs[r]} for r in range(R)
        ]
        alpha = [
            {j: 1.0 / (max(deg[r], deg_of[r][j]) + 1.0) for j in nbrs[r]}
            for r in range(R)
        ]
        w_nb0: list[dict[int, list[float]]] = [dict() for _ in range(R)]
        for it in range(self.flow_iterations):
            for r in range(R):
                for j in nbrs[r]:
                    # copy: a real message is a snapshot of the sender's state
                    # at send time — passing the live list would let later
                    # ranks observe mid-superstep updates (and break the
                    # f_ij = -f_ji antisymmetry of Cybenko's scheme)
                    comm.send(r, j, "w", (r, list(w_cur[r])),
                              nbytes=BYTES_RANK + BYTES_FLOAT * len(levels))
            inbox = comm.exchange()
            w_nb: list[dict[int, list[float]]] = [dict() for _ in range(R)]
            for dst, msgs in inbox.items():
                for _tag, (src, wv) in msgs:
                    w_nb[dst][src] = wv
            if it == 0:
                w_nb0 = w_nb  # original neighbor loads (for the avg adjustment)
            for r in range(R):
                delta = [0.0] * len(levels)
                for j in nbrs[r]:
                    for li in range(len(levels)):
                        fp = alpha[r][j] * (w_cur[r][li] - w_nb[r][j][li])
                        flows[r][j][li] += fp
                        delta[li] += fp
                for li in range(len(levels)):
                    w_cur[r][li] -= delta[li]

        self.last_flows_raw = [
            {j: list(v) for j, v in flows[r].items()} for r in range(R)
        ]

        # -- optional global reduction #1: exact global average (paper) --------
        # "This information can be used to adapt the process local
        #  inflow/outflow values with respect to the exact globally average
        #  process load."  Crucially this CAPS each rank's accumulated
        # outflow (inflow) at its exact excess (deficit) over the average:
        # the sum of all excesses equals the total imbalance, so uncoordinated
        # senders can never swamp a common underloaded neighbor (observed
        # oscillation otherwise), and a stalled rank whose per-edge flows are
        # all smaller than one block weight still pushes its excess along the
        # steepest edges. The per-edge flows remain pure Cybenko clues.
        avg = None
        if self.use_global_reductions:
            totals = comm.allreduce(
                (list(x) for x in w),
                lambda a, b: [x + y for x, y in zip(a, b)],
                nbytes=BYTES_FLOAT * len(levels),
            )
            avg = [t / R for t in totals]
            # Adjust the per-edge flows w.r.t. the exact global average
            # (paper §2.4.2). Two rules keep the iteration stable AND free of
            # granularity stalls:
            #   (a) no edge may carry more than HALF the pairwise load gap —
            #       sending more would invert the pair and oscillate;
            #   (b) each rank's total outflow is budgeted by its exact excess
            #       over the average; any part of that budget the converged
            #       Cybenko flows do not cover is granted to the remaining
            #       downhill-edge capacity, steepest edge first (this is what
            #       melts load plateaus at block granularity).
            # The sum of all excesses equals the global imbalance, so the
            # total traffic per main iteration stays bounded.
            for r in range(R):
                if not nbrs[r]:
                    continue
                for li in range(len(levels)):
                    gaps = {
                        j: max(0.0, (w[r][li] - w_nb0[r].get(j, w[r])[li]) / 2.0)
                        for j in nbrs[r]
                    }
                    excess = w[r][li] - avg[li]
                    if excess > _EPS:
                        f_sel = {
                            j: min(max(flows[r][j][li], 0.0), gaps[j]) for j in nbrs[r]
                        }
                        rem = excess - sum(f_sel.values())
                        if rem > _EPS:
                            for j in sorted(gaps, key=lambda x: -gaps[x]):
                                room = gaps[j] - f_sel[j]
                                if room <= _EPS:
                                    continue
                                grant = min(room, rem)
                                f_sel[j] += grant
                                rem -= grant
                                if rem <= _EPS:
                                    break
                        for j in nbrs[r]:
                            if flows[r][j][li] > 0 or f_sel[j] > 0:
                                flows[r][j][li] = f_sel[j]
                    elif excess < -_EPS:
                        deficit = -excess
                        ugaps = {
                            j: max(0.0, (w_nb0[r].get(j, w[r])[li] - w[r][li]) / 2.0)
                            for j in nbrs[r]
                        }
                        f_sel = {
                            j: min(max(-flows[r][j][li], 0.0), ugaps[j])
                            for j in nbrs[r]
                        }
                        rem = deficit - sum(f_sel.values())
                        if rem > _EPS:
                            for j in sorted(ugaps, key=lambda x: -ugaps[x]):
                                room = ugaps[j] - f_sel[j]
                                if room <= _EPS:
                                    continue
                                grant = min(room, rem)
                                f_sel[j] += grant
                                rem -= grant
                                if rem <= _EPS:
                                    break
                        for j in nbrs[r]:
                            if flows[r][j][li] < 0 or f_sel[j] > 0:
                                flows[r][j][li] = -f_sel[j]

        self.last_flows = [{j: list(v) for j, v in flows[r].items()} for r in range(R)]

        # -- block selection: push (Alg. 3) or pull (Alg. 4) -------------------
        use_pull = self.mode == "pull" or (self.mode == "pushpull" and iteration % 2 == 1)
        assignments: list[dict[int, int]] = [dict() for _ in range(R)]
        if not use_pull:
            for r in range(R):
                self._push(proxy, geom, r, flows[r], levels, assignments[r],
                           w[r], avg, w_nb0[r])
        else:
            self._pull(proxy, comm, geom, flows, nbrs, levels, assignments,
                       w, avg)

        # inform neighbor processes about the blocks about to be sent
        # (Alg. 2 line 19), extended into an accept/deny handshake for the
        # push scheme: a receiver accepts offers only up to its own deficit
        # below the global average plus one block of granularity. Without
        # this, many senders whose steepest downhill edge points at the same
        # underloaded rank swamp it and the iteration oscillates (receivers
        # in the pull scheme already control their inflow by construction).
        if not use_pull and avg is not None:
            for r in range(R):
                by_recv: dict[int, list] = {}
                for bid, j in assignments[r].items():
                    blk = proxy.local_blocks(r)[bid]
                    by_recv.setdefault(j, []).append(
                        (bid, blk.weight, blk.level if self.per_level else 0)
                    )
                for j, items in by_recv.items():
                    comm.send(r, j, "offer", (r, items, list(w[r])),
                              nbytes=len(items) * (BYTES_BLOCK_ID + BYTES_WEIGHT)
                              + BYTES_FLOAT * len(levels))
            inbox = comm.exchange()
            denies: list[list[tuple[int, int]]] = [[] for _ in range(R)]
            for dst, msgs in inbox.items():
                w_dst = list(w[dst])
                for _tag, (src, items, w_src) in msgs:
                    w_rem = list(w_src)
                    for bid, wgt, li in items:
                        # accept only if the pairwise imbalance strictly
                        # improves (sum-of-squares potential descends) —
                        # guarantees quiescence, no churn, no swamping
                        if w_dst[li] + wgt <= w_rem[li] - wgt + _EPS:
                            w_dst[li] += wgt
                            w_rem[li] -= wgt
                        else:
                            denies[dst].append((src, bid))
            for dst in range(R):
                for src, bid in denies[dst]:
                    comm.send(dst, src, "deny", bid, nbytes=BYTES_BLOCK_ID)
            inbox = comm.exchange()
            for dst, msgs in inbox.items():
                for _tag, bid in msgs:
                    assignments[dst].pop(bid, None)
        else:
            for r in range(R):
                for j in nbrs[r]:
                    comm.send(r, j, "notice", bool(assignments[r]), nbytes=1)
            comm.exchange()

        # -- optional global reduction #2: early termination --------------------
        if self.use_global_reductions:
            # NOTE: checked on the *pre-migration* state; the pipeline applies
            # the assignments afterwards, so "balanced" means no moves needed.
            balanced = is_balanced_per_level(proxy, comm, levels, self.tolerance)
            progress = any(assignments[r] for r in range(R))
            if iteration == 0:
                self._last_progress = True
            # stop only after TWO fruitless rounds: in alternating push/pull a
            # fruitless pull can precede a productive push (and vice versa).
            stalled = not progress and not self._last_progress
            self.last_balanced = balanced and not progress
            again = (
                not self.last_balanced
                and not stalled
                and (iteration + 1) < self.max_main_iterations
            )
            self._last_progress = progress
        else:
            again = (iteration + 1) < self.max_main_iterations
        return assignments, again

    # -- Alg. 3: push scheme ---------------------------------------------------
    def _push(
        self,
        proxy: BlockForest,
        geom,
        r: int,
        flow: dict[int, list[float]],
        levels: range,
        out: dict[int, int],
        w_r: list[float] | None = None,
        avg: list[float] | None = None,
        w_nb0: dict[int, list[float]] | None = None,
    ) -> None:
        local = proxy.local_blocks(r)
        local_bids = set(local)
        marked: set[int] = set()
        for li in range(len(levels)):
            f = {j: fl[li] for j, fl in flow.items()}
            outflow = sum(v for v in f.values() if v > 0)
            if avg is not None:
                # budget: the exact excess over the global average (paper).
                # Churn/swamping control is the receiver-side strict-descent
                # handshake, so no granularity band is needed here.
                outflow = min(outflow, max(0.0, w_r[li] - avg[li]))
            while outflow > _EPS and any(v > _EPS for v in f.values()):
                j = max(f, key=lambda k: f[k])
                if f[j] <= _EPS:
                    break
                # blocks that can be moved to j: correct level, unmarked,
                # weight within the accumulated outflow. Connection strength
                # (strong to j, weak to i) only *ranks* the candidates — the
                # flows are "clues", not hard constraints (paper §2.4.2).
                # sender-side survivability: a block heavier than half the
                # pairwise load gap would be denied by the receiver handshake
                # anyway — filter it here so the round is not wasted on it.
                gap_cap = None
                if avg is not None and w_nb0 is not None and j in w_nb0:
                    gap_cap = (w_r[li] - w_nb0[j][li]) / 2.0
                best = None
                best_score = None
                for bid, blk in local.items():
                    if bid in marked or (self.per_level and blk.level != li):
                        continue
                    if blk.weight > outflow + _EPS:
                        continue
                    if gap_cap is not None and blk.weight > gap_cap + _EPS:
                        continue
                    s = _connection_strengths(geom, blk, local_bids, marked)
                    score = s.get(j, 0.0) - s.get(-1, 0.0)
                    if best_score is None or score > best_score:
                        best, best_score = bid, score
                if best is None:
                    f[j] = 0.0
                    continue
                blk = local[best]
                marked.add(best)
                out[best] = j
                f[j] -= blk.weight
                outflow -= blk.weight

    # -- Alg. 4: pull scheme -----------------------------------------------------
    def _pull(
        self,
        proxy: BlockForest,
        comm: Comm,
        geom,
        flows: list[dict[int, list[float]]],
        nbrs: list[list[int]],
        levels: range,
        assignments: list[dict[int, int]],
        w: list[list[float]] | None = None,
        avg: list[float] | None = None,
    ) -> None:
        R = proxy.nranks
        # line 6: send (block id, weight) lists to all neighbor processes
        for r in range(R):
            items = [(b.bid, b.weight, b.level) for b in proxy.local_blocks(r).values()]
            for j in nbrs[r]:
                comm.send(r, j, "blist", (r, items),
                          nbytes=len(items) * (BYTES_BLOCK_ID + BYTES_WEIGHT))
        inbox = comm.exchange()
        remote: list[dict[int, list[tuple[int, float, int]]]] = [dict() for _ in range(R)]
        for dst, msgs in inbox.items():
            for _tag, (src, items) in msgs:
                remote[dst][src] = items

        # lines 7-18: bookmark remote blocks to fetch
        requests: list[dict[int, list[int]]] = [dict() for _ in range(R)]
        for r in range(R):
            local = proxy.local_blocks(r)
            local_bids = set(local)
            # adjacency of remote candidate blocks to me, with strengths
            adj_strength: dict[int, float] = {}
            for blk in local.values():
                for nb, owner in blk.neighbors.items():
                    if owner != r:
                        adj_strength[nb] = adj_strength.get(nb, 0.0) + _STRENGTH[
                            geom.adjacency_kind(blk.bid, nb)
                        ]
            bookmarked: set[int] = set()
            for li in range(len(levels)):
                f = {j: fl[li] for j, fl in flows[r].items()}
                inflow = -sum(v for v in f.values() if v < 0)
                if avg is not None:
                    # cap at the exact deficit below the global average
                    inflow = min(inflow, max(0.0, avg[li] - w[r][li]))
                while inflow > _EPS and any(v < -_EPS for v in f.values()):
                    j = min(f, key=lambda k: f[k])
                    if f[j] >= -_EPS:
                        break
                    best = None
                    best_score = None
                    best_w = 0.0
                    for bid, wgt, lvl in remote[r].get(j, ()):
                        if bid in bookmarked or (self.per_level and lvl != li):
                            continue
                        if wgt > inflow + _EPS:
                            continue
                        score = adj_strength.get(bid, 0.0)
                        if best_score is None or score > best_score:
                            best, best_score, best_w = bid, score, wgt
                    if best is None:
                        f[j] = 0.0
                        continue
                    bookmarked.add(best)
                    requests[r].setdefault(j, []).append(best)
                    f[j] += best_w
                    inflow -= best_w

        # line 19: send requests (annotated with the requester's loads so the
        # owner can grant on strict pairwise improvement — same quiescence
        # guarantee as the push handshake)
        for r in range(R):
            for j, bids in requests[r].items():
                comm.send(r, j, "req", (r, bids, list(w[r]) if w else None),
                          nbytes=len(bids) * BYTES_BLOCK_ID)
        inbox = comm.exchange()
        # lines 20-26: grant requests; ties go to the requester with the
        # largest outflow f_ij from the owner's perspective
        for dst, msgs in inbox.items():
            wanted: dict[int, list[int]] = {}
            w_req: dict[int, list[float] | None] = {}
            for _tag, (src, bids, w_src) in msgs:
                w_req[src] = list(w_src) if w_src is not None else None
                for bid in bids:
                    wanted.setdefault(bid, []).append(src)
            local = proxy.local_blocks(dst)
            w_own = list(w[dst]) if w else None
            for bid, srcs in wanted.items():
                if bid not in local or bid in assignments[dst]:
                    continue
                lvl_idx = local[bid].level if self.per_level else 0
                pick = max(srcs, key=lambda s: flows[dst].get(s, [0.0] * (lvl_idx + 1))[lvl_idx])
                wgt = local[bid].weight
                if w_own is not None and w_req.get(pick) is not None:
                    if w_req[pick][lvl_idx] + wgt > w_own[lvl_idx] - wgt + _EPS:
                        continue  # would not strictly improve: deny
                    w_own[lvl_idx] -= wgt
                    w_req[pick][lvl_idx] += wgt
                assignments[dst][bid] = pick
