"""Message-passing fabric for simulated distributed ranks, with accounting.

Every algorithm in :mod:`repro.core` is written against this interface: ranks
may only read their *own* state plus messages delivered by the fabric. This
keeps the implementation faithful to the paper's fully distributed algorithms
while allowing thousands of simulated ranks in one process.

The fabric counts, per rank and in total:

* point-to-point messages and bytes,
* collective participations and the bytes each rank must *hold* as a result
  (the paper's Table 1 quantity: allgather makes every rank hold Θ(N) bytes,
  allreduce only O(1)),
* communication rounds (supersteps).

These counters are the measured quantities behind EXPERIMENTS.md's
reproduction of the paper's scalability argument (§2.4.1 vs §2.4.2).

On a real machine this layer maps 1:1 onto MPI (send/recv, MPI_Allreduce,
MPI_Allgatherv) or, on a TPU pod, onto `jax.lax` collectives — see
DESIGN.md §3 for the mapping.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable

from ..telemetry import BYTES_BUCKETS, get_tracer

__all__ = ["CommStats", "Comm", "DeviceComm"]

_TR = get_tracer()

# Byte-size conventions for meta data (paper §2.4: "a few bytes of data").
BYTES_BLOCK_ID = 8          # block identifier (paper: 4-8 bytes per block)
BYTES_RANK = 4              # a process rank
BYTES_WEIGHT = 4            # a block weight (paper: 1-4 bytes)
BYTES_LEVEL = 1             # a block level / target-level
BYTES_FLOAT = 8
BYTES_COUNT = 4


@dataclass
class CommStats:
    nranks: int = 0
    rounds: int = 0
    exchange_rounds: int = 0  # p2p supersteps only (no collective latency)
    p2p_messages: int = 0
    p2p_bytes: int = 0
    allreduce_calls: int = 0
    allgather_calls: int = 0
    # bytes a single rank must hold/receive as a result of collectives:
    collective_bytes_per_rank: int = 0
    max_inbox_bytes_per_round: int = 0
    # per-rank p2p bytes sent (for peak/imbalance analysis)
    sent_bytes_by_rank: dict[int, int] = field(default_factory=lambda: defaultdict(int))

    def reset(self) -> None:
        self.rounds = 0
        self.exchange_rounds = 0
        self.p2p_messages = 0
        self.p2p_bytes = 0
        self.allreduce_calls = 0
        self.allgather_calls = 0
        self.collective_bytes_per_rank = 0
        self.max_inbox_bytes_per_round = 0
        self.sent_bytes_by_rank = defaultdict(int)

    @property
    def max_sent_bytes_per_rank(self) -> int:
        return max(self.sent_bytes_by_rank.values(), default=0)

    def summary(self) -> dict[str, float]:
        return {
            "nranks": self.nranks,
            "rounds": self.rounds,
            "exchange_rounds": self.exchange_rounds,
            "p2p_messages": self.p2p_messages,
            "p2p_bytes": self.p2p_bytes,
            "p2p_bytes_per_rank_avg": self.p2p_bytes / max(1, self.nranks),
            "p2p_bytes_per_rank_max": self.max_sent_bytes_per_rank,
            "allreduce_calls": self.allreduce_calls,
            "allgather_calls": self.allgather_calls,
            "collective_bytes_per_rank": self.collective_bytes_per_rank,
        }


class Comm:
    """Superstep message fabric for ``nranks`` simulated ranks."""

    def __init__(self, nranks: int):
        self.nranks = nranks
        self.stats = CommStats(nranks=nranks)
        self._outbox: dict[int, list[tuple[str, Any, int]]] = defaultdict(list)

    # -- point-to-point -------------------------------------------------------
    def send(self, src: int, dst: int, tag: str, payload: Any, nbytes: int) -> None:
        """Queue a message; delivered at the next :meth:`exchange` round."""
        assert 0 <= dst < self.nranks, (src, dst)
        self._outbox[dst].append((tag, payload, nbytes))
        self.stats.p2p_messages += 1
        self.stats.p2p_bytes += nbytes
        self.stats.sent_bytes_by_rank[src] += nbytes
        if _TR.enabled:
            _TR.metrics.counter("comm.p2p_bytes").inc(nbytes, src=src, dst=dst)
            _TR.metrics.counter("comm.p2p_messages").inc(src=src, dst=dst)
            _TR.metrics.histogram(
                "comm.p2p_message_bytes", buckets=BYTES_BUCKETS
            ).observe(nbytes)

    def exchange(self) -> dict[int, list[tuple[str, Any]]]:
        """Deliver all queued messages; one communication round (superstep)."""
        self.stats.rounds += 1
        self.stats.exchange_rounds += 1
        inbox: dict[int, list[tuple[str, Any]]] = defaultdict(list)
        max_inbox = 0
        for dst, msgs in self._outbox.items():
            inbox[dst] = [(tag, payload) for tag, payload, _ in msgs]
            max_inbox = max(max_inbox, sum(n for _, _, n in msgs))
        self.stats.max_inbox_bytes_per_round = max(
            self.stats.max_inbox_bytes_per_round, max_inbox
        )
        self._outbox = defaultdict(list)
        return inbox

    # -- collectives ------------------------------------------------------------
    def allreduce(self, per_rank_values: Iterable[Any], op: Callable[[Any, Any], Any], nbytes: int = 8) -> Any:
        """Global reduction; every rank receives the reduced value.

        Cost model: O(1) result bytes per rank, log(N) latency — the paper's
        two optional global reductions (§2.2, §2.4.2) use this.
        """
        self.stats.allreduce_calls += 1
        self.stats.rounds += max(1, (self.nranks - 1).bit_length())
        self.stats.collective_bytes_per_rank += nbytes
        if _TR.enabled:
            _TR.metrics.counter("comm.collectives").inc(kind="allreduce")
        it = iter(per_rank_values)
        acc = next(it)
        for v in it:
            acc = op(acc, v)
        return acc

    def allgather(self, per_rank_values: list[Any], nbytes_each: int) -> list[Any]:
        """Global gather; every rank receives every rank's contribution.

        Cost model: Θ(N)·nbytes_each held bytes per rank — this is the
        SFC balancer's scalability bottleneck measured in §5.1.2/Table 1.
        """
        self.stats.allgather_calls += 1
        self.stats.rounds += max(1, (self.nranks - 1).bit_length())
        self.stats.collective_bytes_per_rank += nbytes_each * self.nranks
        if _TR.enabled:
            _TR.metrics.counter("comm.collectives").inc(kind="allgather")
        return list(per_rank_values)

    def barrier(self) -> None:
        self.stats.rounds += 1


class DeviceComm(Comm):
    """Accounting fabric for the real device data plane (`device_sharded`).

    When ranks are XLA devices under ``shard_map``, halo payloads move as
    ``jax.lax.ppermute`` collectives *inside* the compiled program — the
    fabric never touches the bytes. This subclass keeps the control plane
    (AMR, balancing, migration) on the simulated :class:`Comm` superstep
    path unchanged, and adds :meth:`ppermute` so the stepping engine can
    attribute the in-program traffic into the same :class:`CommStats` and
    telemetry counters the Table-1 tests and trace reports read. ppermute is
    a *partial permutation* — pure point-to-point routing with no fan-in —
    so its bytes are accounted as p2p, never as collective held-bytes.

    ``pad_bytes`` tracks the wire overhead of equal-shape round payloads
    (shorter messages zero-padded to the round maximum); it is reported
    separately and deliberately kept out of ``p2p_bytes`` so the logical
    traffic stays byte-identical to the host-sharded plan.
    """

    def __init__(self, nranks: int):
        super().__init__(nranks)
        self.ppermute_rounds = 0
        self.ppermute_pad_bytes = 0

    def ppermute(
        self,
        messages: Iterable[Any],
        *,
        rounds: int = 1,
        pad_bytes: int = 0,
    ) -> None:
        """Account one substep's worth of in-program halo permutes.

        ``messages`` are :class:`~repro.lbm.halo.CompiledRankMessage`-likes
        (``src_rank``/``dst_rank``/``nbytes``); ``rounds`` is the number of
        ``ppermute`` calls the schedule needed (one per partial permutation).
        """
        inbox: dict[int, int] = defaultdict(int)
        for m in messages:
            self.stats.p2p_messages += 1
            self.stats.p2p_bytes += m.nbytes
            self.stats.sent_bytes_by_rank[m.src_rank] += m.nbytes
            inbox[m.dst_rank] += m.nbytes
            if _TR.enabled:
                _TR.metrics.counter("comm.p2p_bytes").inc(
                    m.nbytes, src=m.src_rank, dst=m.dst_rank
                )
                _TR.metrics.counter("comm.p2p_messages").inc(
                    src=m.src_rank, dst=m.dst_rank
                )
                _TR.metrics.histogram(
                    "comm.p2p_message_bytes", buckets=BYTES_BUCKETS
                ).observe(m.nbytes)
        self.stats.rounds += 1
        self.stats.exchange_rounds += 1
        self.stats.max_inbox_bytes_per_round = max(
            self.stats.max_inbox_bytes_per_round, max(inbox.values(), default=0)
        )
        self.ppermute_rounds += rounds
        self.ppermute_pad_bytes += pad_bytes
        if _TR.enabled:
            _TR.metrics.counter("comm.ppermute_rounds").inc(rounds)
            if pad_bytes:
                _TR.metrics.counter("comm.ppermute_pad_bytes").inc(pad_bytes)
