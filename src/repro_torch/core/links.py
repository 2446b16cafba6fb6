"""Inter-node network links: per-pair bandwidth for link-aware placement.

Helix (ASPLOS'25) models a serving cluster as a bandwidth-constrained
graph: where a multi-device pod lands matters because its per-round
collectives ride the slowest link in its device group.  ``NetworkLinks``
is that graph for both backends — the simulator folds it into
``ServiceCurve.round_time`` and the live frontend uses it to co-locate a
sharded pod's MRA rectangles on the highest-bandwidth group and to pick
the fastest peer for host-to-host weight transfers.

Bandwidths are symmetric bytes/second.  The default topology is uniform
(every pair at ``default_bps``), which keeps single-node fleets and older
tests unaffected; heterogeneous topologies are declared with
``set_link``.
"""

from __future__ import annotations

import itertools
from typing import Iterable, Optional, Sequence

# One NVLink-ish default: high enough that the all-reduce term is small
# but non-zero, so the link model is exercised whenever it is enabled.
DEFAULT_LINK_BPS = 16 * (1 << 30)  # 16 GiB/s


def _key(a: int, b: int) -> tuple[int, int]:
    return (a, b) if a <= b else (b, a)


class NetworkLinks:
    """Symmetric per-pair bandwidth table over ``n_nodes`` nodes."""

    def __init__(self, n_nodes: int, default_bps: float = DEFAULT_LINK_BPS):
        if n_nodes < 1:
            raise ValueError(f"n_nodes must be >= 1, got {n_nodes}")
        if default_bps <= 0:
            raise ValueError(f"default_bps must be > 0, got {default_bps}")
        self.n_nodes = n_nodes
        self.default_bps = float(default_bps)
        self._bps: dict[tuple[int, int], float] = {}

    # -- declaration -------------------------------------------------------

    def set_link(self, a: int, b: int, bps: float) -> None:
        if a == b:
            raise ValueError("no self-links")
        if bps <= 0:
            raise ValueError(f"bandwidth must be > 0, got {bps}")
        self._bps[_key(a, b)] = float(bps)

    def grow(self, n_nodes: int) -> None:
        """Extend the node count (new pairs read the default)."""
        self.n_nodes = max(self.n_nodes, n_nodes)

    # -- queries -----------------------------------------------------------

    def bandwidth(self, a: int, b: int) -> float:
        if a == b:
            return float("inf")  # same device: no wire
        return self._bps.get(_key(a, b), self.default_bps)

    def pairs(self) -> dict[tuple[int, int], float]:
        """Every (a < b) pair's bandwidth — the ``Backend.links()`` payload."""
        return {
            (a, b): self.bandwidth(a, b)
            for a, b in itertools.combinations(range(self.n_nodes), 2)
        }

    def bottleneck(self, nodes: Iterable[int]) -> float:
        """Slowest pairwise link inside a device group (the collective's
        effective bandwidth under a ring all-reduce)."""
        ns = sorted(set(nodes))
        if len(ns) < 2:
            return float("inf")
        return min(self.bandwidth(a, b)
                   for a, b in itertools.combinations(ns, 2))

    def best_peer(self, target: int,
                  candidates: Iterable[int]) -> Optional[int]:
        """Candidate with the highest bandwidth to ``target`` (ties to the
        lowest node id, for determinism)."""
        cands = sorted(c for c in set(candidates) if c != target)
        if not cands:
            return None
        return max(cands, key=lambda c: (self.bandwidth(target, c), -c))

    def best_groups(self, candidates: Sequence[int],
                    k: int) -> list[tuple[int, ...]]:
        """All k-subsets of ``candidates``, best collective group first:
        descending bottleneck bandwidth, then descending total bandwidth,
        then ascending ids (deterministic).  The placement loop walks this
        order and takes the first group whose every member admits."""
        cands = sorted(set(candidates))
        if k > len(cands):
            return []
        groups = list(itertools.combinations(cands, k))

        def score(g: tuple[int, ...]) -> tuple[float, float]:
            total = sum(self.bandwidth(a, b)
                        for a, b in itertools.combinations(g, 2))
            return (-self.bottleneck(g), -total)

        return sorted(groups, key=lambda g: (score(g), g))
