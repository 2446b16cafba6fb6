"""Maximal Rectangles Algorithm (paper Alg. 2) for 2D GPU-node packing.

A node's spatio-temporal capacity is the rectangle ``W x H = 100% quota x
100% SMs``.  Each node keeps a list of *free* rectangles — maximal, possibly
overlapping, axis-aligned — representing resources available to new pods.

Placement of a pod rectangle ``F`` follows the paper exactly:

1. **Global best matching** (line 1): across all nodes, pick the free
   rectangle with the minimum ``Area(R) - Area(F)`` that fits ``F`` (the
   paper's ``secondCores`` best-area-fit).  Ties prefer lower node index,
   then bottom-left position, for determinism.
2. **PlaceAndNewJointRect** (line 5): place ``F`` at the bottom-left of the
   chosen rectangle and create the two *maximal* complement rectangles
   (right strip, full height; top strip, full width) — Fig. 6 left.
3. **Intersection update** (lines 8-14): every other free rectangle that
   intersects the placed pod is subdivided into up to four maximal
   complements — Fig. 6 right.
4. **Redundant-rectangle removal** (lines 15-19): free rectangles fully
   contained in another are dropped.
5. **Keep-restructure reclamation** (§3.4.2): freed pod rectangles are put
   back verbatim (cheap reuse by the same function); once the free list
   exceeds ``restructure_threshold``, the node is re-initialized to one
   ``W x H`` rectangle and the live pods are re-subtracted.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Optional

from repro_torch.core.resources import FULL_NODE, SCALE, Alloc, Rect, total_free_area


@dataclasses.dataclass(frozen=True)
class Placement:
    """A pod bound to a node at a concrete rectangle."""

    node: int
    rect: Rect
    pod_id: str


def _split_place_and_new_joint(free: Rect, w: int, h: int) -> tuple[Rect, Rect, Rect]:
    """Place a w*h pod at the bottom-left of ``free``; return (pod, R', R'').

    R' and R'' are the two *maximal* complements (paper Fig. 6): the right
    strip keeps the full height of ``free``; the top strip keeps its full
    width.  They overlap in the top-right corner by design — free rectangles
    are not mutually exclusive.
    """
    pod = Rect(free.x, free.y, w, h)
    right = Rect(free.x + w, free.y, free.w - w, free.h)
    top = Rect(free.x, free.y + h, free.w, free.h - h)
    return pod, right, top


def _subdivide(rect: Rect, hole: Rect) -> list[Rect]:
    """Maximal sub-rectangles of ``rect`` minus ``hole`` (paper ``Subdivide``).

    Up to four complements (left/right strips full height, bottom/top strips
    full width), each maximal in its direction.
    """
    inter = rect.intersection(hole)
    if inter is None:
        return [rect]
    out: list[Rect] = []
    if inter.x > rect.x:  # left
        out.append(Rect(rect.x, rect.y, inter.x - rect.x, rect.h))
    if inter.x2 < rect.x2:  # right
        out.append(Rect(inter.x2, rect.y, rect.x2 - inter.x2, rect.h))
    if inter.y > rect.y:  # bottom
        out.append(Rect(rect.x, rect.y, rect.w, inter.y - rect.y))
    if inter.y2 < rect.y2:  # top
        out.append(Rect(rect.x, inter.y2, rect.w, rect.y2 - inter.y2))
    return [r for r in out if not r.is_empty()]


def _prune_contained(rects: list[Rect]) -> list[Rect]:
    """Remove rectangles contained in another (paper lines 15-19)."""
    keep: list[Rect] = []
    for i, r in enumerate(rects):
        contained = False
        for j, other in enumerate(rects):
            if i == j:
                continue
            if other.contains(r) and not (r == other and i < j):
                contained = True
                break
        if not contained:
            keep.append(r)
    # Dedup identical rects (mutual containment keeps the first).
    seen: set[Rect] = set()
    out = []
    for r in keep:
        if r not in seen:
            seen.add(r)
            out.append(r)
    return out


class MaxRectsNode:
    """Free-rectangle bookkeeping for one accelerator node."""

    def __init__(self, node_id: int, restructure_threshold: int = 24):
        self.node_id = node_id
        self.free: list[Rect] = [FULL_NODE]
        self.placements: dict[str, Rect] = {}
        self.restructure_threshold = restructure_threshold
        self.restructure_count = 0
        self.offline = False  # cordoned: failed or straggling node

    # -- queries ---------------------------------------------------------

    def best_fit(self, w: int, h: int) -> Optional[Rect]:
        """Smallest-area free rectangle that fits w*h (best-area-fit)."""
        if self.offline:
            return None
        best: Optional[Rect] = None
        for r in self.free:
            if r.fits(w, h) and (best is None or r.area < best.area
                                 or (r.area == best.area and (r.y, r.x) < (best.y, best.x))):
                best = r
        return best

    def used_area(self) -> int:
        return sum(r.area for r in self.placements.values())

    def free_area(self) -> int:
        """Exact un-allocated area (free rects overlap; use union)."""
        return total_free_area(self.free)

    def fragmentation(self) -> float:
        """1 - (largest placeable rect area / total free area)."""
        free = self.free_area()
        if free == 0:
            return 0.0
        largest = max((r.area for r in self.free), default=0)
        return 1.0 - largest / free

    # -- mutation --------------------------------------------------------

    def place_in(self, target: Rect, pod_id: str, w: int, h: int) -> Rect:
        """Place pod into ``target`` (must be in the free list)."""
        if target not in self.free:
            raise ValueError(f"rect {target} not free on node {self.node_id}")
        pod, right, top = _split_place_and_new_joint(target, w, h)
        new_free = [r for r in self.free if r != target]
        new_free += [r for r in (right, top) if not r.is_empty()]
        # Intersection update against the placed pod rectangle.
        updated: list[Rect] = []
        for r in new_free:
            if r.intersects(pod):
                updated.extend(_subdivide(r, pod))
            else:
                updated.append(r)
        self.free = _prune_contained(updated)
        self.placements[pod_id] = pod
        return pod

    def release(self, pod_id: str) -> None:
        """Keep-restructure reclamation (§3.4.2)."""
        rect = self.placements.pop(pod_id)
        self.free.append(rect)
        self.free = _prune_contained(self.free)
        if len(self.free) > self.restructure_threshold:
            self.restructure()

    def restructure(self) -> None:
        """Re-initialize to W x H and re-subtract live pods."""
        self.restructure_count += 1
        free = [FULL_NODE]
        for pod in self.placements.values():
            nxt: list[Rect] = []
            for r in free:
                nxt.extend(_subdivide(r, pod) if r.intersects(pod) else [r])
            free = nxt
        self.free = _prune_contained(free)


class MaxRectsPool:
    """The paper's node-selection scheduler over ``n`` nodes (Alg. 2)."""

    def __init__(self, n_nodes: int, restructure_threshold: int = 24,
                 allow_grow: bool = True):
        self.nodes: list[MaxRectsNode] = [
            MaxRectsNode(i, restructure_threshold) for i in range(n_nodes)
        ]
        self.allow_grow = allow_grow
        self._seq = itertools.count()

    # -- Alg. 2 entry point ------------------------------------------------

    def schedule(self, alloc: Alloc, pod_id: str,
                 exclude: frozenset[int] | set[int] = frozenset()
                 ) -> Optional[Placement]:
        """Bind a pod to the globally best-fitting node rectangle.

        ``exclude`` skips nodes the caller found infeasible on other
        dimensions (e.g. memory admission).  Returns None when no rectangle
        fits and growing is disabled; otherwise grows the pool by one node
        ("A new GPU required").
        """
        w, h = alloc.width_m, alloc.height_m
        best: Optional[tuple[int, Rect]] = None
        for node in self.nodes:
            if node.node_id in exclude:
                continue
            r = node.best_fit(w, h)
            if r is None:
                continue
            # argmin over Area(R) - Area(F); Area(F) is constant, so this is
            # best-area-fit.  Ties go to the lowest node id (determinism).
            if best is None or r.area < best[1].area:
                best = (node.node_id, r)
        if best is None:
            if not self.allow_grow:
                return None
            node = MaxRectsNode(len(self.nodes),
                                self.nodes[0].restructure_threshold
                                if self.nodes else 24)
            self.nodes.append(node)
            best = (node.node_id, FULL_NODE)
        node_id, target = best
        pod = self.nodes[node_id].place_in(target, pod_id, w, h)
        return Placement(node=node_id, rect=pod, pod_id=pod_id)

    def schedule_batch(self, allocs: list[tuple[Alloc, str]]
                       ) -> list[Optional[Placement]]:
        """Schedule a batch largest-first (decreasing best-area-fit).

        Scaling events deliver pods in function order; packing them in
        descending ``secondCores`` order is the classic decreasing-fit
        refinement of 2D bin packing and is what lets the paper's Fig.-11
        mix (2x bert 60x50 + 2x rnnt + 4x resnet) land on a single node.
        Results are returned in the caller's original order.
        """
        order = sorted(range(len(allocs)),
                       key=lambda i: -allocs[i][0].second_cores)
        out: list[Optional[Placement]] = [None] * len(allocs)
        for i in order:
            alloc, pod_id = allocs[i]
            out[i] = self.schedule(alloc, pod_id)
        return out

    def release(self, placement: Placement) -> None:
        self.nodes[placement.node].release(placement.pod_id)

    def cordon(self, node_id: int) -> None:
        """Take a node out of scheduling (failure / straggler drain)."""
        self.nodes[node_id].offline = True

    def uncordon(self, node_id: int) -> None:
        self.nodes[node_id].offline = False

    def drain_node(self, node_id: int) -> list[str]:
        """Cordon a node and drop all its placements (node failure)."""
        node = self.nodes[node_id]
        node.offline = True
        evicted = list(node.placements)
        node.placements.clear()
        node.restructure()
        return evicted

    # -- metrics -----------------------------------------------------------

    def fragmentation(self) -> dict[int, float]:
        """Per-node MRA fragmentation (offline nodes excluded).

        A node reads 0.0 both when fully free and when fully packed; it
        rises when the free area is shattered into rectangles none of
        which is close to the whole — the signal the reconciler's
        defragmentation pass keys on.
        """
        return {n.node_id: n.fragmentation()
                for n in self.nodes if not n.offline}

    def node_load(self) -> dict[int, float]:
        """Per-node allocated-area fraction (offline nodes excluded)."""
        return {n.node_id: n.used_area() / (SCALE * SCALE)
                for n in self.nodes if not n.offline}

    def nodes_in_use(self) -> int:
        return sum(1 for n in self.nodes if n.placements)

    def utilization(self) -> float:
        """Mean fraction of capacity allocated across nodes in use."""
        used = [n.used_area() / (SCALE * SCALE) for n in self.nodes if n.placements]
        return sum(used) / len(used) if used else 0.0

    def total_used_area(self) -> int:
        return sum(n.used_area() for n in self.nodes)
