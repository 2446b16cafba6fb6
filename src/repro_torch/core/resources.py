"""2D spatio-temporal resource algebra.

The paper formalizes an accelerator's resources as a rectangle
``W x H = 100% quota x 100% compute`` (GPU: SMs; TPU: chips of a node, see
DESIGN.md §2).  Every allocation is an ``Alloc`` — a (spatial fraction,
temporal quota) pair — and every placed allocation occupies an axis-aligned
``Rect`` inside a node's resource rectangle.

All fractions live in integer **milli-units** (1000 == 100%) to keep the
rectangle arithmetic exact; the public API accepts floats in [0, 1].
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

SCALE = 1000  # milli-units per 100%


def to_milli(x: float) -> int:
    """Convert a [0, 1] fraction to integer milli-units (round-half-up)."""
    m = int(round(x * SCALE))
    if m < 0 or m > SCALE:
        raise ValueError(f"fraction {x} outside [0, 1]")
    return m


def from_milli(m: int) -> float:
    return m / SCALE


@dataclasses.dataclass(frozen=True)
class Alloc:
    """A spatio-temporal allocation request.

    Attributes:
      sm: spatial fraction in [0,1] (paper: ``sm_partition`` %SMs; here:
        the scheduler's accounting of an SM share of the card, which
        nothing bounds on the card yet: ROADMAP.md, "Beyond the
        reference", item 6).
      quota_request: guaranteed temporal quota per window (paper Q_request).
      quota_limit: elastic maximum temporal quota per window (paper Q_limit).
      mem_bytes: accelerator memory demand (paper ``gpu_mem``).
    """

    sm: float
    quota_request: float
    quota_limit: float
    mem_bytes: int = 0

    def __post_init__(self) -> None:
        if not (0.0 < self.sm <= 1.0):
            raise ValueError(f"sm partition {self.sm} outside (0, 1]")
        if not (0.0 < self.quota_request <= self.quota_limit <= 1.0):
            raise ValueError(
                f"need 0 < quota_request <= quota_limit <= 1, got "
                f"{self.quota_request}, {self.quota_limit}"
            )
        if self.mem_bytes < 0:
            raise ValueError("mem_bytes must be >= 0")

    @property
    def width_m(self) -> int:
        """Temporal footprint in milli-units (rectangle width = quota)."""
        return to_milli(self.quota_request)

    @property
    def height_m(self) -> int:
        """Spatial footprint in milli-units (rectangle height = SM/chips)."""
        return to_milli(self.sm)

    @property
    def second_cores(self) -> float:
        """Paper's uniform 2D size metric: ``Quota x SMs``."""
        return self.quota_request * self.sm


@dataclasses.dataclass(frozen=True)
class Rect:
    """Axis-aligned rectangle in the (quota, SM) plane, milli-units.

    ``x`` spans the temporal axis (width W = quota), ``y`` the spatial axis
    (height H = SM fraction), matching Fig. 6 of the paper.
    """

    x: int
    y: int
    w: int
    h: int

    def __post_init__(self) -> None:
        if self.w < 0 or self.h < 0:
            raise ValueError(f"negative extent: {self}")

    @property
    def x2(self) -> int:
        return self.x + self.w

    @property
    def y2(self) -> int:
        return self.y + self.h

    @property
    def area(self) -> int:
        return self.w * self.h

    def is_empty(self) -> bool:
        return self.w == 0 or self.h == 0

    def fits(self, w: int, h: int) -> bool:
        return self.w >= w and self.h >= h

    def contains(self, other: "Rect") -> bool:
        return (
            self.x <= other.x
            and self.y <= other.y
            and self.x2 >= other.x2
            and self.y2 >= other.y2
        )

    def intersects(self, other: "Rect") -> bool:
        return not (
            other.x >= self.x2
            or other.x2 <= self.x
            or other.y >= self.y2
            or other.y2 <= self.y
        )

    def intersection(self, other: "Rect") -> "Rect | None":
        if not self.intersects(other):
            return None
        x = max(self.x, other.x)
        y = max(self.y, other.y)
        return Rect(x, y, min(self.x2, other.x2) - x, min(self.y2, other.y2) - y)

    def cells(self) -> Iterator[tuple[int, int]]:  # pragma: no cover - debug aid
        for i in range(self.x, self.x2):
            for j in range(self.y, self.y2):
                yield (i, j)


FULL_NODE = Rect(0, 0, SCALE, SCALE)  # W x H = 100% quota x 100% SMs


def rect_for(alloc: Alloc, x: int, y: int) -> Rect:
    """Rectangle occupied by ``alloc`` when placed at (x, y)."""
    return Rect(x, y, alloc.width_m, alloc.height_m)


def total_free_area(rects: list[Rect]) -> int:
    """Exact area of the union of (possibly overlapping) free rectangles.

    Sweep-line over x with interval merging over y.  Used by tests and by the
    fragmentation metric; O(n^2 log n) is fine at control-plane sizes.
    """
    xs = sorted({r.x for r in rects} | {r.x2 for r in rects})
    area = 0
    for x0, x1 in zip(xs, xs[1:]):
        spans = sorted(
            (r.y, r.y2) for r in rects if r.x <= x0 and r.x2 >= x1
        )
        covered = 0
        cur_lo = cur_hi = None
        for lo, hi in spans:
            if cur_hi is None:
                cur_lo, cur_hi = lo, hi
            elif lo <= cur_hi:
                cur_hi = max(cur_hi, hi)
            else:
                covered += cur_hi - cur_lo
                cur_lo, cur_hi = lo, hi
        if cur_hi is not None:
            covered += cur_hi - cur_lo
        area += covered * (x1 - x0)
    return area
