"""The card's constants and the layouts the dry run reckons (counterpart
of ``repro.launch.mesh``).

The JAX package targets TPU v5e pods (16 x 16 and 2 x 16 x 16 meshes) and
builds them with ``make_production_mesh``.  The port runs on NVIDIA H100
SXM cards and has no device mesh to build: a layout is the axis-size
dict the sharding rules resolve against (``distributed.sharding``), so
this module holds the card's rates and sizes and the layouts by name,
and touches no device.
"""

from __future__ import annotations

from repro_torch.distributed.sharding import SERVE_AXIS

# H100 SXM constants (NVIDIA data sheet), per card.
PEAK_FLOPS_BF16 = 989e12  # dense bf16 FLOP/s
HBM_BW = 3.35e12          # HBM3 bytes/s
HBM_BYTES = 80e9          # device memory a card holds (80 GB)
NVLINK_BW = 450e9         # NVLink bytes/s in one direction

# Training layouts: {"data": d, "model": m} over 1, 2, 4 and 8 cards, what
# ``resolve_pspec`` takes (they stand in for the TPU meshes).
MESH_LAYOUTS: dict[str, dict[str, int]] = {
    "1x1": {"data": 1, "model": 1},
    "1x2": {"data": 1, "model": 2},
    "2x2": {"data": 2, "model": 2},
    "2x4": {"data": 2, "model": 4},
}

# Column-only serving pods of 1, 2, 4 and 8 members (``serve_pspec``).
POD_SIZES = (1, 2, 4, 8)
POD_LAYOUTS: dict[str, dict[str, int]] = {
    f"pod{n}": {SERVE_AXIS: n} for n in POD_SIZES}


def n_cards(axis_sizes: dict[str, int]) -> int:
    """Cards a layout spans: the product of its axis sizes."""
    n = 1
    for size in axis_sizes.values():
        n *= size
    return n
