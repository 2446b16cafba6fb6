"""The bf16 decode kernels' host-side plan and binding, held on the CPU:
the split of S that ``cluster_plan`` gives a launch (every tile once, at
most one cluster of splits, the same for dense and paged caches, planned
by ``plan_kv``), the cluster limit against the kernel source's, and
every C entry point's ctypes signature against its parameter list.  The
kernels themselves run only on the card (``tests/test_torch_gpu.py``).
"""

import re

import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels import decode_attention as da

SHAPES = [(8, 4, 64), (1, 4, 64), (1, 1, 4096), (3, 5, 64), (16, 4, 4),
          (2, 1, 256), (8, 16, 128), (64, 8, 256), (128, 4, 1), (1, 28, 7)]


def _kernel_constant(name: str) -> int:
    src = (build.CSRC / "decode_attention.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


@pytest.mark.parametrize("b,n_kv,n_tiles", SHAPES)
def test_cluster_plan_covers_every_tile_once(b, n_kv, n_tiles):
    """Split i walks tiles [i * per, (i + 1) * per): the splits cover the
    n_tiles tiles, each once, none of them empty, in at most one cluster
    (``MAX_CLUSTER``) and no more splits than ``split_plan`` gives."""
    per, n_split = da.cluster_plan(b, n_kv, n_tiles)
    covered = [t for i in range(n_split)
               for t in range(i * per, min((i + 1) * per, n_tiles))]
    assert covered == list(range(n_tiles))
    assert per * (n_split - 1) < n_tiles
    assert 1 <= n_split <= min(n_tiles, da.MAX_CLUSTER)
    assert n_split <= da.split_plan(b, n_kv, n_tiles)[1]


def test_cluster_limit_is_the_kernels():
    """The plan's cluster limit is one the kernel takes (``kMaxCluster``,
    past the portable 8 with the non-portable attribute)."""
    assert 8 <= da.MAX_CLUSTER <= _kernel_constant("kMaxCluster") == 16
    assert da.DENSE_TILE == _kernel_constant("kTile")
    assert da.MAX_GROUP == _kernel_constant("kMaxG")


def test_cluster_plan_at_the_main_shape():
    """About ``CLUSTER_CTAS`` (two an SM) CTAs, in whole clusters:
    qwen2-7b's round (B=8, S=1024, 4 kv heads: 64 tiles) in 8 splits of
    8 tiles, 256 CTAs (``split_plan``: 16 splits, 512 CTAs); a single
    sequence in one full cluster of 16; many sequences and heads in
    fewer splits than a cluster holds."""
    assert da.CLUSTER_CTAS == 2 * 132 and da.MAX_CLUSTER == 16
    assert da.cluster_plan(8, 4, 64) == (8, 8)
    assert da.split_plan(8, 4, 64) == (4, 16)
    assert da.cluster_plan(1, 4, 64) == (4, 16)
    assert da.cluster_plan(8, 16, 128) == (43, 3)  # gemma3's global layers
    assert da.cluster_plan(8, 4, 0) == (1, 1)
    assert da.cluster_plan(64, 8, 256) == (256, 1)
    for b, n_kv, n_tiles in SHAPES:
        per, n_split = da.cluster_plan(b, n_kv, n_tiles)
        if n_split < min(n_tiles, da.MAX_CLUSTER):
            assert b * n_kv * n_split <= da.CLUSTER_CTAS + b * n_kv


@pytest.mark.parametrize("bs", [1, 3, 8, 16, 32, 64])
def test_bf16_dense_and_paged_plan_alike(bs):
    """The bf16 kernels walk tiles of 16 logical rows whatever the page
    size: a paged cache of M * bs = S rows gets the dense cache's plan
    (the condition of their bit-identity on the card), while the int8
    wrappers keep ``split_plan``."""
    for b, n_kv, s in [(8, 4, 1024), (1, 4, 960), (3, 5, 1536), (2, 1, 192)]:
        m = s // bs
        dense = torch.empty(b, s, n_kv, 128, device="meta")
        pages = torch.empty(1 + b * m, bs, n_kv, 128, device="meta")
        tables = torch.empty(b, m, dtype=torch.int32, device="meta")
        plan = da.decode_plan(dense, plan=da.cluster_plan)
        assert da.decode_plan(pages, tables, plan=da.cluster_plan) == plan
        assert plan == da.cluster_plan(b, n_kv, da.row_tiles(s))
        assert da.decode_plan(dense) == da.split_plan(b, n_kv,
                                                      da.row_tiles(s))


@pytest.mark.parametrize("shards", [2, 4])
def test_member_cluster_plan_is_the_whole_launchs(shards):
    """A pod member's bf16 launch planned for the model's kv heads
    (``plan_kv``) splits S as the whole launch does, dense and paged; for
    its own heads it may split otherwise (qwen2-moe-a2.7b's round, 16 kv
    heads)."""
    whole = torch.empty(8, 1024, 16, 128, device="meta")
    member = torch.empty(8, 1024, 16 // shards, 128, device="meta")
    tables = torch.empty(8, 64, dtype=torch.int32, device="meta")
    pages = torch.empty(513, 16, 16 // shards, 128, device="meta")
    plan = da.decode_plan(whole, plan=da.cluster_plan)
    assert da.decode_plan(member, plan_kv=16, plan=da.cluster_plan) == plan
    assert da.decode_plan(pages, tables, 16, da.cluster_plan) == plan
    assert da.decode_plan(member, plan=da.cluster_plan) != plan


_C_TYPES = {"int": "c_int", "float": "c_float"}


def _c_params(src: str, name: str) -> list[str]:
    """The ctypes type names of entry point ``name``'s parameters."""
    params = re.search(rf'extern "C" int {name}\(([^)]*)\)', src).group(1)
    out = []
    for param in params.split(","):
        words = param.replace("*", " * ").split()
        out.append("c_void_p" if "*" in words else _C_TYPES[words[-2]])
    return out


def test_every_signature_matches_its_c_parameters():
    """Each entry point's ctypes signature has its C parameters' count
    and kinds (a pointer or the stream as c_void_p, an int as c_int, a
    float as c_float): a mismatch passes garbage without an error."""
    src = "\n".join(p.read_text() for p in build.CSRC.glob("*.cu"))
    for name, argtypes in build.SIGNATURES.items():
        assert [t.__name__ for t in argtypes] == _c_params(src, name), name
