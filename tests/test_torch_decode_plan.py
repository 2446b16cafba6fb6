"""The decode kernels' host-side plan and binding, held on the CPU: the
split of S that ``cluster_plan`` gives a launch (every tile once, at most
one cluster of splits, the same for dense and paged caches and for bf16
and int8, planned by ``plan_kv``), the cluster limit against the kernel
source's, every C entry point's ctypes signature against its parameter
list, and the arithmetic identity the int8 kernels widen their codes by.
The kernels themselves run only on the card (``tests/test_torch_gpu.py``).
"""

import re

import numpy as np
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
    (``MAX_CLUSTER``) and no more splits than about ``CLUSTER_CTAS`` CTAs
    need."""
    per, n_split = da.cluster_plan(b, n_kv, n_tiles)
    covered = [t for i in range(n_split)
               for t in range(i * per, min((i + 1) * per, n_tiles))]
    assert covered == list(range(n_tiles))
    assert per * (n_split - 1) < n_tiles
    assert 1 <= n_split <= min(n_tiles, da.MAX_CLUSTER)
    assert n_split <= max(1, -(-da.CLUSTER_CTAS // (b * n_kv)))


def test_cluster_limit_is_the_kernels():
    """The plan's cluster limit is one the kernel takes (``kMaxCluster``,
    past the portable 8 with the non-portable attribute)."""
    assert 8 <= da.MAX_CLUSTER <= _kernel_constant("kMaxCluster") == 16
    assert da.DENSE_TILE == _kernel_constant("kTile")
    assert da.MAX_GROUP == _kernel_constant("kMaxG")


def test_cluster_plan_at_the_main_shape():
    """About ``CLUSTER_CTAS`` (two an SM) CTAs, in whole clusters:
    qwen2-7b's round (B=8, S=1024, 4 kv heads: 64 tiles) in 8 splits of
    8 tiles, 256 CTAs, where 16 splits of 4 would ask 512; a single
    sequence in one full cluster of 16; many sequences and heads in
    fewer splits than a cluster holds."""
    assert da.CLUSTER_CTAS == 2 * 132 and da.MAX_CLUSTER == 16
    assert da.cluster_plan(8, 4, 64) == (8, 8)
    assert 8 * 4 * 16 > da.CLUSTER_CTAS + 8 * 4
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
    (the condition of their bit-identity on the card), and so do the
    int8 wrappers' code caches and pages."""
    for b, n_kv, s in [(8, 4, 1024), (1, 4, 960), (3, 5, 1536), (2, 1, 192)]:
        m = s // bs
        dense = torch.empty(b, s, n_kv, 128, device="meta")
        pages = torch.empty(1 + b * m, bs, n_kv, 128, device="meta")
        tables = torch.empty(b, m, dtype=torch.int32, device="meta")
        plan = da.decode_plan(dense)
        assert da.decode_plan(pages, tables) == plan
        assert plan == da.cluster_plan(b, n_kv, da.row_tiles(s))
        codes, code_pages = (x.to(torch.int8) for x in (dense, pages))
        assert da.decode_plan(codes) == plan
        assert da.decode_plan(code_pages, tables) == plan


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
    plan = da.decode_plan(whole)
    assert da.decode_plan(member, plan_kv=16) == plan
    assert da.decode_plan(pages, tables, 16) == plan
    assert da.decode_plan(member) != plan


@pytest.mark.parametrize("b,want", [(8, (8, 8)), (1, (4, 16))])
def test_int8_wrappers_plan_as_the_bf16_ones(b, want):
    """The int8 wrappers' plan is the bf16 ones': qwen2-7b's round (4 kv
    heads of 128, S = 1024) in 8 splits of 8 tiles at B = 8 and one full
    cluster of 16 splits of 4 at B = 1, over int8 codes dense and paged
    (pages of 16) as over bf16, and a member's int8 launch planned for
    the model's kv heads (``plan_kv``) as the whole launch."""
    for dtype in (torch.bfloat16, torch.int8):
        dense = torch.empty(b, 1024, 4, 128, dtype=dtype, device="meta")
        pages = torch.empty(1 + b * 64, 16, 4, 128, dtype=dtype,
                            device="meta")
        tables = torch.empty(b, 64, dtype=torch.int32, device="meta")
        assert da.decode_plan(dense) == want
        assert da.decode_plan(pages, tables) == want
        for shards in (2, 4):
            member = torch.empty(b, 1024, 4 // shards, 128, dtype=dtype,
                                 device="meta")
            member_pages = torch.empty(1 + b * 64, 16, 4 // shards, 128,
                                       dtype=dtype, device="meta")
            assert da.decode_plan(member, plan_kv=4) == want
            assert da.decode_plan(member_pages, tables, 4) == want


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


@pytest.mark.parametrize("seed", [0, 1])
def test_int8_widen_is_the_plain_dequantize_bit_for_bit(seed):
    """The int8 kernels widen two codes at a time without a conversion
    instruction (``widen2`` in the kernel source): a code's low 7 bits
    under 0x4300 are the bf16 128 + m, adding 0xc300 (-128) or, its top
    bit set, 0xc380 (-256) gives the code exactly, and one bf16 multiply
    by the scale rounds the exact product once.  That is the plain
    version's ``_dequantize`` (f32 product, then bf16) bit for bit, for
    every code and scales from 1e-8 to 1e2."""
    raw = torch.arange(256, dtype=torch.int32)
    m = ((raw & 0x7F) | 0x4300).to(torch.int16).view(torch.bfloat16)
    k = ((raw & 0x80) | 0xC300).to(torch.int16).view(torch.bfloat16)
    codes = torch.where(raw < 128, raw, raw - 256).to(torch.int8)
    assert torch.equal((m + k).float(), codes.float())
    rng = np.random.default_rng(seed)
    scale = torch.from_numpy(np.abs(rng.standard_normal(64))
                             * 10.0 ** rng.uniform(-8, 2, 64)).to(
                                 torch.bfloat16)
    widened = (m + k)[:, None] * scale[None, :]
    assert widened.dtype == torch.bfloat16
    want = da._dequantize(codes[:, None], scale[None, :])
    assert torch.equal(widened.view(torch.int16), want.view(torch.int16))
