"""The port's analysis layer (``repro_torch.analysis.roofline``) and dry-run
input specs (``repro_torch.models.input_specs``) against the JAX
package's (``repro.analysis.roofline``, ``repro.models.input_specs``).

* ``kernel_hbm_bytes``, ``model_flops`` and ``decode_round_alpha``: equal
  exactly (the same float arithmetic on the same config fields) for
  every registered config, full and reduced, and every ``SHAPE_CASES``
  entry;
* ``roofline_terms``: JAX's arithmetic exactly, given the same counts
  and, on JAX's side, the H100's constants in place of v5e's;
* ``input_specs``: JAX's shapes, dtypes and logical names for every
  config and case.
"""

import dataclasses

import jax.numpy as jnp
import pytest
import torch

from repro.analysis import roofline as jroof
from repro.configs import all_arch_ids as jax_arch_ids
from repro.configs import get_config as jax_config
from repro.models import SHAPE_CASES as JAX_CASES
from repro.models import build_model as jax_build
from repro.models import input_specs as jax_input_specs
from repro_torch.analysis import roofline as troof
from repro_torch.configs import all_arch_ids, get_config
from repro_torch.launch import mesh
from repro_torch.models import SHAPE_CASES, build_model, input_specs

ARCHS = all_arch_ids()
DTYPES = {jnp.dtype(jnp.int32): torch.int32,
          jnp.dtype(jnp.int8): torch.int8,
          jnp.dtype(jnp.bfloat16): torch.bfloat16,
          jnp.dtype(jnp.float32): torch.float32}


def test_cases_and_registry_match_jax():
    assert ARCHS == jax_arch_ids()
    assert {k: dataclasses.astuple(v) for k, v in SHAPE_CASES.items()} == \
        {k: dataclasses.astuple(v) for k, v in JAX_CASES.items()}


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_analytic_counts_equal_jax(arch, reduced):
    tcfg, jcfg = get_config(arch, reduced), jax_config(arch, reduced)
    for name, case in SHAPE_CASES.items():
        jcase = JAX_CASES[name]
        assert troof.model_flops(tcfg, case) == \
            jroof.model_flops(jcfg, jcase), (arch, name)
        assert troof.kernel_hbm_bytes(tcfg, case) == \
            jroof.kernel_hbm_bytes(jcfg, jcase), (arch, name)
    for seq in (1, 128, 1024, 2048, 32768, 524288):
        assert troof.decode_round_alpha(tcfg, seq) == \
            jroof.decode_round_alpha(jcfg, seq), (arch, seq)


@pytest.mark.parametrize("counts", [
    (3.7e14, 2.1e12, 5.0e9, 0.0, 8, 2.9e15, 4.4e13),
    (1.0e12, 8.0e11, 0.0, 2.0e10, 1, 9.0e11, 0.0),
    (5.5e15, 1.9e13, 7.5e11, 1.0e12, 4, 1.2e16, 6.0e14),
])
def test_roofline_terms_equal_jax(monkeypatch, counts):
    flops, hbm, coll, internal, n, mf, kb = counts
    monkeypatch.setattr(jroof, "PEAK_FLOPS", mesh.PEAK_FLOPS_BF16)
    monkeypatch.setattr(jroof, "HBM_BW", mesh.HBM_BW)
    monkeypatch.setattr(jroof, "LINK_BW", mesh.NVLINK_BW)
    analysis = jroof.HloAnalysis(flops=flops, hbm_bytes=hbm,
                                 kernel_internal_bytes=internal,
                                 collective_wire={"all-gather": coll})
    want = jroof.roofline_terms(analysis, n, mf, kernel_bytes_global=kb)
    got = troof.roofline_terms(flops, hbm, coll, n, mf,
                               kernel_bytes_global=kb,
                               kernel_internal_bytes=internal)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    for prop in ("dominant", "bound_s", "useful_ratio", "mfu_bound"):
        assert getattr(got, prop) == getattr(want, prop), prop


def test_h100_constants():
    """The card's data-sheet numbers, which ``chip_smoke.py``'s bounds
    read from ``launch/mesh.py``."""
    assert (troof.PEAK_FLOPS, mesh.HBM_BW, mesh.HBM_BYTES, troof.LINK_BW) \
        == (989e12, 3.35e12, 80e9, 450e9)
    assert [mesh.n_cards(s) for s in mesh.MESH_LAYOUTS.values()] == \
        [1, 2, 4, 8]
    assert [mesh.n_cards(s) for s in mesh.POD_LAYOUTS.values()] == \
        [1, 2, 4, 8]


def _tree(specs, names):
    if isinstance(specs, dict):
        return {k: _tree(specs[k], names[k]) for k in specs}
    return specs, names


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_jax(arch):
    tm, jm = build_model(get_config(arch)), jax_build(jax_config(arch))
    for name, case in SHAPE_CASES.items():
        tspecs, tnames = input_specs(tm, case)
        jspecs, jnames = jax_input_specs(jm, JAX_CASES[name])
        assert sorted(tspecs) == sorted(jspecs), (arch, name)

        def flat(specs, names, path=""):
            if isinstance(specs, dict):
                assert sorted(specs) == sorted(names)
                for k in specs:
                    yield from flat(specs[k], names[k], f"{path}/{k}")
            else:
                yield path, specs, tuple(names)

        got = {p: (tuple(t.shape), t.dtype, n)
               for p, t, n in flat(tspecs, tnames)}
        want = {p: (tuple(s.shape), DTYPES[jnp.dtype(s.dtype)], n)
                for p, s, n in flat(jspecs, jnames)}
        assert got == want, (arch, name)
        assert all(t.is_meta for _, t, _ in flat(tspecs, tnames))
