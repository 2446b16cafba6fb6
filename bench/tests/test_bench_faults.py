"""A whole run on the CPU at a tiny size, past the harness's look for a
card: sound, ``correct`` comes out true; with the served path broken
underneath, false.  The faults a served cell can have: a decode round
that leaves the KV cache as it was, half of the batch's slots left out
(their tokens not advanced), and a token altered where it is produced.
The control, the fp8 reference in the program's place, reads far above
the program at the same size."""

import pytest
import torch

from bench import check, run
from conftest import tiny_cell

# The tiny cells' limits.  Dense: the widest gap, sound 0.00-0.01.  The
# tiny moe's 4 experts flip at near-ties of their gates between bf16 and
# float32 often enough that its widest gap swings to 1.2 on sound runs;
# its mean gap reads 0.0000-0.0186 over seeds 2**31 + 7 to + 14, the
# control's 0.043-0.080.  Without its window (full caches, bucketed
# prefills, as the mixtral cell runs) the mean reads 0.0001-0.0251 over
# the same seeds, the control's 0.035-0.079: too close at this size for
# the control's test, so that path is held to the faults' test alone.
LIMITS = {"dense": {"gap_max": 0.05}, "moe": {"gap_mean": 0.03},
          "moe_full": {"gap_mean": 0.03}}


def _patch(monkeypatch, fault):
    from repro_torch.models.model import Model
    step = Model.decode_step_tokens

    def broken(self, params, token, cache, key=None, sampling=None):
        saved = ({k: cache[k].clone() for k in ("k", "v")}
                 if fault == "state" else None)
        out = step(self, params, token, cache, key, sampling)
        tok = out[0]
        if fault == "state":
            for k, v in saved.items():
                cache[k].copy_(v)
        elif fault == "half":
            half = tok.shape[0] // 2
            tok = torch.cat([tok[:half], token.to(tok.dtype)[half:]])
        elif fault == "token":
            tok = (tok + 1) % self.cfg.vocab_size
        return (tok, *out[1:])
    monkeypatch.setattr(Model, "decode_step_tokens", broken)


@pytest.mark.parametrize("family", ["dense", "moe", "moe_full"])
@pytest.mark.parametrize("fault", [None, "state", "half", "token"])
def test_a_broken_path_is_not_correct(monkeypatch, family, fault):
    if fault:
        _patch(monkeypatch, fault)
    sp = tiny_cell(family, "closed", LIMITS[family])
    out = run.run_cell(sp, 2 ** 31 + 7, 3.0, False, "cpu")
    assert {k: v["limit"] for k, v in out["checked"].items()} == \
        LIMITS[family]
    assert out["correct"] is (fault is None), out["checked"]
    assert list(out)[-1] == "checked"
    if fault is None:
        assert out["metrics"]["tokens_per_s"]["value"] > 0


@pytest.mark.parametrize("family", ["dense", "moe"])
def test_the_control_reads_far_above_the_program(family):
    sp = tiny_cell(family, "closed", LIMITS[family])
    out = run.run_cell(sp, 2 ** 31 + 9, 3.0, False, "cpu", control=True)
    prog, ctl = out["info"]["program"], out["info"]["control"]
    (number,) = LIMITS[family]
    assert out["correct"]
    assert ctl[number] > 3 * prog[number]
    assert not check.verdict(ctl, sp["limits"])[0]
    assert out["info"]["control_verdict"]["correct"] is False
