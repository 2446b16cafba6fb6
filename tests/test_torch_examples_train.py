"""``examples/torch_train_lm.py`` on the CPU beside its JAX twin: at
``--steps 20`` on both sides, from the same init in f32 (JAX's draw,
bridged), the loss trajectory across the crash and the restart from the
latest checkpoint matches the twin's within 1e-3 relative (each step's
f32 rounding differences feed the next, as in
``tests/test_torch_training.py``), and the example's own assert holds.
On the card the ``10m`` preset (head dim 40) is refused, with no CPU
fallback."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from examples_twins import load
from repro.models.model import Model as JModel
from repro_torch import bridge
from repro_torch.launch.train import PRESETS
from repro_torch.models import build_model

torch.set_num_threads(2)


class F32Model(JModel):
    """The twin's model with its draw cast to f32."""

    def init(self, key):
        return jax.tree_util.tree_map(lambda a: a.astype(jnp.float32),
                                      super().init(key))


def test_loss_trajectory_across_the_restart_equals_the_twin_s(monkeypatch):
    twin = load("train_lm")
    losses = []
    real_train = twin.train

    def recording(*args, **kwargs):
        out = real_train(*args, **kwargs)
        losses.extend(out[2].losses)
        return out

    monkeypatch.setattr(twin, "train", recording)
    monkeypatch.setattr(twin, "build_model", lambda cfg: F32Model(cfg=cfg))
    monkeypatch.setattr("sys.argv", ["train_lm.py", "--steps", "20"])
    twin.main()
    assert len(losses) == 20

    ex = load("torch_train_lm")
    cfg = PRESETS["10m"]
    host = jax.device_get(F32Model(cfg=twin.PRESETS["10m"]).init(
        jax.random.PRNGKey(0)))
    got = ex.run(build_model(cfg), bridge.to_torch(host), 20)
    np.testing.assert_allclose(got, losses, rtol=1e-3)
    assert got[-1] < got[0]


def test_main_trains_on_the_cpu_and_refuses_10m_on_the_card(monkeypatch,
                                                            capsys):
    ex = load("torch_train_lm")
    losses = ex.main(["--device", "cpu", "--steps", "4"])
    # no checkpoint before step 10: the restart trains all 4 steps anew,
    # as the twin's does
    assert len(losses) == 2 + 4 and losses[-1] < losses[0]
    monkeypatch.setattr(ex, "resolve_device",
                        lambda device: torch.device("cuda", 0))
    with pytest.raises(SystemExit) as err:
        ex.main(["--steps", "4"])
    assert err.value.code == 2
    assert "head dim 40" in capsys.readouterr().err
