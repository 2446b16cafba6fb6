"""The port's training package (``repro_torch.training``) and trainer
(``repro_torch.launch.train``) against the JAX package's on the CPU.

Data are made by both packages' own ``make_batch``/``batch_iterator`` and
must agree bit for bit; params are JAX's tree bridged with
``repro_torch.bridge``.  Tolerances, each with its reason:
* data, checkpoints crossing between the packages, and a restart against
  an unbroken run: exact (the same numpy stream; the same bytes; the same
  ops in the same order on the CPU);
* ``AdamW.update`` on identical grads: 1e-6 — the same f32 elementwise
  ops, where XLA may contract a multiply and an add into one rounding;
* one train step on the tiny config in f32: loss 1e-5 (as the forward's
  logits, ``tests/test_torch_forward.py``), ``grad_norm`` 1e-4 relative
  (a sum of squares over every gradient);
* the tiny config's 20-step loss trajectory: 1e-3 relative — each step's
  f32 rounding differences feed the next step's params;
* microbatches 4 against 1, and bf16 gradient accumulation against f32,
  in the port alone: the reference's own tolerances
  (``tests/test_training.py:48-82``).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from conftest import tiny_config
from repro.configs import get_config as jax_config
from repro.models import build_model as jax_build
from repro.training import AdamW as JAdamW
from repro.training import TrainStepConfig as JStepCfg
from repro.training import checkpoint as jckpt
from repro.training import make_train_step as jmake_step
from repro.training import train as jtrain
from repro.training.data import batch_iterator as jbatches
from repro.training.data import make_batch as jmake_batch
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model
from repro_torch.models.config import ModelConfig
from repro_torch.training import (AdamW, TrainStepConfig, cross_entropy,
                                  make_train_step, train)
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.data import batch_iterator, make_batch

torch.set_num_threads(2)

BF16 = np.dtype(ml_dtypes.bfloat16)


def _bits(x):
    """A leaf's bytes as numpy, bf16 as its uint16 pattern."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype == BF16 else a


def _walk(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], f"{path}/{k}")
    else:
        yield path, tree


def _assert_trees_equal(got, want):
    g, w = dict(_walk(got)), dict(_walk(want))
    assert sorted(g) == sorted(w)
    for path in g:
        a, b = _bits(g[path]), _bits(w[path])
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)


def _torch_batch(jb):
    return {k: torch.from_numpy(np.array(_bits(v))) if k != "ctx" else
            torch.from_numpy(np.array(_bits(v)).view(np.int16)).view(
                torch.bfloat16) for k, v in jb.items()}


# -- data -------------------------------------------------------------------


def test_batches_equal_jax_bit_for_bit():
    for step in (0, 7):
        got = make_batch(300, 3, 17, step, seed=4)
        want = jmake_batch(300, 3, 17, step, seed=4)
        for key in ("tokens", "labels"):
            assert got[key].dtype == torch.int32
            np.testing.assert_array_equal(got[key].numpy(),
                                          np.asarray(want[key]))
    shape = (2, 12, 64)
    it = batch_iterator(256, 2, 9, seed=2, start_step=3, ctx_shape=shape)
    jit = jbatches(256, 2, 9, seed=2, start_step=3, ctx_shape=shape)
    for _ in range(3):
        got, want = next(it), next(jit)
        assert got["ctx"].dtype == torch.bfloat16
        for key in ("tokens", "labels", "ctx"):
            np.testing.assert_array_equal(_bits(got[key]), _bits(want[key]),
                                          err_msg=key)


# -- AdamW ------------------------------------------------------------------


def _opt_tree(rng):
    return {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "layers": {"ln": rng.standard_normal((2, 5)).astype(np.float32),
                       "u": rng.standard_normal((3, 2, 4)).astype(
                           np.float32)},
            "bias": rng.standard_normal((5,)).astype(np.float32)}


@pytest.mark.parametrize("kw", [
    dict(lr=1e-2, warmup_steps=2, total_steps=5, clip_norm=0.5),
    dict(lr=3e-3, warmup_steps=1, schedule="constant", clip_norm=100.0,
         weight_decay=0.3)], ids=["clipped-cosine", "constant"])
def test_adamw_update_matches_jax(kw):
    """Five updates past warmup and the cosine's end, gradients clipped
    (the first case) or not, decay on leaves of two dims or more only."""
    rng = np.random.default_rng(0)
    host = _opt_tree(rng)
    jopt, opt = JAdamW(**kw), AdamW(**kw)
    jp = jax.tree_util.tree_map(jnp.asarray, host)
    tp = bridge.to_torch(host)
    js, ts = jopt.init(jp), opt.init(tp)
    for _ in range(5):
        g = {k: v for k, v in _opt_tree(rng).items()}
        jp, js, jm = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), js,
                                 jp)
        tp, ts, tm = opt.update(bridge.to_torch(g), ts, tp)
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-6, err_msg=key)
        for got, want in ((tp, jp), (ts.m, js.m), (ts.v, js.v)):
            for (path, a), (_, b) in zip(_walk(got), _walk(
                    jax.device_get(want))):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=1e-6, atol=1e-6,
                                           err_msg=path)
    assert int(ts.step) == int(js.step) == 5


def test_adamw_decays_matrices_only():
    """With zero gradients only the decay moves a leaf: leaves of two dims
    or more shrink by lr * wd * p, a vector leaf stays."""
    opt = AdamW(lr=0.5, warmup_steps=1, schedule="constant",
                weight_decay=0.1)
    p = {"m": torch.ones(2, 3), "vec": torch.ones(3)}
    p, _, _ = opt.update({"m": torch.zeros(2, 3), "vec": torch.zeros(3)},
                         opt.init(p), p)
    assert torch.allclose(p["m"], torch.full((2, 3), 0.95))
    assert torch.equal(p["vec"], torch.ones(3))


# -- one step and a trajectory on the tiny config ----------------------------


@pytest.fixture(scope="module")
def tiny_pair():
    jm = jax_build(tiny_config())
    host = jax.device_get(jax.tree_util.tree_map(
        lambda x: x.astype(jnp.float32), jm.init(jax.random.key(3))))
    tm = build_model(ModelConfig(**dataclasses.asdict(jm.cfg)))
    return jm, host, tm


def test_one_train_step_matches_jax(tiny_pair):
    jm, host, tm = tiny_pair
    kw = dict(lr=1e-2, warmup_steps=3, total_steps=20)
    batch = jmake_batch(jm.cfg.vocab_size, 4, 16, step=0)
    jstep = jax.jit(jmake_step(jm, JAdamW(**kw), JStepCfg(remat=False)))
    jp = jax.tree_util.tree_map(jnp.asarray, host)
    _, _, jmet = jstep(jp, JAdamW(**kw).init(jp), batch)
    tstep = make_train_step(tm, AdamW(**kw), TrainStepConfig(remat=False))
    tp = bridge.to_torch(host)
    _, _, tmet = tstep(tp, AdamW(**kw).init(tp), _torch_batch(batch))
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(tmet["grad_norm"]),
                               float(jmet["grad_norm"]), rtol=1e-4)


def test_twenty_step_trajectory_matches_jax(tiny_pair):
    jm, host, tm = tiny_pair
    kw = dict(lr=1e-2, warmup_steps=5, total_steps=20)
    v = jm.cfg.vocab_size
    _, _, jres = jtrain(jm, jax.tree_util.tree_map(jnp.asarray, host),
                        jbatches(v, 4, 32, seed=0), opt=JAdamW(**kw),
                        steps=20, log_every=0)
    _, _, tres = train(tm, bridge.to_torch(host), batch_iterator(
        v, 4, 32, seed=0), opt=AdamW(**kw), steps=20, log_every=0)
    np.testing.assert_allclose(tres.losses, jres.losses, rtol=1e-3)
    assert np.mean(tres.losses[-5:]) < np.mean(tres.losses[:5])


# -- microbatches and bf16 accumulation (the reference's own checks) ---------


@pytest.fixture(scope="module")
def qwen_smoke():
    model = build_model(get_config("qwen2-7b", reduced=True))
    return model, model.init(torch.Generator().manual_seed(0))


def _copy(tree):
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    return tree.clone()


def test_microbatch_accumulation_matches_full_batch(qwen_smoke):
    model, params = qwen_smoke
    opt = AdamW(lr=1e-3)
    batch = make_batch(model.cfg.vocab_size, 8, 16, step=0)
    p1, _, m1 = make_train_step(model, opt, TrainStepConfig(
        microbatches=1, remat=False))(_copy(params), opt.init(params), batch)
    p4, _, m4 = make_train_step(model, opt, TrainStepConfig(
        microbatches=4, remat=False))(_copy(params), opt.init(params), batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m4["loss"]),
                               rtol=1e-3)
    for (path, a), (_, b) in zip(_walk(p1), _walk(p4)):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   rtol=5e-2, atol=5e-3, err_msg=path)
    with pytest.raises(ValueError, match="divisible"):
        make_train_step(model, opt, TrainStepConfig(microbatches=3))(
            _copy(params), opt.init(params), batch)


def test_grad_compression_close_to_fp32(qwen_smoke):
    model, params = qwen_smoke
    opt = AdamW(lr=1e-3)
    batch = make_batch(model.cfg.vocab_size, 4, 16, step=1)
    _, _, mf = make_train_step(model, opt, TrainStepConfig(remat=False))(
        _copy(params), opt.init(params), batch)
    _, _, mc = make_train_step(model, opt, TrainStepConfig(
        remat=False, grad_compress=True))(_copy(params), opt.init(params),
                                          batch)
    assert abs(float(mf["loss"]) - float(mc["loss"])) < 1e-3
    assert abs(float(mf["grad_norm"]) - float(mc["grad_norm"])) / \
        float(mf["grad_norm"]) < 0.05


# -- checkpoints ----------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_qwen():
    jm = jax_build(jax_config("qwen2-7b", reduced=True))
    jp = jm.init(jax.random.key(1))  # bf16 leaves
    js = JAdamW().init(jp)
    js = js._replace(step=jnp.asarray(7, jnp.int32),
                     m=jax.tree_util.tree_map(lambda x: x + 0.25, js.m),
                     v=jax.tree_util.tree_map(lambda x: x + 0.5, js.v))
    return jm, jp, js


def test_jax_checkpoint_restores_in_the_port(jax_qwen, tmp_path):
    jm, jp, js = jax_qwen
    d = str(tmp_path / "j")
    jckpt.save(d, 12, jp, js)
    tm = build_model(get_config("qwen2-7b", reduced=True))
    tp = tm.init(torch.Generator().manual_seed(9))
    step, params, state = ckpt.restore_latest(d, tp, AdamW().init(tp))
    assert step == 12 and int(state.step) == 7
    _assert_trees_equal(params, jax.device_get(jp))
    _assert_trees_equal(state.m, jax.device_get(js.m))
    _assert_trees_equal(state.v, jax.device_get(js.v))


def test_port_checkpoint_restores_in_jax(jax_qwen, tmp_path):
    jm, jp, js = jax_qwen
    tm = build_model(get_config("qwen2-7b", reduced=True))
    tp = tm.init(torch.Generator().manual_seed(9))
    ts = AdamW().init(tp)
    ts = ts._replace(step=ts.step + 3)
    d = str(tmp_path / "t")
    ckpt.save(d, 30, tp, ts)
    step, params, state = jckpt.restore_latest(d, jp, js)
    assert step == 30 and int(state.step) == 3
    _assert_trees_equal(tp, params)
    _assert_trees_equal(ts.m, state.m)
    # The same keys as JAX's own file, and the same dtypes under them.
    jckpt.save(str(tmp_path / "j"), 30, jp, js)
    with np.load(os.path.join(d, "ckpt_00000030.npz")) as a, \
            np.load(str(tmp_path / "j" / "ckpt_00000030.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        assert all(a[k].dtype == b[k].dtype for k in a.files)


def test_checkpoint_keep_n_and_async(qwen_smoke, tmp_path):
    model, params = qwen_smoke
    state = AdamW().init(params)
    d = str(tmp_path / "k")
    for step in (10, 20, 30, 40):
        ckpt.save(d, step, params, state, keep=2)
    assert [s for s, _ in ckpt.list_checkpoints(d)] == [30, 40]
    ckpt.save_async(d, 50, params, state, keep=2).join(timeout=60)
    ckpt.wait_for_async_save()
    assert [s for s, _ in ckpt.list_checkpoints(d)] == [40, 50]
    step, p2, s2 = ckpt.restore_latest(d, params, state)
    assert step == 50
    _assert_trees_equal(p2, params)
    _assert_trees_equal(s2.m, state.m)
    step, arrays, _ = ckpt.restore_latest(d)
    assert step == 50 and "~bf16~p['embed']" in arrays
    placed = ckpt.device_put_tree(p2, "cpu")
    _assert_trees_equal(placed, params)
    assert ckpt.restore_latest(str(tmp_path / "none"), params) is None


def test_restart_resumes_equal_to_an_unbroken_run(qwen_smoke, tmp_path):
    """Train 10 steps with checkpoints every 5, then restart towards 20
    from the newest checkpoint with the stream seeked to step 10: the
    params equal an unbroken 20-step run's bit for bit."""
    model, params0 = qwen_smoke
    d = str(tmp_path / "ck")
    opt = AdamW(lr=1e-3, total_steps=20)
    v = model.cfg.vocab_size

    def run(steps, start=0, ckpt_dir=d):
        return train(model, _copy(params0),
                     batch_iterator(v, 4, 16, seed=3, start_step=start),
                     steps=steps, opt=opt, checkpoint_dir=ckpt_dir,
                     checkpoint_every=5, log_every=0)

    run(10)
    p_final, s_final, result = run(20, start=10)
    assert result.steps == 10 and int(s_final.step) == 20
    p_ref, s_ref, _ = run(20, ckpt_dir=None)
    _assert_trees_equal(p_final, p_ref)
    _assert_trees_equal(s_final.v, s_ref.v)


def test_cross_entropy_perfect_prediction_is_zero():
    logits = torch.full((1, 4, 8), -30.0)
    logits[0, :, 3] = 30.0
    assert float(cross_entropy(logits, torch.full((1, 4), 3))) < 1e-5


# -- the trainer -----------------------------------------------------------------


def test_launch_train_main_on_the_cpu(capsys):
    result = launch_train.main(["--preset", "10m", "--steps", "3", "--seq",
                                "64", "--lr", "3e-2", "--device", "cpu"])
    assert result.steps == 3 and result.losses[-1] < result.losses[0]
    assert "lm-10m" in capsys.readouterr().out
    # One step: the last loss is the first, so it did not fall, and the
    # trainer exits non-zero.
    with pytest.raises(SystemExit, match="did not improve"):
        launch_train.main(["--preset", "10m", "--steps", "1", "--seq", "64",
                           "--device", "cpu"])


def test_trainer_imports_no_jax_nor_ml_dtypes_and_wants_a_card():
    """The training modules, the trainer and ``chip_smoke.py`` load
    neither JAX, the JAX package nor ``ml_dtypes`` (the card's machine has
    none of them); without ``--device cpu`` the trainer needs a card."""
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    code = (
        "import sys\n"
        "import repro_torch.training, repro_torch.training.checkpoint\n"
        "import repro_torch.training.data, repro_torch.launch.train\n"
        f"sys.path.insert(0, {str(root)!r})\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro', 'ml_dtypes'))\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(root / "src")))
    assert out.returncode == 0, out.stderr
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            launch_train.main(["--preset", "10m", "--steps", "1"])


def test_restored_checkpoint_onto_a_pod(qwen_smoke, tmp_path):
    """``device_put_tree`` onto a ``TPGroup`` (``device_put_sharded_tree``'s
    counterpart): one tree per member, each as ``shard_put`` places a
    pod's params by the serving placement; without the names it
    refuses."""
    from repro_torch.distributed.sharding import shard_put, tp_group
    model, params = qwen_smoke
    d = str(tmp_path / "pod")
    ckpt.save(d, 1, params)
    _, host, _ = ckpt.restore_latest(d, params)
    group = tp_group(2, devices=["cpu", "cpu"])
    members = ckpt.device_put_tree(host, group, model.param_names())
    want = shard_put(params, model.param_names(), group)
    assert len(members) == 2
    for tree, ref in zip(members, want):
        _assert_trees_equal(tree, ref)
    with pytest.raises(ValueError, match="names"):
        ckpt.device_put_tree(host, group)
