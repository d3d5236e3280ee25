"""The port's training path (``train_lib``, ``utils/checkpoint``'s train
state, ``apps/train``) against the JAX package's, with the tiny config of
tests/test_train.py (nstack 2, inp_dim 32, increase 16, 64² images), batch
8, clipping on (max_grad_norm 1), and the same state carried across by
``train_state_from_flax``.

The train-mode steps run in float64 in both packages. With batch
statistics in every BatchNorm the step is chaotic at this size: in float64,
a 1e-7 relative change of the input images changes the gradient by 2.7% as
a whole (kinks of LeakyReLU and max-pool flip, and the train-mode BN
backward amplifies the change; tools/train_bn_conditioning.py measures it),
so an fp32 step of either package is off the exact one by percents, and
only a float64 comparison can hold the step tightly. The JAX package runs
in float64 under ``jax_float64`` (x64 on, its model's, loss's and GT
renderer's fp32 casts widened; its files are not changed), the port as a
``.double()`` model. Both take two steps from one state (one jit, the
compact GT rasterized on the device; the port with that feed and with the
dense maps its device renderer draws from the same joints), and loss,
gradient norm, every gradient (read off the first step's momentum),
parameter, momentum buffer and BN statistic agree within 1e-6 of each
tensor's scale (measured: 9e-12 after one step, 9e-9 after two). The fp32
steps with frozen BN (the SWA epochs' mode), which are well conditioned,
are held at 1e-4 in tests/test_torch_train_frozen_bn.py.
"""

import contextlib
import copy
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from improved_body_parts_tpu import configs as jconfigs
from improved_body_parts_tpu import losses as jlosses
from improved_body_parts_tpu import train_lib as jtrain_lib
from improved_body_parts_tpu.data import heatmaps_device as jheatmaps_device
from improved_body_parts_tpu.data.heatmaps_device import pad_people
from improved_body_parts_tpu.data.synthetic import random_people
from improved_body_parts_tpu.models import imhn as jimhn
from improved_body_parts_tpu.models.imhn import create_model
from improved_body_parts_tpu.utils.checkpoint import convert_torch_state_dict
from improved_body_parts_tpu_torch import configs, train_lib
from improved_body_parts_tpu_torch.data.heatmaps import Heatmapper
from improved_body_parts_tpu_torch.data.heatmaps_device import DeviceHeatmapper
from improved_body_parts_tpu_torch.models.imhn import PoseNet
from improved_body_parts_tpu_torch.utils import checkpoint as ckpt
from tests.test_torch_predict import single_torch_thread  # noqa: F401  (autouse)

B, SIZE, P = 8, 64, 4
LRS = (1e-2, 5e-3)
TINY = dict(nstack=2, inp_dim=32, increase=16)
TOL64 = 1e-6


@contextlib.contextmanager
def jax_float64():
    """The JAX package's model, loss and GT renderer in float64: x64 on, and
    the ``jnp`` of those three modules swapped for a namespace whose
    ``float32`` is float64, for as long as the block runs."""
    wide = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp)
                                    if not k.startswith("__")})
    wide.float32 = jnp.float64
    mods = (jimhn, jlosses, jheatmaps_device)
    saved = [m.jnp for m in mods]
    x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        for m in mods:
            m.jnp = wide
        yield
    finally:
        for m, j in zip(mods, saved):
            m.jnp = j
        jax.config.update("jax_enable_x64", x64)


def _configs(**train):
    jtrain = dataclasses.replace(jconfigs.TrainConfig(), swa=True,
                                 max_grad_norm=1.0, **train)
    jcfg = jconfigs.CanonicalConfig(width=SIZE, height=SIZE,
                                    model=jconfigs.ModelConfig(**TINY),
                                    train=jtrain)
    cfg = configs.CanonicalConfig(
        width=SIZE, height=SIZE, model=configs.ModelConfig(**TINY),
        train=configs.TrainConfig(**dataclasses.asdict(jtrain)))
    return jcfg, cfg


def _batch(dtype=np.float32):
    rng = np.random.RandomState(0)
    imgs = rng.rand(B, SIZE, SIZE, 3).astype(np.float32)
    mask = (rng.rand(B, SIZE // 4, SIZE // 4, 1) > 0.2).astype(np.float32)
    joints = np.stack([pad_people(random_people(rng, SIZE, SIZE), P)
                       for _ in range(B)])
    mask_all = (rng.rand(B, SIZE // 4, SIZE // 4) > 0.2).astype(np.float32)
    return tuple(a.astype(dtype) for a in (imgs, mask, joints, mask_all))


def jax_trajectory(freeze_bn: bool, dtype=np.float32):
    """The reference init of the port's model (conv N(0, 0.001), BN at
    identity) carried into a JAX TrainState of ``dtype``, and two JAX steps
    with the BatchNorm mode ``freeze_bn`` (call it under ``jax_float64`` for
    float64). Returns (port model of ``dtype``, port config, batch,
    {freeze_bn: [state0, (state, metrics) after step 1, after step 2]})."""
    jcfg, cfg = _configs()
    model = PoseNet(cfg.model, compute_dtype=torch.float32,
                    generator=torch.Generator().manual_seed(0))
    params, stats = convert_torch_state_dict(model.state_dict())
    cast = lambda tree: jax.tree_util.tree_map(lambda x: jnp.asarray(x, dtype), tree)
    jmodel = create_model(jcfg.model, dtype=jnp.dtype(dtype))
    state = jtrain_lib.create_train_state(cast(params), cast(stats), jcfg.train)
    imgs, mask, joints, mask_all = _batch(dtype)
    step = jtrain_lib.make_train_step(jmodel, jcfg, donate=False,
                                      freeze_bn=freeze_bn, compact_gt=True)
    traj = [ckpt.train_state_from_flax(state)]
    for lr in LRS:
        state, metrics = step(state, imgs, mask, (joints, mask_all),
                              jnp.asarray(lr, dtype))
        traj.append((ckpt.train_state_from_flax(state),
                     {k: float(v) for k, v in metrics.items()}))
    if dtype == np.float64:
        model.double()
        model.compute_dtype = torch.float64
    return model, cfg, (imgs, mask, joints, mask_all), {freeze_bn: traj}


@pytest.fixture(scope="module")
def jax_run():
    with jax_float64():
        return jax_trajectory(freeze_bn=False, dtype=np.float64)


def _port_state(model, cfg, payload, dtype=None):
    """A port state around a copy of ``model`` (cast to ``dtype``, if given)
    holding ``payload``."""
    model = copy.deepcopy(model)
    if dtype is not None:
        model.to(dtype)
        model.compute_dtype = dtype
    state = train_lib.create_train_state(model, cfg.train)
    train_lib.load_payload(state, payload)
    return state


def _feed(batch, cfg, compact):
    """(imgs, mask, GT) tensors: the compact pair, or dense maps: the host
    Heatmapper's for an fp32 batch, the device renderer's for a float64
    one (the host's work in fp32)."""
    imgs, mask, joints, mask_all = batch
    gt = (torch.from_numpy(joints), torch.from_numpy(mask_all))
    if compact:
        pass
    elif joints.dtype == np.float64:
        gt = DeviceHeatmapper(cfg).render(*gt)
    else:
        hm = Heatmapper(cfg)
        gt = torch.from_numpy(np.stack([hm.create_heatmaps(j, m)
                                        for j, m in zip(joints, mask_all)]))
    return torch.from_numpy(imgs), torch.from_numpy(mask), gt


def _rel(a: dict, b: dict, floor: float = 1e-3) -> float:
    """Largest max|a - b| / scale over the tensors of two dicts, where a
    tensor's scale is its own max|b|, but at least ``floor`` of the largest
    (tensors that stayed near 0, such as the first steps' BN shifts and the
    gradients train-mode BN makes 0, are measured against the others)."""
    keys = [k for k in b if not k.endswith("num_batches_tracked")]
    top = max(float(b[k].abs().max()) for k in keys)
    return max(float((a[k] - b[k]).abs().max())
               / max(float(b[k].abs().max()), floor * top) for k in keys)


def check_two_steps(run, feed, freeze_bn):
    """The port's two steps from the trajectory's start against it: fp32
    with frozen BN at 1e-4, float64 in train mode at ``TOL64``."""
    model, cfg, batch, runs = run
    traj = runs[freeze_bn]
    state = _port_state(model, cfg, traj[0])
    step = train_lib.make_train_step(state.model, cfg, freeze_bn=freeze_bn,
                                     compact_gt=feed == "compact")
    imgs, mask, gt = _feed(batch, cfg, feed == "compact")
    tol, floor = (1e-4, 1e-3) if freeze_bn else (TOL64, 1e-6)
    for i, lr in enumerate(LRS):
        before = train_lib.state_payload(state, cfg.train)
        metrics = step(state, imgs, mask, gt, lr)
        want, jm = traj[i + 1]
        got = train_lib.state_payload(state, cfg.train)
        assert float(metrics["skipped"]) == jm["skipped"] == 0.0
        assert got["step"] == want["step"] == i + 1
        np.testing.assert_allclose(float(metrics["loss"]), jm["loss"],
                                   rtol=1e-5 if freeze_bn else 1e-9)
        np.testing.assert_allclose(float(metrics["grad_norm"]),
                                   jm["grad_norm"], rtol=tol)
        mom, jmom = (p["optimizer_weight"]["momentum_buffer"] for p in (got, want))
        bn = {k: v for k, v in got["weights"].items() if "running" in k}
        jbn = {k: v for k, v in want["weights"].items() if "running" in k}
        params = {k: v for k, v in got["weights"].items() if k in mom}
        jparams = {k: v for k, v in want["weights"].items() if k in mom}
        assert _rel(mom, jmom, floor) < tol
        assert _rel(params, jparams, floor) < tol
        moved = {k: params[k] - before["weights"][k] for k in params}
        assert _rel(moved, {k: jparams[k] - before["weights"][k] for k in params},
                    floor) < tol
        if freeze_bn:
            assert all(torch.equal(v, before["weights"][k]) for k, v in bn.items())
        else:
            assert _rel(bn, jbn, floor) < tol
        if i == 0:   # momentum after one step = clipped gradient + decay
            grads = {k: mom[k] - cfg.train.weight_decay * before["weights"][k]
                     for k in mom}
            jgrads = {k: jmom[k] - cfg.train.weight_decay * before["weights"][k]
                      for k in mom}
            assert _rel(grads, jgrads, floor) < tol


@pytest.mark.parametrize("feed", ["dense", "compact"])
def test_two_train_steps_match_jax(jax_run, feed):
    check_two_steps(jax_run, feed, freeze_bn=False)


def test_train_state_from_flax_round_trip(jax_run):
    model, cfg, _, runs = jax_run
    payload, _ = runs[False][1]
    state = _port_state(model, cfg, payload)
    back = train_lib.state_payload(state, cfg.train)
    for key in ("weights", "swa_params"):
        for k, v in payload[key].items():
            assert torch.equal(back[key][k], v), k
    for k, v in payload["optimizer_weight"]["momentum_buffer"].items():
        assert torch.equal(back["optimizer_weight"]["momentum_buffer"][k], v), k
    assert back["step"] == payload["step"] == 1
    with pytest.raises(KeyError):
        bad = dict(payload, optimizer_weight={"momentum_buffer": {}})
        train_lib.load_payload(state, bad)


@pytest.mark.parametrize("case", ["threshold", "nan"])
def test_abnormal_loss_keeps_the_state_bit_identical(jax_run, case):
    model, cfg, batch, runs = jax_run
    if case == "threshold":
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, abnormal_loss_thresh=1e-9))
    payload, _ = runs[False][1]              # non-zero momentum, moved BN stats
    state = _port_state(model, cfg, payload, torch.float32)
    imgs, mask, gt = _feed(batch, cfg, compact=True)
    if case == "nan":
        imgs = imgs.clone()
        imgs[0, 0, 0, 0] = float("nan")
    step = train_lib.make_train_step(state.model, cfg, compact_gt=True)
    before = train_lib.state_payload(state, cfg.train)
    metrics = step(state, imgs, mask, gt, LRS[0])
    after = train_lib.state_payload(state, cfg.train)
    assert float(metrics["skipped"]) == 1.0
    assert after["step"] == before["step"] + 1
    for key in ("weights", "swa_params"):
        for k, v in before[key].items():
            assert torch.equal(after[key][k], v), k
    for k, v in before["optimizer_weight"]["momentum_buffer"].items():
        assert torch.equal(after["optimizer_weight"]["momentum_buffer"][k], v), k


LR_CASES = [  # tests/test_train.py:20-41, and a grid
    (dict(learning_rate=2.5e-5), (0, 0, 100, 4)),
    (dict(learning_rate=2.5e-5), (10, 0, 100, 4)),
    (dict(learning_rate=2.5e-5), (30, 0, 100, 4)),
    (dict(learning_rate=2.5e-5), (83, 0, 100, 1)),
] + [(dict(), (e, s, 7, 1)) for e in (0, 1, 2, 3, 14, 15, 77, 78, 90)
     for s in (0, 6)]


@pytest.mark.parametrize("kw,args", LR_CASES)
def test_learning_rate_matches_jax(kw, args):
    for warm in (True, False):
        got = train_lib.learning_rate(configs.TrainConfig(**kw), *args,
                                      use_warmup=warm)
        want = jtrain_lib.learning_rate(jconfigs.TrainConfig(**kw), *args,
                                        use_warmup=warm)
        assert got == want


def test_learning_rate_reference_cases_and_cyclic():
    cfg = configs.TrainConfig(learning_rate=2.5e-5)
    assert train_lib.learning_rate(cfg, 0, 0, 100, 4) == pytest.approx(
        2.5e-5 * 4 / 300)
    assert train_lib.learning_rate(cfg, 10, 0, 100, 4) == pytest.approx(1e-4)
    assert train_lib.learning_rate(cfg, 30, 0, 100, 4) == pytest.approx(1e-4 * 0.04)
    assert train_lib.learning_rate(cfg, 83, 0, 100, 1) == pytest.approx(2.5e-5 * 0.2)
    for f in (1, 5):
        kw = dict(swa_lr_max=1e-5, swa_lr_min=1e-6, swa_freq_epochs=f)
        for e in range(12):
            assert train_lib.cyclic_learning_rate(configs.TrainConfig(**kw), e, 2) \
                == jtrain_lib.cyclic_learning_rate(jconfigs.TrainConfig(**kw), e, 2)


def test_resume_equals_continuous_training(jax_run, tmp_path):
    """Save after one step, restore into a fresh state, take the second:
    bit-equal to two steps straight through."""
    model, cfg, batch, runs = jax_run
    feed = _feed(batch, cfg, compact=True)
    straight = _port_state(model, cfg, runs[False][0], torch.float32)
    step = train_lib.make_train_step(straight.model, cfg, compact_gt=True)
    step(straight, *feed, LRS[0])
    train_lib.swa_update(straight)
    path = ckpt.save_train_state(str(tmp_path), train_lib.state_payload(
        straight, cfg.train, epoch=0, train_loss=1.5), step=0)
    assert path.endswith("epoch_0.pth")
    step(straight, *feed, LRS[1])

    resumed = _port_state(model, cfg, runs[False][1][0], torch.float32)  # another state
    restored = ckpt.restore_train_state(str(tmp_path))
    assert restored["epoch"] == 0 and restored["train_loss"] == 1.5
    train_lib.load_payload(resumed, restored)
    train_lib.make_train_step(resumed.model, cfg, compact_gt=True)(
        resumed, *feed, LRS[1])
    a, b = (train_lib.state_payload(s, cfg.train) for s in (straight, resumed))
    assert a["step"] == b["step"] == 2 and a["swa_count"] == b["swa_count"] == 1
    for key in ("weights", "swa_params"):
        for k, v in a[key].items():
            assert torch.equal(b[key][k], v), k
    for k, v in a["optimizer_weight"]["momentum_buffer"].items():
        assert torch.equal(b["optimizer_weight"]["momentum_buffer"][k], v), k


def test_checkpoint_files_keep_and_select(tmp_path):
    for step in range(5):
        ckpt.save_train_state(str(tmp_path), {"epoch": step}, step=step, keep=2)
    assert ckpt.saved_steps(str(tmp_path)) == [3, 4]
    assert ckpt.restore_train_state(str(tmp_path))["epoch"] == 4
    assert ckpt.restore_train_state(f"{tmp_path}@3")["epoch"] == 3
    with pytest.raises(FileNotFoundError):
        ckpt.restore_train_state(str(tmp_path / "none"))


def test_remat_and_freeze_bn(jax_run):
    """remat (torch.utils.checkpoint per hourglass) takes the same step;
    with freeze_bn the running statistics stay and the forward is the
    inference one."""
    model, cfg, batch, runs = jax_run
    feed = _feed(batch, cfg, compact=True)
    out = []
    for remat in (False, True):
        rcfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                                  remat=remat))
        m = PoseNet(rcfg.model, compute_dtype=torch.float32)
        m.load_state_dict(model.state_dict())
        state = train_lib.create_train_state(m, cfg.train)
        metrics = train_lib.make_train_step(m, rcfg, compact_gt=True)(
            state, *feed, LRS[0])
        out.append((metrics, train_lib.state_payload(state, cfg.train)))
    assert torch.equal(out[0][0]["loss"], out[1][0]["loss"])
    assert _rel(out[1][1]["weights"], out[0][1]["weights"]) < 1e-6
    assert _rel(out[1][1]["optimizer_weight"]["momentum_buffer"],
                out[0][1]["optimizer_weight"]["momentum_buffer"]) < 1e-4
