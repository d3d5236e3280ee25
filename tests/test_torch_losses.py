"""The port's loss (``losses.py``), device GT renderer
(``data/heatmaps_device.py``) and train-mode BatchNorm forward against the
JAX package's, on the same numpy inputs drawn from a seed.

Tolerances: the loss in fp32 at rtol 1e-5 (summation order differs). The
renderer at 1e-6 absolute: max-combination is exact, the limb sums and
``exp`` may differ in the last bit. The train-mode forward normalizes every
conv output by its batch statistics, which both packages take in fp32 in
another summation order; each BN layer rescales the previous layer's
rounding, so the outputs of the 2-stack model differ by more than one
layer's rounding, and at batch 2 the 1x1 innermost level normalizes two
samples, which makes the forward chaotic in fp32 (errors of 1e-1 against
float64 in both packages). At batch 8 the JAX package's fp32 outputs lie
within 2.3e-3 of their scale from the port's float64 result, the exact
value of the function both compute, and the port's fp32 outputs within
4.7e-4: the JAX result is the farther of the two, which the test asserts,
with 5e-3 between them. The same forward in float64 in both packages
agrees within 1e-9, batch statistics included.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from improved_body_parts_tpu import configs as jconfigs
from improved_body_parts_tpu import losses as jlosses
from improved_body_parts_tpu.data.heatmaps_device import (
    DeviceHeatmapper as JDeviceHeatmapper, erode3_device as jerode3_device,
    pad_people as jpad_people,
)
from improved_body_parts_tpu.data.synthetic import random_people
from improved_body_parts_tpu.models.imhn import create_model
from improved_body_parts_tpu.utils.checkpoint import convert_torch_state_dict
from improved_body_parts_tpu_torch import configs, losses
from improved_body_parts_tpu_torch.data.heatmaps import Heatmapper
from improved_body_parts_tpu_torch.data.heatmaps_device import (
    DeviceHeatmapper, erode3_device, pad_people,
)
from improved_body_parts_tpu_torch.models.imhn import PoseNet
from improved_body_parts_tpu_torch.utils.checkpoint import state_dict_from_flax
from tests.test_torch_predict import single_torch_thread  # noqa: F401  (autouse)

TINY = dict(nstack=2, inp_dim=32, increase=16)


def _random_preds(rng, n, size, nstack=2, scales=5):
    return [[rng.rand(n, size >> s, size >> s, configs.NUM_LAYERS).astype(np.float32)
             for s in range(scales)] for _ in range(nstack)]


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_focal", [True, False], ids=["focal", "l2"])
@pytest.mark.parametrize("seed", range(2))
def test_multi_task_loss_matches_jax_on_random_masks(use_focal, seed):
    """Random (not all-ones) masks: only the antialiased resize matches
    jax.image.resize when the mask is downsampled per scale."""
    rng = np.random.RandomState(seed)
    n, size = 2, 32
    preds = _random_preds(rng, n, size)
    gt = rng.rand(n, size, size, configs.NUM_LAYERS).astype(np.float32)
    mask = (rng.rand(n, size, size, 1) > 0.4).astype(np.float32)
    cfg = configs.TrainConfig(focal_gamma=1.0 if seed == 0 else 2.0)
    jcfg = jconfigs.TrainConfig(focal_gamma=cfg.focal_gamma)
    want = float(jlosses.multi_task_loss(
        [[jnp.asarray(p) for p in st] for st in preds], jnp.asarray(gt),
        jnp.asarray(mask), jcfg, use_focal=use_focal))
    got = losses.multi_task_loss(
        [[torch.from_numpy(p) for p in st] for st in preds], torch.from_numpy(gt),
        torch.from_numpy(mask), cfg, use_focal=use_focal)
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(got.item(), want, rtol=1e-5)


@pytest.mark.parametrize("out", [16, 8, 4])
def test_resize_bilinear_is_jax_linear_resize(out):
    mask = (np.random.RandomState(out).rand(2, 32, 32, 1) > 0.5).astype(np.float32)
    want = np.asarray(jlosses.resize_bilinear(jnp.asarray(mask), out, out))
    got = losses.resize_bilinear(torch.from_numpy(mask), out, out).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # the plain bilinear resize is not the same function on a random mask
    plain = torch.nn.functional.interpolate(
        torch.from_numpy(mask).permute(0, 3, 1, 2), size=(out, out),
        mode="bilinear", align_corners=False).permute(0, 2, 3, 1).numpy()
    assert np.abs(plain - want).max() > 0.05


def test_loss_pieces_match_jax():
    rng = np.random.RandomState(3)
    np.testing.assert_array_equal(losses.channel_weights(0.1, 3.0).numpy(),
                                  np.asarray(jlosses.channel_weights(0.1, 3.0)))
    x = rng.rand(2, 8, 8, 5).astype(np.float32)
    np.testing.assert_allclose(losses.avg_pool_to(torch.from_numpy(x), 2, 2).numpy(),
                               np.asarray(jlosses.avg_pool_to(jnp.asarray(x), 2, 2)),
                               rtol=1e-6)
    pred, gt, m = (rng.rand(2, 2, 4, 4, 2).astype(np.float32) for _ in range(3))
    np.testing.assert_allclose(
        losses.offset_l1_loss(*map(torch.from_numpy, (pred, gt, m))).item(),
        float(jlosses.offset_l1_loss(*map(jnp.asarray, (pred, gt, m)))), rtol=1e-6)
    zero = torch.zeros((1, 8, 8, configs.NUM_LAYERS))
    assert losses.multi_task_loss([[zero]], zero, torch.ones((1, 8, 8, 1)),
                                  configs.TrainConfig(nstack_weight=(1.0,),
                                                      scale_weight=(1.0,))).item() == 0.0


# ---------------------------------------------------------------------------
# the device GT renderer
# ---------------------------------------------------------------------------

def _scene(rng, size, n_people):
    """Mixed visibility codes, joints past every border, a zero-length limb
    (as tests/test_device_heatmaps.py)."""
    joints = random_people(rng, size, size, max_people=n_people)
    joints = np.concatenate([joints] * n_people)[:n_people]
    joints[:, :, 2] = rng.choice([0, 1, 1, 1, 2, 3], joints.shape[:2])
    joints[0, 3, :2] = [-37.2, 11.0]
    joints[0, 4, :2] = [size + 55.0, size * 0.5]
    joints[0, 9, :2] = [size * 0.3, -20.0]
    joints[0, 10, :2] = [size * 0.5, size + 9.0]
    if n_people > 1:
        joints[1, 6, :] = [size * 0.4, size * 0.4, 0]
        joints[1, 7, :] = joints[1, 6, :]
    return joints


@pytest.mark.parametrize("with_mask", [True, False], ids=["mask_all", "no_mask"])
def test_render_matches_jax_and_host(with_mask):
    size, B, P = 128, 3, 6
    rng = np.random.RandomState(1 + with_mask)
    jcfg = jconfigs.CanonicalConfig(width=size, height=size)
    cfg = configs.CanonicalConfig(width=size, height=size)
    jdev = JDeviceHeatmapper(jcfg)
    joints = np.stack([pad_people(_scene(rng, size, n), P) for n in (1, 3, 2)])
    np.testing.assert_array_equal(jpad_people(joints[1, :3], P), joints[1])
    mask_all = (rng.rand(B, size // 4, size // 4) > 0.3).astype(np.float32)
    got = DeviceHeatmapper(cfg).render(
        torch.from_numpy(joints), torch.from_numpy(mask_all) if with_mask else None)
    assert got.shape == (B, size // 4, size // 4, configs.NUM_LAYERS)
    render = jax.jit(jdev.render)
    host = Heatmapper(cfg)
    for b in range(B):
        want = np.asarray(render(jnp.asarray(joints[b]),
                                 jnp.asarray(mask_all[b]) if with_mask else None))
        np.testing.assert_allclose(got[b].numpy(), want, rtol=0, atol=1e-6,
                                   err_msg=f"batch element {b}")
        if with_mask:
            np.testing.assert_allclose(
                got[b].numpy(), host.create_heatmaps(joints[b], mask_all[b]),
                rtol=0, atol=2e-5)        # the JAX package's own host bound


def test_erode3_device_matches_jax():
    mask = (np.random.RandomState(3).rand(2, 33, 47) > 0.4).astype(np.float32)
    got = erode3_device(torch.from_numpy(mask)).numpy()
    for b in range(2):
        np.testing.assert_array_equal(got[b], np.asarray(jerode3_device(
            jnp.asarray(mask[b]))))


# ---------------------------------------------------------------------------
# train-mode BatchNorm
# ---------------------------------------------------------------------------

def _randomised_tiny(seed=0):
    """The port's tiny PoseNet with weights drawn so activations stay O(1)
    (fan-in normal convs, BN scale in [0.5, 1.5]) and random running
    statistics; fp32."""
    g = torch.Generator().manual_seed(seed)
    model = PoseNet(configs.ModelConfig(**TINY), compute_dtype=torch.float32,
                    generator=g)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
                m.weight.normal_(0.0, (2.0 / m.weight[0].numel()) ** 0.5, generator=g)
                if m.bias is not None:
                    m.bias.normal_(0.0, 0.1, generator=g)
            elif isinstance(m, torch.nn.BatchNorm2d):
                m.weight.uniform_(0.5, 1.5, generator=g)
                m.bias.normal_(0.0, 0.1, generator=g)
                m.running_mean.normal_(0.0, 0.1, generator=g)
                m.running_var.uniform_(0.5, 2.0, generator=g)
    return model


def test_train_mode_forward_and_bn_stats_match_flax():
    model = _randomised_tiny()
    params, stats = convert_torch_state_dict(model.state_dict())
    fmodel = create_model(jconfigs.ModelConfig(**TINY), dtype=jnp.float32)
    imgs = np.random.RandomState(4).rand(8, 64, 64, 3).astype(np.float32)
    want, mutated = jax.jit(lambda p, s, x: fmodel.apply(
        {"params": p, "batch_stats": s}, x, train=True,
        mutable=["batch_stats"]))(params, stats, jnp.asarray(imgs))
    new_stats = state_dict_from_flax({}, jax.tree_util.tree_map(
        np.asarray, mutated["batch_stats"]))

    bn_stats = {}
    before = copy.deepcopy(model.state_dict())
    with torch.no_grad():
        got = model(torch.from_numpy(imgs), train=True, bn_stats=bn_stats)
        exact = copy.deepcopy(model).double()
        exact.compute_dtype = torch.float64
        exact = exact(torch.from_numpy(imgs).double(), train=True)
    # the forward records, it does not update
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    # BN statistics: every layer's batch mean and biased variance, as Flax
    # commits them (0.9 * old + 0.1 * batch). 5e-3 relative holds the
    # compounded rounding of the layers before; an unbiased variance is off
    # by 1 / (n - 1), above 5e-3 in every layer with n <= 200 samples a
    # channel (n = 8 at the 1x1 innermost level)
    names = {m: n for n, m in model.named_modules()}
    assert len(bn_stats) == sum(isinstance(m, torch.nn.BatchNorm2d)
                                for m in model.modules())
    for bn, (mean, var) in bn_stats.items():
        name = names[bn]
        want_mean = (new_stats[name + ".running_mean"] - 0.9 * bn.running_mean) / 0.1
        want_var = (new_stats[name + ".running_var"] - 0.9 * bn.running_var) / 0.1
        std = float(want_var.abs().max()) ** 0.5
        np.testing.assert_allclose(var.numpy(), want_var.numpy(), rtol=5e-3,
                                   atol=5e-3 * std ** 2, err_msg=name)
        np.testing.assert_allclose(mean.numpy(), want_mean.numpy(), rtol=0,
                                   atol=5e-3 * std, err_msg=name)
    # outputs: within 5e-3 of each map's scale of the JAX result, and the
    # port's fp32 result is the nearer of the two to the float64 one
    for t in range(2):
        for s in range(5):
            w, g_, e = np.asarray(want[t][s]), got[t][s].numpy(), exact[t][s].numpy()
            scale = float(np.abs(e).max())
            np.testing.assert_allclose(g_, w, rtol=0, atol=5e-3 * scale,
                                       err_msg=f"stack {t} scale {s}")
            assert np.abs(g_ - e).max() <= np.abs(w - e).max(), (t, s)


def test_train_flag_not_module_mode():
    """BN mode follows ``train=``, never ``nn.Module.training``."""
    model = _randomised_tiny(1)
    assert model.training
    imgs = torch.from_numpy(np.random.RandomState(5).rand(2, 64, 64, 3)
                            .astype(np.float32))
    with torch.no_grad():
        served = model(imgs)
        model.eval()
        evald = model(imgs)
        trained = model(imgs, train=True)
    for a, b, c in zip(served[-1], evald[-1], trained[-1]):
        assert torch.equal(a, b)
        assert not torch.allclose(a, c)


def test_train_mode_forward_and_bn_stats_match_flax_float64():
    """The same train-mode forward in float64 in both packages (the JAX one
    under ``jax_float64``): outputs, and every layer's batch mean and biased
    variance, within 1e-9 of their scale. An unbiased variance would be off
    by 1 / (n - 1) >= 5e-4, a mean or variance taken in fp32 by 1e-7."""
    from tests.test_torch_train import jax_float64
    model = _randomised_tiny()
    params, stats = convert_torch_state_dict(model.state_dict())
    model.double()
    model.compute_dtype = torch.float64
    imgs = np.random.RandomState(4).rand(8, 64, 64, 3)
    with jax_float64():
        cast = lambda t: jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64), t)
        fmodel = create_model(jconfigs.ModelConfig(**TINY), dtype=jnp.float64)
        want, mutated = jax.jit(lambda p, s, x: fmodel.apply(
            {"params": p, "batch_stats": s}, x, train=True,
            mutable=["batch_stats"]))(cast(params), cast(stats), jnp.asarray(imgs))
        want = jax.tree_util.tree_map(np.asarray, want)
        new_stats = state_dict_from_flax({}, jax.tree_util.tree_map(
            np.asarray, mutated["batch_stats"]))
    bn_stats = {}
    with torch.no_grad():
        got = model(torch.from_numpy(imgs), bn_stats=bn_stats)
    names = {m: n for n, m in model.named_modules()}
    assert len(bn_stats) == len(new_stats) // 3     # mean, var, num_batches_tracked
    for bn, (mean, var) in bn_stats.items():
        name = names[bn]
        for got_stat, key, old in ((mean, "running_mean", bn.running_mean),
                                   (var, "running_var", bn.running_var)):
            batch_stat = (new_stats[f"{name}.{key}"] - 0.9 * old) / 0.1
            scale = float(batch_stat.abs().max())
            np.testing.assert_allclose(got_stat.numpy(), batch_stat.numpy(),
                                       rtol=0, atol=1e-9 * scale,
                                       err_msg=f"{name}.{key}")
    for t in range(2):
        for s in range(5):
            g_, w = got[t][s].numpy(), want[t][s]
            assert g_.dtype == w.dtype == np.float64
            np.testing.assert_allclose(g_, w, rtol=0, atol=1e-9 * np.abs(w).max(),
                                       err_msg=f"stack {t} scale {s}")
