"""The port's data-parallel train step (``train_lib`` with a ``parallel/
mesh`` process group) on 2 gloo ranks on the CPU, against the JAX step on
the 8-device CPU mesh of tests/conftest.py with the same global batch.

The tiny config of tests/test_torch_train.py (nstack 2, inp_dim 32, 64²,
global batch 8, clipping at 1), the compact feed, two steps. Each rank
takes 4 of the 8 samples; JAX shards them one a device. Train-mode BN in
float64 in both packages (``jax_float64``, as tests/test_torch_train.py
holds train mode): the BN statistics over the global batch, their gradient
through the all-reduce, the averaged gradients, the clip and the update
agree with JAX's within 1e-6 of each tensor's scale, and the two ranks'
states are bit-identical. The abnormal-loss rule trips on one rank's data
only (with frozen BN, where nothing else couples the ranks, so that rank
0's own loss stays finite and below the threshold), and both ranks keep
their state bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from improved_body_parts_tpu import train_lib as jtrain_lib
from improved_body_parts_tpu.models.imhn import create_model
from improved_body_parts_tpu.parallel import mesh as jmesh
from improved_body_parts_tpu_torch import train_lib
from improved_body_parts_tpu_torch.utils import checkpoint as ckpt
from tests._torch_dist_child import run_ranks
from tests.test_torch_predict import single_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_resident import assert_held, jax_state, port_model
from tests.test_torch_train import LRS, _batch, _configs, jax_float64


def jax_mesh_steps(step, jstate, batches, dtype):
    """JAX steps with every batch leaf sharded over the 8-device mesh and
    the state replicated: [(payload, metrics)] a step."""
    mesh = jmesh.make_mesh()
    assert mesh.devices.size == 8
    jstate = jax.device_put(jstate, jmesh.replicated(mesh))
    traj = []
    for (imgs, mask, joints, mask_all), lr in zip(batches, LRS):
        imgs, mask, joints, mask_all = jmesh.shard_batch(
            mesh, (imgs, mask, joints, mask_all))
        jstate, jm = step(jstate, imgs, mask, (joints, mask_all),
                          jnp.asarray(lr, dtype))
        traj.append((ckpt.train_state_from_flax(jstate),
                     {k: float(v) for k, v in jm.items()}))
    return traj


def dist_spec(cfg, payload, batches, freeze_bn, dtype):
    return dict(kind="train", config=cfg, payload=payload, batches=batches,
                lrs=list(LRS), freeze_bn=freeze_bn, dtype=dtype)


def assert_ranks_identical(outs):
    a, b = (o["payload"] for o in outs)
    np.testing.assert_equal(outs[0]["metrics"], outs[1]["metrics"])   # NaN == NaN
    for key in ("weights", "swa_params"):
        assert all(torch.equal(a[key][k], b[key][k]) for k in a[key])
    ma, mb = (p["optimizer_weight"]["momentum_buffer"] for p in (a, b))
    assert all(torch.equal(ma[k], mb[k]) for k in ma)


def test_two_ranks_train_mode_match_the_jax_mesh_float64(tmp_path):
    jcfg, cfg = _configs()
    batches = [_batch(np.float64)]
    rng = np.random.RandomState(1)
    batches.append(tuple(rng.permutation(a) for a in batches[0]))
    model = port_model(cfg, torch.float32)
    with jax_float64():
        jstate = jax_state(model, jcfg, np.float64)
        jmodel = create_model(jcfg.model, dtype=jnp.float64)
        jstep = jtrain_lib.make_train_step(jmodel, jcfg, donate=False,
                                           compact_gt=True)
        traj = jax_mesh_steps(jstep, jstate, batches, np.float64)
    start = train_lib.state_payload(train_lib.create_train_state(
        port_model(cfg, torch.float64), cfg.train), cfg.train)
    outs = run_ranks(dist_spec(cfg, start, batches, False, "float64"), tmp_path)
    assert_ranks_identical(outs)
    # the returned loss does not keep the flat gradient buffer alive
    assert all(b == 8 for o in outs for b in o["metric_bytes"])
    got, metrics = outs[0]["payload"], outs[0]["metrics"][-1]
    want, jm = traj[-1]
    assert [m["loss"] for m in outs[0]["metrics"]] == pytest.approx(
        [t[1]["loss"] for t in traj], rel=1e-6)
    assert_held(got, metrics, want, jm, traj[0][0], freeze_bn=False)


@pytest.mark.parametrize("case", ["nan", "threshold"])
def test_abnormal_loss_on_one_rank_rolls_back_both(tmp_path, case):
    """Rank 1's data alone makes the global loss abnormal (NaN images, or
    most of rank 0's loss masked and the threshold between rank 0's own loss
    and the global one); both ranks skip the step and keep their state."""
    _, cfg = _configs()
    imgs, mask, joints, mask_all = _batch(np.float32)
    start = train_lib.state_payload(train_lib.create_train_state(
        port_model(cfg, torch.float32), cfg.train), cfg.train)
    if case == "nan":
        imgs[4:] = np.nan
    else:
        mask = mask.copy()
        mask[:4, :, 2:] = 0.0                   # rank 0: most of its loss masked
        one = train_lib.create_train_state(port_model(cfg, torch.float32), cfg.train)
        step = train_lib.make_train_step(one.model, cfg, freeze_bn=True,
                                         compact_gt=True)
        loss0, loss1 = (float(step(one, *(torch.from_numpy(a[sl]) for a in (imgs, mask)),
                                   tuple(torch.from_numpy(a[sl])
                                         for a in (joints, mask_all)), 0.0)["loss"])
                        for sl in (slice(0, 4), slice(4, 8)))
        assert loss1 > 2 * loss0 > 0
        thresh = (loss0 + (loss0 + loss1) / 2) / 2    # above rank 0's, below the mean
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, abnormal_loss_thresh=thresh))
    outs = run_ranks(dict(dist_spec(cfg, start, [(imgs, mask, joints, mask_all)],
                                    True, "float32"), lrs=[1e-2]), tmp_path)
    assert_ranks_identical(outs)
    for out in outs:
        assert out["metrics"][0]["skipped"] == 1.0
        if case == "threshold":
            assert out["metrics"][0]["loss"] == pytest.approx((loss0 + loss1) / 2,
                                                              rel=1e-5)
        got = out["payload"]
        for k, v in start["weights"].items():
            assert torch.equal(got["weights"][k], v), k
        assert all(torch.equal(m, torch.zeros_like(m)) for m in
                   got["optimizer_weight"]["momentum_buffer"].values())
