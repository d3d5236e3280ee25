"""The port's K-steps dispatch (``train_lib.make_multi_train_step``,
``make_multi_resident_train_step``, ``train_graph.MultiStep``) against the
JAX package's ``lax.scan`` of K steps, and the trainer's
``--steps-per-dispatch`` and ``--feed resident`` flags, with the tiny config
of tests/test_torch_train.py (nstack 2, inp_dim 32, increase 16, 64²,
batch 8), K = 2.

Against JAX, in train mode in float64 (``jax_float64_resident`` of
tests/test_torch_resident.py) at 1e-6 of each tensor's scale: the stacked
per-step loss and gradient norm, then every parameter, momentum buffer and
BN statistic after the K steps, for the resident feed here; the wire
feeds (the port's compact feed, and its dense feed on the maps its device
renderer draws from the same joints, both against JAX's compact scan, as
tests/test_torch_train.py holds the single step) are held in
tests/test_torch_train_multi_wire.py, and every feed with frozen BN in
fp32, at 1e-4, in tests/test_torch_train_multi_frozen_bn.py (each JAX
compilation on a test worker of its own). On the CPU the dispatch is the
plain loop of eager steps; its graph on the card is held bit for bit
against eager steps in tests/test_torch_train_graph.py.
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from improved_body_parts_tpu import train_lib as jtrain_lib
from improved_body_parts_tpu.data.heatmaps_device import pad_people
from improved_body_parts_tpu.data.synthetic import random_people
from improved_body_parts_tpu.models.imhn import create_model
from improved_body_parts_tpu_torch import train_lib
from improved_body_parts_tpu_torch.apps import train as tapp
from improved_body_parts_tpu_torch.parallel import mesh as mesh_lib
from improved_body_parts_tpu_torch.utils import checkpoint as ckpt
from tests.test_torch_predict import single_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_resident import (
    P, assert_held, jax_float64_resident, jax_state, port_model, resident_plans,
    synthetic_stores,  # noqa: F401  (fixture)
)
from tests.test_torch_train import B, LRS, SIZE, _configs, _feed

K = len(LRS)
CPU = torch.device("cpu")


def wire_batches(dtype):
    """K batches (imgs, mask, joints, mask_all) from a numpy seed."""
    out = []
    for k in range(K):
        rng = np.random.RandomState(10 + k)
        joints = np.stack([pad_people(random_people(rng, SIZE, SIZE), P)
                           for _ in range(B)])
        out.append(tuple(a.astype(dtype) for a in (
            rng.rand(B, SIZE, SIZE, 3),
            (rng.rand(B, SIZE // 4, SIZE // 4, 1) > 0.2),
            joints,
            (rng.rand(B, SIZE // 4, SIZE // 4) > 0.2))))
    return out


def stack(xs):
    if isinstance(xs[0], tuple):
        return tuple(stack([x[i] for x in xs]) for i in range(len(xs[0])))
    return torch.stack(xs) if isinstance(xs[0], torch.Tensor) else np.stack(xs)


def jax_multi(feed, freeze_bn, stores, model):
    """The JAX package's K-step scan from ``model``'s weights: the stacked
    metrics and the state after it, as a port payload."""
    jcfg, _ = _configs()
    dtype = np.float32 if freeze_bn else np.float64
    ctx = contextlib.nullcontext() if freeze_bn else jax_float64_resident()
    with ctx:
        state = jax_state(model, jcfg, dtype)
        jmodel = create_model(jcfg.model, dtype=jnp.dtype(dtype))
        lrs = jnp.asarray(LRS, dtype)
        if feed == "resident":
            idx, inv_m, joints = stack(resident_plans(stores))
            step = jtrain_lib.make_multi_resident_train_step(
                jmodel, jcfg, donate=False, freeze_bn=freeze_bn)
            state, metrics = step(state, {"images": jnp.asarray(stores[0].images)},
                                  jnp.asarray(idx), jnp.asarray(inv_m.astype(dtype)),
                                  jnp.asarray(joints.astype(dtype)), lrs)
        else:
            imgs, mask, joints, mask_all = stack(wire_batches(dtype))
            step = jtrain_lib.make_multi_train_step(
                jmodel, jcfg, donate=False, freeze_bn=freeze_bn, compact_gt=True)
            state, metrics = step(state, imgs, mask, (joints, mask_all), lrs)
        return ({k: np.asarray(v, np.float64) for k, v in metrics.items()},
                ckpt.train_state_from_flax(state))


def port_inputs(feed, freeze_bn, stores, cfg):
    """The K-stacked inputs of the port's multi-step for ``feed``."""
    dtype = torch.float32 if freeze_bn else torch.float64
    if feed == "resident":
        idx, inv_m, joints = (torch.from_numpy(a) for a in stack(resident_plans(stores)))
        return (stores[1].device_arrays(CPU), idx, inv_m, joints.to(dtype))
    batches = [_feed(b, cfg, feed == "compact")
               for b in wire_batches(np.float32 if freeze_bn else np.float64)]
    return stack(batches)


def make_multi(feed, model, cfg, freeze_bn):
    if feed == "resident":
        return train_lib.make_multi_resident_train_step(model, cfg, freeze_bn=freeze_bn)
    return train_lib.make_multi_train_step(model, cfg, freeze_bn=freeze_bn,
                                           compact_gt=feed == "compact")


def check_multi_against_jax(stores, freeze_bn, feeds):
    """The K-step dispatch of each of ``feeds`` against the JAX scan (the
    wire feeds against one compiled compact scan)."""
    _, cfg = _configs()
    dtype = torch.float32 if freeze_bn else torch.float64
    ref = port_model(cfg, torch.float32)
    wants = {}
    for feed in feeds:
        jfeed = "resident" if feed == "resident" else "compact"
        if jfeed not in wants:
            wants[jfeed] = jax_multi(jfeed, freeze_bn, stores, ref)
        jm, want = wants[jfeed]
        state = train_lib.create_train_state(port_model(cfg, dtype), cfg.train)
        before = train_lib.state_payload(state, cfg.train)
        multi = make_multi(feed, state.model, cfg, freeze_bn)
        metrics = multi(state, *port_inputs(feed, freeze_bn, stores, cfg),
                        torch.tensor(LRS, dtype=dtype))
        assert all(v.shape == (K,) for v in metrics.values())
        tol = 1e-4 if freeze_bn else 1e-6
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(metrics[key].numpy(), jm[key], rtol=tol,
                                       err_msg=f"{feed} {key}")
        assert_held(train_lib.state_payload(state, cfg.train),
                    {k: v[-1] for k, v in metrics.items()}, want,
                    {k: float(v[-1]) for k, v in jm.items()}, before, freeze_bn)
        assert int(state.step) == K


def test_multi_resident_steps_match_jax_train_bn_float64(synthetic_stores):
    check_multi_against_jax(synthetic_stores, False, ("resident",))


# ---------------------------------------------------------------------------
# the dispatch on its own (the plain CPU route)
# ---------------------------------------------------------------------------

def _tensors(state):
    return ([p.detach().clone() for p in state.model.parameters()]
            + [b.clone() for b in state.model.buffers()]
            + [m.clone() for m in state.momentum.values()] + [state.step.clone()])


def single_steps(feed, state, cfg, inputs, lrs):
    """The K-stacked ``inputs`` one step at a time through the single-step
    function of ``feed``."""
    if feed == "resident":
        step = train_lib.make_resident_train_step(state.model, cfg)
        fixed, inputs = inputs[:1], inputs[1:]
    else:
        step = train_lib.make_train_step(state.model, cfg,
                                         compact_gt=feed == "compact")
        fixed = ()
    out = []
    for k in range(len(lrs)):
        args = [tuple(x[k] for x in c) if isinstance(c, tuple) else c[k]
                for c in inputs]
        out.append(step(state, *fixed, *args, lrs[k]))
    return {key: torch.stack([o[key] for o in out]) for key in out[0]}


@pytest.mark.parametrize("feed", ["resident", "dense", "compact"])
def test_k_step_dispatch_equals_k_single_steps(synthetic_stores, feed):
    _, cfg = _configs()
    inputs = port_inputs(feed, True, synthetic_stores, cfg)
    lrs = torch.tensor(LRS)
    runs = []
    for multi in (True, False):
        state = train_lib.create_train_state(port_model(cfg, torch.float32), cfg.train)
        if multi:
            metrics = make_multi(feed, state.model, cfg, False)(state, *inputs, lrs)
        else:
            metrics = single_steps(feed, state, cfg, inputs, lrs)
        runs.append((metrics, _tensors(state)))
    (ma, ta), (mb, tb) = runs
    assert all(torch.equal(ma[k], mb[k]) for k in ma)
    assert len(ta) == len(tb) and all(torch.equal(a, b) for a, b in zip(ta, tb))


def test_epoch_of_five_steps_in_chunks_of_two(synthetic_stores):
    """``staged_chunks`` cuts 5 plans into 2 + 2 + 1 with the LR riding
    along; 5 dispatched steps equal 5 single steps, and the step count
    reads 5."""
    _, cfg = _configs()
    plans = resident_plans(synthetic_stores, steps=5, seed=9)
    lrs = [1e-2 / (1 + i) for i in range(5)]
    items = [(*p, np.asarray(lr, np.float32)) for p, lr in zip(plans, lrs)]
    chunks = list(mesh_lib.staged_chunks(CPU, iter(items), k=2))
    assert [n for n, _ in chunks] == [2, 2, 1]
    assert all(c[0].shape == (n, B) and c[3].shape == (n,) for n, c in chunks)
    store = synthetic_stores[1].device_arrays(CPU)
    state = train_lib.create_train_state(port_model(cfg, torch.float32), cfg.train)
    multi = train_lib.make_multi_resident_train_step(state.model, cfg)
    losses = torch.cat([multi(state, store, *c)["loss"] for _, c in chunks])
    assert losses.shape == (5,) and int(state.step) == 5
    ref = train_lib.create_train_state(port_model(cfg, torch.float32), cfg.train)
    want = single_steps("resident", ref, cfg,
                        (store, *(torch.from_numpy(a) for a in stack(plans))),
                        torch.tensor(lrs, dtype=torch.float32))
    assert torch.equal(losses, want["loss"])
    assert all(torch.equal(a, b) for a, b in zip(_tensors(state), _tensors(ref)))


def test_k_step_rollback_keeps_the_state(synthetic_stores):
    _, cfg = _configs(abnormal_loss_thresh=1e-9)
    state = train_lib.create_train_state(port_model(cfg, torch.float32), cfg.train)
    before = _tensors(state)
    multi = train_lib.make_multi_resident_train_step(state.model, cfg)
    metrics = multi(state, *port_inputs("resident", True, synthetic_stores, cfg),
                    torch.tensor(LRS))
    assert metrics["skipped"].tolist() == [1.0] * K
    after = _tensors(state)
    assert int(after[-1]) == K
    assert all(torch.equal(a, b) for a, b in zip(after[:-1], before[:-1]))


# ---------------------------------------------------------------------------
# the trainer's flags
# ---------------------------------------------------------------------------

APP = ["--device", "cpu", "--tiny-model", "--epochs", "1", "--steps-per-epoch", "3",
       "--batch-size", "2", "--image-size", "64", "--synthetic-length", "8",
       "--workers", "0", "--print-freq", "1"]


def test_app_trains_resident_k2_and_resumes(tmp_path, capsys):
    args = APP + ["--feed", "resident", "--resident-augment",
                  "--steps-per-dispatch", "2", "-p", str(tmp_path)]
    assert tapp.main(args) == 0
    out = capsys.readouterr().out
    assert "resident store: 8 records" in out and "step 2/3" in out
    assert (tmp_path / "log").exists() and (tmp_path / "pth" / "epoch_0.pth").exists()
    payload = ckpt.restore_train_state(str(tmp_path / "pth"))
    assert payload["step"] == 3 and np.isfinite(payload["train_loss"])
    args[args.index("--epochs") + 1] = "2"
    assert tapp.main(args + ["-r"]) == 0
    out = capsys.readouterr().out
    assert "resumed from epoch 0" in out
    assert ckpt.restore_train_state(str(tmp_path / "pth"))["step"] == 6
    assert "Epoch 1" in (tmp_path / "log").read_text()


@pytest.mark.parametrize("feed", ["dense", "compact-u8"])
def test_app_takes_steps_per_dispatch_on_every_feed(tmp_path, feed):
    assert tapp.main(APP + ["--feed", feed, "--steps-per-dispatch", "2",
                            "-p", str(tmp_path)]) == 0
    assert ckpt.restore_train_state(str(tmp_path / "pth"))["step"] == 3


def test_app_refuses_a_sharded_store(tmp_path):
    """A sharded store needs the resident feed; on one process it is the
    whole store (one shard)."""
    with pytest.raises(ValueError, match="--feed resident"):
        tapp.main(APP + ["--resident-shard-store", "-p", str(tmp_path)])
    assert tapp.main(APP + ["--feed", "resident", "--resident-shard-store",
                            "-p", str(tmp_path)]) == 0
