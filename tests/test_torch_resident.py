"""The port's device-resident feed (``data/resident.py``,
``train_lib.resident_inputs``, ``make_resident_train_step``) and the batched
``affine_warp`` against the JAX package's, with the tiny config of
tests/test_torch_train.py (nstack 2, inp_dim 32, increase 16, 64², batch 8).

Stores and plans are the same numpy code in both packages: the store
arrays, joints, anchors and sample indices are held exactly, the float32
inverse maps at 1e-6. The preprocessing (gather, /255, the per-sample warp
with the border fills, the 4x4 box mean) is held against the JAX
package's own ``_build_resident_fn`` at 1e-6 absolute, the tolerance
tests/test_torch_warp.py holds ``affine_warp`` to; on the reference-format
h5 that tests/test_builder_seam.py fabricates (masks and canvas padding)
and on the synthetic store (no masks). The resident step, two steps from
one state: train-mode BatchNorm in float64 at 1e-6 of each tensor's scale
(``jax_float64``, as tests/test_torch_train.py), frozen BN in fp32 at
1e-4. The JAX state is the port's reference init carried across by
``convert_torch_state_dict``, so no JAX init runs.
"""

import contextlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from improved_body_parts_tpu import train_lib as jtrain_lib
from improved_body_parts_tpu.data import resident as jresident
from improved_body_parts_tpu.data.synthetic import SyntheticDataset as JSynthetic
from improved_body_parts_tpu.models import imhn as jimhn
from improved_body_parts_tpu.models.imhn import create_model
from improved_body_parts_tpu.ops import warp as jwarp
from improved_body_parts_tpu.utils.checkpoint import convert_torch_state_dict
from improved_body_parts_tpu_torch import train_lib
from improved_body_parts_tpu_torch.data import resident
from improved_body_parts_tpu_torch.data.synthetic import SyntheticDataset
from improved_body_parts_tpu_torch.models.imhn import PoseNet
from improved_body_parts_tpu_torch.ops import warp
from improved_body_parts_tpu_torch.utils import checkpoint as ckpt
from tests.test_torch_predict import single_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_train import B, LRS, SIZE, TOL64, _configs, _rel, jax_float64

P = 4            # people slots a sample
N_RECORDS = 6


# ---------------------------------------------------------------------------
# stores and plans
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def synthetic_stores():
    jcfg, cfg = _configs()
    return (jresident.build_store(JSynthetic(jcfg, length=N_RECORDS, image_size=SIZE)),
            resident.build_store(SyntheticDataset(cfg, length=N_RECORDS,
                                                  image_size=SIZE)))


@pytest.fixture(scope="module")
def h5_path(tmp_path_factory):
    pytest.importorskip("h5py")
    from improved_body_parts_tpu.data import build_records
    from tests.test_builder_seam import _fabricate_mini_coco
    root = str(tmp_path_factory.mktemp("coco"))
    _fabricate_mini_coco(root)
    build_records.build(root, root)
    return os.path.join(root, "coco_train_dataset512.h5")


def h5_stores(h5_path, canvas_hw):
    from improved_body_parts_tpu.data.pipeline import CocoH5Dataset as JCocoH5
    from improved_body_parts_tpu_torch.data.pipeline import CocoH5Dataset
    jcfg, cfg = _configs()
    return (jresident.build_store(JCocoH5(h5_path, jcfg), canvas_hw=canvas_hw),
            resident.build_store(CocoH5Dataset(h5_path, cfg), canvas_hw=canvas_hw))


def assert_stores_equal(jstore, store):
    assert len(store) == len(jstore)
    for key in ("images", "mask_miss", "mask_all", "objpos", "scale_provided"):
        want, got = getattr(jstore, key), getattr(store, key)
        if want is None:
            assert got is None, key
        else:
            assert got.dtype == want.dtype, key
            np.testing.assert_array_equal(got, want, err_msg=key)
    for j, jj in zip(store.joints, jstore.joints):
        np.testing.assert_array_equal(j, jj)


def test_build_store_synthetic_matches_jax(synthetic_stores):
    jstore, store = synthetic_stores
    assert store.images.shape == (N_RECORDS, SIZE, SIZE, 3)
    assert_stores_equal(jstore, store)
    arrays = store.device_arrays(torch.device("cpu"))
    assert set(arrays) == {"images"} and arrays["images"].dtype == torch.uint8
    np.testing.assert_array_equal(arrays["images"].numpy(), store.images)


@pytest.mark.parametrize("canvas_hw", [(192, 256), (80, 100)],
                         ids=["padded", "downscaled"])
def test_build_store_h5_matches_jax(h5_path, canvas_hw):
    """Records of 160x200: padded to the canvas with the border colours, or
    INTER_AREA-downscaled into a smaller one with joints, objpos and scale."""
    jstore, store = h5_stores(h5_path, canvas_hw)
    assert store.images.shape == (3, *canvas_hw, 3)
    assert_stores_equal(jstore, store)
    if canvas_hw == (192, 256):
        assert tuple(store.images[0, 170, 40]) == resident.BORDER_BGR
        assert store.mask_miss[0, 170, 40] == 255 and store.mask_all[0, 170, 40] == 0
    assert set(store.device_arrays(torch.device("cpu"))) == {
        "images", "mask_miss", "mask_all"}


def feeds(stores, augment):
    jcfg, cfg = _configs()
    jstore, store = stores
    return (jresident.ResidentFeed(jstore, jcfg, augment=augment, max_people=P),
            resident.ResidentFeed(store, cfg, augment=augment, max_people=P))


@pytest.mark.parametrize("rank,world", [(0, 1), (0, 2), (1, 2)])
@pytest.mark.parametrize("augment", [False, True])
def test_plan_batches_match_jax(synthetic_stores, augment, rank, world):
    jfeed, feed = feeds(synthetic_stores, augment)
    want = list(jfeed.plan_batches(B, 3, seed=7, rank=rank, world=world))
    got = list(feed.plan_batches(B, 3, seed=7, rank=rank, world=world))
    assert len(got) == len(want) == 3
    for (i, m, j), (ji, jm, jj) in zip(got, want):
        assert i.dtype == np.int32 and m.dtype == j.dtype == np.float32
        assert i.shape == (B // world,) and j.shape == (B // world, P, 18, 3)
        np.testing.assert_array_equal(i, ji)
        np.testing.assert_allclose(m, jm, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(j, jj)
    if not augment:
        assert all((m == resident._IDENTITY_M).all() for _, m, _ in got)


def test_sharded_store_plans_are_refused(synthetic_stores):
    """A sharded plan is refused where the records or the batch do not
    divide over the shards (tests/test_torch_mesh.py holds the plans that
    do against JAX's)."""
    _, feed = feeds(synthetic_stores, True)
    with pytest.raises(ValueError, match="store shards"):
        next(feed.plan_batches(B, 1, store_shards=4))       # 6 records
    with pytest.raises(ValueError, match="store shards"):
        next(feed.plan_batches(8, 1, store_shards=3))     # batch 8


# ---------------------------------------------------------------------------
# the warp with one map a sample, and the resident preprocessing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("out_hw,fill", [(None, 0.0), ((36, 28), "vector")])
def test_batched_affine_warp_equals_per_sample_calls(out_hw, fill):
    rng = np.random.RandomState(11)
    imgs = torch.from_numpy(rng.rand(5, 30, 40, 3).astype(np.float32))
    maps = np.stack([warp.rotation_matrix((rng.uniform(5, 35), rng.uniform(5, 25)),
                                          rng.uniform(-40, 40), rng.uniform(0.7, 1.3))
                     for _ in range(5)])
    maps[:, :, 2] += rng.uniform(-3, 3, (5, 2)).astype(np.float32)
    fill_value = np.float32([0.1, 0.5, 0.9]) if fill == "vector" else fill
    got = warp.affine_warp(imgs, torch.from_numpy(maps), fill_value=fill_value,
                           out_hw=out_hw)
    for b in range(5):
        one = warp.affine_warp(imgs[b], maps[b], fill_value=fill_value,
                               out_hw=out_hw)
        assert torch.equal(got[b], one), b
    with pytest.raises(ValueError):
        warp.affine_warp(imgs, torch.from_numpy(maps[:4]))


def jax_resident_inputs(jstore, cfg, idx, inv_m):
    """The JAX package's resident preprocessing: its ``_build_resident_fn``
    around a step that returns the images and masks it is given."""
    fn = jtrain_lib._build_resident_fn(
        lambda state, imgs, mm, heat, lr: (imgs, mm, heat[1]), cfg)
    arrays = {"images": jstore.images}
    if jstore.mask_miss is not None:
        arrays.update(mask_miss=jstore.mask_miss, mask_all=jstore.mask_all)
    out = fn(None, {k: jnp.asarray(v) for k, v in arrays.items()},
             jnp.asarray(idx), jnp.asarray(inv_m), None, None)
    return [np.asarray(x) for x in out]


@pytest.mark.parametrize("source,augment", [("synthetic", True), ("h5", True),
                                            ("h5", False)])
def test_resident_inputs_match_jax(synthetic_stores, h5_path, source, augment):
    stores = (synthetic_stores if source == "synthetic"
              else h5_stores(h5_path, (192, 256)))
    jcfg, cfg = _configs()
    _, feed = feeds(stores, augment)
    idx, inv_m, _ = next(feed.plan_batches(B, 1, seed=3))
    want = jax_resident_inputs(stores[0], jcfg, idx, inv_m)
    store = stores[1].device_arrays(torch.device("cpu"))
    before = {k: v.clone() for k, v in store.items()}
    got = train_lib.resident_inputs(store, torch.from_numpy(idx),
                                    torch.from_numpy(inv_m), cfg)
    shapes = [(B, SIZE, SIZE, 3), (B, SIZE // 4, SIZE // 4, 1),
              (B, SIZE // 4, SIZE // 4)]
    for g, w, shape in zip(got, want, shapes):
        assert g.shape == shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-6)
    assert all(torch.equal(store[k], v) for k, v in before.items())
    # the masks the comparison sees are not constant: people in mask_all
    # (augmented), the crowd region at the records' top left in mask_miss
    # (the identity map shows the canvas' top left)
    if source == "h5" and augment:
        assert got[2].min() < 0.5 < got[2].max()
    elif source == "h5":
        assert got[1].min() < 0.5 < got[1].max()


# ---------------------------------------------------------------------------
# the resident step
# ---------------------------------------------------------------------------

def resident_plans(stores, steps=2, seed=5):
    """Augmented plans of ``steps`` steps (idx, inv_m, joints) from the port's
    feed (equal to the JAX package's, test_plan_batches_match_jax)."""
    _, feed = feeds(stores, augment=True)
    return list(feed.plan_batches(B, steps, seed=seed))


@contextlib.contextmanager
def jax_float64_resident():
    """``jax_float64``, with the JAX package's resident preprocessing
    (``train_lib``'s and ``ops/warp``'s ``jnp``) widened too: in fp32 it
    rounds the warped pixels a little differently from the port, and the
    train-mode step at this size turns 1e-7 at its input into percents
    (tests/test_torch_train.py), so the float64 comparison runs the whole
    step in float64, the port's included (``resident_inputs`` follows the
    model's type)."""
    with jax_float64():
        saved = jtrain_lib.jnp, jwarp.jnp
        jtrain_lib.jnp = jwarp.jnp = jimhn.jnp
        try:
            yield
        finally:
            jtrain_lib.jnp, jwarp.jnp = saved


def jax_state(model, jcfg, dtype):
    """The port model's weights in a JAX TrainState of ``dtype`` (call it
    under ``jax_float64`` for float64)."""
    params, stats = convert_torch_state_dict(model.state_dict())
    cast = lambda tree: jax.tree_util.tree_map(lambda x: jnp.asarray(x, dtype), tree)
    return jtrain_lib.create_train_state(cast(params), cast(stats), jcfg.train)


def port_model(cfg, dtype):
    model = PoseNet(cfg.model, compute_dtype=torch.float32,
                    generator=torch.Generator().manual_seed(0))
    model.to(dtype)
    model.compute_dtype = dtype
    return model


def tolerances(freeze_bn):
    return (1e-4, 1e-3) if freeze_bn else (TOL64, 1e-6)


def assert_held(got, metrics, want, jmetrics, before, freeze_bn, tol=None):
    """A port payload after a step against the JAX package's: metrics, every
    parameter, momentum buffer and BN statistic, and in float64 the
    parameters' move; ``tol`` replaces the BN mode's tolerance."""
    tol, floor = (tol or tolerances(freeze_bn)[0]), tolerances(freeze_bn)[1]
    assert got["step"] == want["step"]
    assert float(metrics["skipped"]) == jmetrics["skipped"] == 0.0
    np.testing.assert_allclose(float(metrics["loss"]), jmetrics["loss"], rtol=tol)
    np.testing.assert_allclose(float(metrics["grad_norm"]), jmetrics["grad_norm"],
                               rtol=tol)
    mom, jmom = (p["optimizer_weight"]["momentum_buffer"] for p in (got, want))
    assert _rel(mom, jmom, floor) < tol
    params = {k: v for k, v in got["weights"].items() if k in mom}
    jparams = {k: v for k, v in want["weights"].items() if k in mom}
    assert _rel(params, jparams, floor) < tol
    if not freeze_bn:    # in fp32 a move of ~1e-6 carries the rounding of p
        moved = {k: params[k] - before["weights"][k] for k in params}
        assert _rel(moved, {k: jparams[k] - before["weights"][k] for k in params},
                    floor) < tol
    bn = {k: v for k, v in got["weights"].items() if "running" in k}
    if freeze_bn:
        assert all(torch.equal(v, before["weights"][k]) for k, v in bn.items())
    else:
        assert _rel(bn, {k: want["weights"][k] for k in bn}, floor) < tol


@pytest.mark.parametrize("freeze_bn", [False, True],
                         ids=["train_bn_float64", "frozen_bn_fp32"])
def test_resident_steps_match_jax(synthetic_stores, freeze_bn):
    dtype = np.float32 if freeze_bn else np.float64
    jcfg, cfg = _configs()
    plans = resident_plans(synthetic_stores)
    model = port_model(cfg, torch.float32)
    jstore = {"images": jnp.asarray(synthetic_stores[0].images)}
    with (jax_float64_resident() if dtype == np.float64
          else contextlib.nullcontext()):
        jstate = jax_state(model, jcfg, dtype)
        jmodel = create_model(jcfg.model, dtype=jnp.dtype(dtype))
        jstep = jtrain_lib.make_resident_train_step(jmodel, jcfg, donate=False,
                                                    freeze_bn=freeze_bn)
        traj = []
        for (idx, inv_m, joints), lr in zip(plans, LRS):
            jstate, jm = jstep(jstate, jstore, jnp.asarray(idx),
                               jnp.asarray(inv_m.astype(dtype)),
                               jnp.asarray(joints.astype(dtype)),
                               jnp.asarray(lr, dtype))
            traj.append((ckpt.train_state_from_flax(jstate),
                         {k: float(v) for k, v in jm.items()}))

    tdtype = torch.float32 if freeze_bn else torch.float64
    state = train_lib.create_train_state(port_model(cfg, tdtype), cfg.train)
    store = synthetic_stores[1].device_arrays(torch.device("cpu"))
    step = train_lib.make_resident_train_step(state.model, cfg, freeze_bn=freeze_bn)
    for (idx, inv_m, joints), lr, (want, jm) in zip(plans, LRS, traj):
        before = train_lib.state_payload(state, cfg.train)
        metrics = step(state, store, torch.from_numpy(idx), torch.from_numpy(inv_m),
                       torch.from_numpy(joints).to(tdtype), lr)
        assert_held(train_lib.state_payload(state, cfg.train), metrics, want, jm,
                    before, freeze_bn)


def test_resident_identity_step_equals_the_compact_feed(synthetic_stores):
    """Unaugmented, the resident step is the compact feed's step on the same
    records (uint8 images, all-ones masks, the same padded joints): the
    identity warp copies every pixel."""
    _, cfg = _configs()
    jstore, store_h = synthetic_stores
    feed = resident.ResidentFeed(store_h, cfg, augment=False, max_people=P)
    idx, inv_m, joints = next(feed.plan_batches(B, 1, seed=2))
    out = []
    for make in ("resident", "compact"):
        state = train_lib.create_train_state(port_model(cfg, torch.float32), cfg.train)
        if make == "resident":
            step = train_lib.make_resident_train_step(state.model, cfg, freeze_bn=True)
            m = step(state, store_h.device_arrays(torch.device("cpu")),
                     torch.from_numpy(idx), torch.from_numpy(inv_m),
                     torch.from_numpy(joints), LRS[0])
        else:
            imgs = torch.from_numpy(store_h.images[idx])
            ones = torch.ones((B, SIZE // 4, SIZE // 4))
            step = train_lib.make_train_step(state.model, cfg, freeze_bn=True,
                                             compact_gt=True)
            m = step(state, imgs, ones[..., None], (torch.from_numpy(joints), ones),
                     LRS[0])
        out.append((m, train_lib.state_payload(state, cfg.train)))
    (ma, a), (mb, b) = out
    assert float(ma["skipped"]) == 0.0 and torch.equal(ma["loss"], mb["loss"])
    for k, v in a["weights"].items():
        assert torch.equal(v, b["weights"][k]), k
