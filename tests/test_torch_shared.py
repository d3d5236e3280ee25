"""The port keeps its own copies of the JAX package's jax-free modules
(``configs``, ``ops.group``, ``ops.group_cpp`` with ``csrc/grouping.cpp``,
``data.heatmaps``, ``data.synthetic``, ``utils.common``, ``utils.oks_eval``,
``infer.serving``). Each copy is held against its original on the same
numpy inputs, exactly."""

import dataclasses

import numpy as np
import pytest

from improved_body_parts_tpu import configs as jconfigs
from improved_body_parts_tpu.data import heatmaps as jheatmaps
from improved_body_parts_tpu.data import synthetic as jsynthetic
from improved_body_parts_tpu.infer import serving as jserving
from improved_body_parts_tpu.ops import group as jgroup
from improved_body_parts_tpu.ops import group_cpp as jgroup_cpp
from improved_body_parts_tpu.utils import common as jcommon
from improved_body_parts_tpu.utils import oks_eval as joks_eval
from improved_body_parts_tpu_torch import configs
from improved_body_parts_tpu_torch.apps.evaluate import synthetic_coco
from improved_body_parts_tpu_torch.data import heatmaps, synthetic
from improved_body_parts_tpu_torch.infer import serving
from improved_body_parts_tpu_torch.ops import group, group_cpp
from improved_body_parts_tpu_torch.utils import common, oks_eval


def _same(a, b) -> bool:
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (np.asarray(a).dtype == np.asarray(b).dtype
                and np.array_equal(a, b))
    return a == b


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(jconfigs.CONFIGS))
def test_config_matches(name):
    mine, ref = configs.get_config(name), jconfigs.get_config(name)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    for prop in ("num_parts", "paf_layers", "heat_layers", "num_layers",
                 "heat_start", "bkg_start", "limbs_conn", "flip_heat_ord",
                 "flip_paf_ord", "mask_shape", "parts_shape", "paf_thre"):
        assert _same(getattr(mine, prop), getattr(ref, prop)), prop
    with pytest.raises(KeyError):
        configs.get_config(name + "?")


def test_config_constants_match():
    names = sorted(n for n in dir(jconfigs) if n.isupper())
    assert names == sorted(n for n in dir(configs) if n.isupper())
    assert sorted(configs.CONFIGS) == sorted(jconfigs.CONFIGS)   # entries above
    for n in names:
        if n != "CONFIGS":
            assert _same(getattr(configs, n), getattr(jconfigs, n)), n
    joints = np.random.RandomState(0).rand(3, 17, 3) * [400, 300, 3]
    np.testing.assert_array_equal(configs.convert_coco_joints(joints),
                                  jconfigs.convert_coco_joints(joints))


# ---------------------------------------------------------------------------
# grouping: numpy and C++
# ---------------------------------------------------------------------------

def _random_scene(seed, P=16, max_conns=5):
    """Structurally valid connection tables and candidates."""
    rng = np.random.RandomState(seed)
    cands = group.build_joint_candidates(
        rng.uniform(0, 400, (configs.NUM_PARTS, P, 2)),
        rng.uniform(0.1, 1.0, (configs.NUM_PARTS, P)),
        rng.rand(configs.NUM_PARTS, P) > 0.2)
    connected = []
    for fr, to in configs.LIMBS_CONN:
        k = rng.randint(0, max_conns + 1)
        rows = np.zeros((k, 6), np.float64)
        if k:
            src = rng.choice(P, size=k, replace=False)
            dst = rng.choice(P, size=k, replace=False)
            rows[:, 0], rows[:, 1] = fr * P + src, to * P + dst
            rows[:, 2] = rng.uniform(0.0, 1.2, k)
            rows[:, 3], rows[:, 4] = src, dst
            rows[:, 5] = rng.uniform(5, 200, k)
        connected.append(rows)
    return connected, cands


@pytest.mark.parametrize("impl", ["numpy", "cpp"])
@pytest.mark.parametrize("remove_recon", [False, True])
@pytest.mark.parametrize("seed", range(4))
def test_find_humans_matches(seed, remove_recon, impl):
    connected, cands = _random_scene(seed)
    cfg = configs.InferenceConfig(remove_recon=remove_recon)
    jcfg = jconfigs.InferenceConfig(remove_recon=remove_recon)
    if impl == "cpp":
        assert group_cpp.is_available() and jgroup_cpp.is_available()
        assert group_cpp._LIB != jgroup_cpp._LIB
        mine, _ = group_cpp.find_humans(connected, cands.copy(), cfg)
        ref, _ = jgroup_cpp.find_humans(connected, cands.copy(), jcfg)
    else:
        mine, _ = group.find_humans(connected, cands.copy(), cfg)
        ref, _ = jgroup.find_humans(connected, cands.copy(), jcfg)
    assert mine.shape == ref.shape and len(ref)
    np.testing.assert_array_equal(mine, ref)
    for a, b in zip(group.humans_to_keypoints(mine, cands),
                    jgroup.humans_to_keypoints(ref, cands)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# synthetic scenes and their ground-truth maps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(3))
def test_random_people_and_render_image_match(seed):
    joints = synthetic.random_people(np.random.RandomState(seed), 96, 128)
    np.testing.assert_array_equal(
        joints, jsynthetic.random_people(np.random.RandomState(seed), 96, 128))
    np.testing.assert_array_equal(
        synthetic.render_image(joints, 96, 128, np.random.RandomState(seed)),
        jsynthetic.render_image(joints, 96, 128, np.random.RandomState(seed)))


@pytest.mark.parametrize("name", ["Canonical", "Final384x4"])
def test_heatmapper_matches(name):
    rng = np.random.RandomState(3)
    mine = heatmaps.Heatmapper(configs.get_config(name))
    ref = jheatmaps.Heatmapper(jconfigs.get_config(name))
    joints = jsynthetic.random_people(rng, ref.h * 4, ref.w * 4, max_people=4)
    joints[0, 5, 2] = 2.0                          # one absent joint
    mask_all = (rng.rand(ref.h, ref.w) > 0.1).astype(np.float32)
    np.testing.assert_array_equal(mine.create_heatmaps(joints, mask_all),
                                  ref.create_heatmaps(joints, mask_all))
    np.testing.assert_array_equal(heatmaps.erode3(mask_all),
                                  jheatmaps.erode3(mask_all))


@pytest.mark.parametrize("idx", range(3))
def test_synthetic_dataset_item_matches(idx):
    mine = synthetic.SyntheticDataset(configs.get_config("Canonical"), length=4,
                                      seed=5, image_size=128)[idx]
    ref = jsynthetic.SyntheticDataset(jconfigs.get_config("Canonical"),
                                      length=4, seed=5, image_size=128)[idx]
    for a, b in zip(mine, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# OKS evaluation, drawing, serving
# ---------------------------------------------------------------------------

def test_keypoint_eval_matches():
    _, gt = synthetic_coco(6, size=128, seed=11)
    rng = np.random.RandomState(0)
    dets = []
    for a in gt["annotations"]:
        kps = np.asarray(a["keypoints"], np.float64).reshape(17, 3)
        kps[:, :2] += rng.normal(0, 3.0, (17, 2))
        dets.append({"image_id": a["image_id"], "category_id": 1,
                     "keypoints": kps.reshape(-1).tolist(),
                     "score": float(rng.rand())})
    dets.append(dict(dets[0], score=0.01))         # a duplicate: a false positive
    ids = [im["id"] for im in gt["images"]]
    mine = oks_eval.KeypointEval(gt, dets, img_ids=ids).run(print_fn=None)
    ref = joks_eval.KeypointEval(gt, dets, img_ids=ids).run(print_fn=None)
    np.testing.assert_array_equal(mine, ref)
    assert 0.0 < mine[0] < 1.0


@pytest.mark.parametrize("draw", ["draw_humans", "draw_humans_ellipse"])
def test_draw_humans_matches(draw):
    joints = jsynthetic.random_people(np.random.RandomState(2), 128, 128)
    joints[0, 3, 2] = 0.0                          # one joint not drawn
    img = (np.random.RandomState(1).rand(128, 128, 3) * 255).astype(np.uint8)
    np.testing.assert_array_equal(getattr(common, draw)(img, joints),
                                  getattr(jcommon, draw)(img, joints))
    assert common.COCO_COLORS == jcommon.COCO_COLORS
    assert common.LIMB_COLORS == jcommon.LIMB_COLORS
    assert common.COLOR_BOARD == jcommon.COLOR_BOARD


class _FakePredictor:
    """Letterbox to a 64^2 canvas; each image's one person sits at its
    mean pixel value, so a result shows which frame it came from."""

    def letterbox(self, img):
        scale = 64.0 / max(img.shape[:2])
        out = np.zeros((64, 64, 3), np.uint8)
        out[:img.shape[0], :img.shape[1]] = img[:64, :64]
        return out, scale

    def predict_batch(self, imgs, img_hs=None, use_cpp=None, content_hws=None,
                      scales=None, angles=(0.0,)):
        return [(np.full((1, 18, 3), float(im.mean()) + h + sum(scales)),
                 np.array([h / 64.0])) for im, h in zip(imgs, img_hs)]


@pytest.mark.parametrize("batch,depth", [(4, 1), (3, 2)])
def test_pipelined_server_matches(batch, depth):
    rng = np.random.RandomState(batch)
    frames = [(rng.rand(rng.randint(16, 64), 64, 3) * 255).astype(np.uint8)
              for _ in range(9)]
    got = []
    for mod in (serving, jserving):
        serve = mod.PipelinedServer(_FakePredictor(), batch_size=batch,
                                    depth=depth, scales=(1.0, 2.0))
        try:
            got.append(serve.predict_many(frames))
        finally:
            serve.close()
    for (ka, sa), (kb, sb) in zip(*got):
        np.testing.assert_array_equal(ka, kb)
        np.testing.assert_array_equal(sa, sb)
