"""The port keeps its own copies of the JAX package's jax-free modules
(``configs``, ``ops.group``, ``ops.group_cpp`` with ``csrc/grouping.cpp``,
``data.heatmaps``, ``data.synthetic`` with the trainer's feeds,
``data.prefetch``, ``data.pipeline``, ``utils.common``, ``utils.oks_eval``,
``utils.config_reader``, ``infer.serving``, ``data.coco_shim``,
``data.build_records``). Each copy is held against its original on the same
numpy inputs, exactly; the compact feed's bf16 arrays are torch tensors in
the port and ``ml_dtypes`` arrays in the JAX package, compared as fp32."""

import dataclasses
import os

import numpy as np
import pytest

from improved_body_parts_tpu import configs as jconfigs
from improved_body_parts_tpu.data import heatmaps as jheatmaps
from improved_body_parts_tpu.data import pipeline as jpipeline
from improved_body_parts_tpu.data import prefetch as jprefetch
from improved_body_parts_tpu.data import synthetic as jsynthetic
from improved_body_parts_tpu.infer import serving as jserving
from improved_body_parts_tpu.ops import group as jgroup
from improved_body_parts_tpu.ops import group_cpp as jgroup_cpp
from improved_body_parts_tpu.utils import common as jcommon
from improved_body_parts_tpu.utils import config_reader as jconfig_reader
from improved_body_parts_tpu.utils import oks_eval as joks_eval
from improved_body_parts_tpu_torch import configs
from improved_body_parts_tpu_torch.apps.evaluate import synthetic_coco
from improved_body_parts_tpu_torch.data import heatmaps, pipeline, prefetch, synthetic
from improved_body_parts_tpu_torch.infer import serving
from improved_body_parts_tpu_torch.ops import group, group_cpp
from improved_body_parts_tpu_torch.utils import common, config_reader, oks_eval


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


# a reference INI in the configobj dialect (inline comments, a nested model
# section, comma lists), and one that sets only part of the fields
INIS = {"full": """
[param]
modelID = 1
scale_search = 0.5, 1, 1.5, 2  # comment
thre1 = 0.2
thre2 = 0.15
connect_ration = 0.9
mid_num = 10
len_rate = 8
connection_tole = 0.6
remove_recon = 1
offset_radius = 3

[models]
[[1]]
boxsize = 384
padValue = 127
stride = 4
max_downsample = 32
""", "partial": """
[param]
modelID = 2
thre1 = 0.05
remove_recon = 0
[models]
[[1]]
boxsize = 256
[[2]]
boxsize = 640
padValue = 0
"""}


@pytest.mark.parametrize("ini", sorted(INIS))
def test_config_reader_matches(tmp_path, ini):
    path = tmp_path / "config"
    path.write_text(INIS[ini])
    assert config_reader.read_ini(str(path)) == jconfig_reader.read_ini(str(path))
    mine = config_reader.apply_ini(configs.CanonicalConfig(), str(path))
    ref = jconfig_reader.apply_ini(jconfigs.CanonicalConfig(), str(path))
    assert dataclasses.asdict(mine.infer) == dataclasses.asdict(ref.infer)
    assert mine.infer != configs.CanonicalConfig().infer


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


# ---------------------------------------------------------------------------
# the trainer's feeds: synthetic compact samples, batches, prefetch, h5
# ---------------------------------------------------------------------------

def _as_np(x):
    """A torch tensor or an (ml_dtypes) numpy array -> numpy, bf16 as fp32."""
    import torch
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _assert_batches_equal(mine, ref):
    mine, ref = list(mine), list(ref)
    assert len(mine) == len(ref) > 0
    for a, b in zip(mine, ref):
        for x, y in zip((a[0], a[1], *(a[2] if isinstance(a[2], tuple) else (a[2],))),
                        (b[0], b[1], *(b[2] if isinstance(b[2], tuple) else (b[2],)))):
            x, y = _as_np(x), _as_np(y)
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("image_u8", [False, True], ids=["bf16", "u8"])
def test_synthetic_get_compact_matches(image_u8):
    """The bf16 rounding done by torch equals ml_dtypes' (nearest even)."""
    import torch
    kw = dict(length=4, seed=5, image_size=64)
    mine = synthetic.SyntheticDataset(configs.get_config("Canonical"), **kw)
    ref = jsynthetic.SyntheticDataset(jconfigs.get_config("Canonical"), **kw)
    for idx in range(3):
        a, b = mine.get_compact(idx, image_u8=image_u8), ref.get_compact(idx, image_u8=image_u8)
        assert a[0].dtype == (torch.uint8 if image_u8 else torch.bfloat16)
        for x, y in zip((a[0], a[1], *a[2]), (b[0], b[1], *b[2])):
            np.testing.assert_array_equal(_as_np(x), _as_np(y))


@pytest.mark.parametrize("compact", [False, True], ids=["dense", "compact"])
def test_synthetic_batches_match(compact):
    kw = dict(length=16, seed=2, image_size=64)
    args = dict(batch_size=4, steps=2, seed=7, rank=1, world=2, compact=compact,
                max_people=5)
    _assert_batches_equal(
        synthetic.SyntheticDataset(configs.get_config("Canonical"), **kw).batches(**args),
        jsynthetic.SyntheticDataset(jconfigs.get_config("Canonical"), **kw).batches(**args))


@pytest.mark.parametrize("workers,compact", [(1, False), (3, True)])
def test_prefetching_loader_matches(workers, compact):
    kw = dict(length=16, seed=3, image_size=64)
    args = dict(batch_size=4, steps=3, seed=11, compact=compact, image_u8=compact)
    mine = prefetch.PrefetchingLoader(
        synthetic.SyntheticDataset(configs.get_config("Canonical"), **kw),
        num_workers=workers)
    ref = jprefetch.PrefetchingLoader(
        jsynthetic.SyntheticDataset(jconfigs.get_config("Canonical"), **kw),
        num_workers=workers)
    assert len(mine) == len(ref) == 16
    _assert_batches_equal(mine.batches(**args), ref.batches(**args))


def _write_tiny_h5(path):
    """The reference layout, as tests/test_pipeline.py builds it."""
    import json

    import h5py
    rng = np.random.RandomState(0)
    img = rng.randint(0, 255, (240, 320, 3), np.uint8)
    mask_miss = np.full((240, 320), 255, np.uint8)
    mask_miss[:40, :60] = 0
    mask_all = np.zeros((240, 320), np.uint8)
    mask_all[60:200, 100:220] = 255
    joints = np.zeros((1, 17, 3))
    joints[0, :, 2] = 2.0
    joints[0, 0] = [160.0, 80.0, 1.0]
    joints[0, 5] = [180.0, 110.0, 1.0]
    joints[0, 6] = [140.0, 110.0, 1.0]
    meta = {"image": "000000000001", "joints": joints.tolist(),
            "objpos": [[160.0, 120.0]], "scale_provided": [140.0 / 512]}
    with h5py.File(path, "w") as f:
        f.create_group("images").create_dataset("000000000001", data=img)
        f.create_group("masks").create_dataset(
            "000000000001", data=np.stack([mask_miss, mask_all], axis=2))
        ds = f.create_group("dataset").create_dataset("0000000", data=json.dumps(meta))
        ds.attrs["meta"] = json.dumps(meta)


@pytest.mark.parametrize("compact", [False, True], ids=["dense", "compact"])
def test_coco_h5_dataset_matches(tmp_path, compact):
    path = str(tmp_path / "tiny.h5")
    _write_tiny_h5(path)
    cfg = dataclasses.replace(configs.get_config("Canonical"), width=128, height=128)
    jcfg = dataclasses.replace(jconfigs.get_config("Canonical"), width=128, height=128)
    mine = pipeline.CocoH5Dataset(path, cfg, augment=True)
    ref = jpipeline.CocoH5Dataset(path, jcfg, augment=True)
    assert len(mine) == len(ref) == 1
    args = dict(batch_size=2, steps=2, seed=4, compact=compact, image_u8=compact)
    _assert_batches_equal(mine.batches(**args), ref.batches(**args))
    a, b = pipeline.AugmentSelection(flip=True, degree=10.0, scale=1.2), \
        jpipeline.AugmentSelection(flip=True, degree=10.0, scale=1.2)
    np.testing.assert_array_equal(a.affine((100.0, 80.0), 0.4, cfg)[0],
                                  b.affine((100.0, 80.0), 0.4, jcfg)[0])


# ---------------------------------------------------------------------------
# the COCO record builder and its annotation shim
# ---------------------------------------------------------------------------

def _shim_masks(seed, h=37, w=23):
    """A random mask, its uncompressed and compressed RLE, and a polygon."""
    from tests.test_builder_seam import encode_rle_counts, mask_to_uncompressed_rle
    rng = np.random.RandomState(seed)
    mask = (rng.rand(h, w) > 0.6).astype(np.uint8)
    rle = mask_to_uncompressed_rle(mask)
    packed = {"counts": encode_rle_counts(rle["counts"]), "size": rle["size"]}
    poly = [list(rng.uniform(0, min(h, w), 8)), list(rng.uniform(0, w, 4)),
            [1.0, 1.0, float(w - 2), 3.0, float(w // 2), float(h - 2)]]
    return mask, rle, packed, poly


@pytest.mark.parametrize("seed", range(3))
def test_coco_shim_matches(seed):
    from improved_body_parts_tpu.data import coco_shim as jshim
    from improved_body_parts_tpu_torch.data import coco_shim as shim
    mask, rle, packed, poly = _shim_masks(seed)
    assert shim.decode_rle_counts(packed["counts"]) == \
        jshim.decode_rle_counts(packed["counts"]) == rle["counts"]
    for r in (rle, packed):
        got = shim.rle_to_mask(r, *mask.shape)
        assert np.array_equal(got, jshim.rle_to_mask(r, *mask.shape))
        assert np.array_equal(got, mask)
    got = shim.polygons_to_mask(poly, *mask.shape)
    assert np.array_equal(got, jshim.polygons_to_mask(poly, *mask.shape))
    assert got.any()


@pytest.fixture(scope="module")
def mini_coco(tmp_path_factory):
    """tests/test_builder_seam.py's on-disk mini-COCO (polygon people,
    a crowd RLE region, people without keypoints)."""
    from tests.test_builder_seam import _fabricate_mini_coco
    root = str(tmp_path_factory.mktemp("mini_coco"))
    _fabricate_mini_coco(root)
    return root, os.path.join(root, "annotations", "person_keypoints_train2017.json")


def test_mini_coco_lookups_match(mini_coco):
    from improved_body_parts_tpu.data.coco_shim import MiniCOCO as JMiniCOCO
    from improved_body_parts_tpu_torch.data.coco_shim import MiniCOCO
    _, ann_file = mini_coco
    mine, ref = MiniCOCO(ann_file), JMiniCOCO(ann_file)
    assert mine.imgs == ref.imgs and mine.anns == ref.anns
    assert mine.getAnnIds() == ref.getAnnIds()
    for img_id in list(ref.imgs) + [99]:
        ids = mine.getAnnIds(imgIds=img_id)
        assert ids == ref.getAnnIds(imgIds=img_id) == ref.getAnnIds(imgIds=[img_id])
        assert mine.loadAnns(ids) == ref.loadAnns(ids)
        for ann in mine.loadAnns(ids):
            assert np.array_equal(mine.annToMask(ann), ref.annToMask(ann))
    assert mine.loadAnns(1) == ref.loadAnns(1)


@pytest.mark.parametrize("v", [0, 1, 2])
def test_encode_visibility_matches(v):
    from improved_body_parts_tpu.data import build_records as jbr
    from improved_body_parts_tpu_torch.data import build_records as br
    assert br.encode_visibility(v) == jbr.encode_visibility(v)


def _records_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert set(x) == set(y)
        for k in x:
            if isinstance(x[k], np.ndarray):
                assert np.array_equal(x[k], y[k]), k
            else:
                assert x[k] == y[k], k


def test_build_records_functions_match(mini_coco):
    from improved_body_parts_tpu.data import build_records as jbr
    from improved_body_parts_tpu.data.coco_shim import MiniCOCO as JMiniCOCO
    from improved_body_parts_tpu_torch.data import build_records as br
    from improved_body_parts_tpu_torch.data.coco_shim import MiniCOCO
    _, ann_file = mini_coco
    mine, ref = MiniCOCO(ann_file), JMiniCOCO(ann_file)
    n_mains = 0
    for idx, (img_id, meta) in enumerate(sorted(ref.imgs.items())):
        anns = ref.loadAnns(ref.getAnnIds(imgIds=img_id))
        persons = br.person_records(anns)
        _records_equal(persons, jbr.person_records(anns))
        mains = br.select_main_persons(persons)
        want = jbr.select_main_persons(jbr.person_records(anns))
        _records_equal(mains, want)
        n_mains += len(mains)
        for ds_type in ("COCO", "COCO_val"):
            got = list(br.image_instances(meta, img_id, idx, anns, ds_type))
            assert got == list(jbr.image_instances(meta, img_id, idx, anns, ds_type))
        for a, b in zip(br.make_masks(mine, meta, anns), jbr.make_masks(ref, meta, anns)):
            assert a.dtype == b.dtype == np.uint8 and np.array_equal(a, b)
    assert n_mains == 3
