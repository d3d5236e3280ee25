"""The port's serving slice against the JAX Predictor: a tiny model with the
same weights in both packages, B=2 at 128^2.

Exact: valid masks and connection slots of the decoded tables. Valid
floats and person keypoints: 1e-4 absolute (fp32 on both sides; invalid
slots are not compared). Random weights give few or no peaks, so the
post-processing is also held against JAX on GT-rendered scene maps.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from improved_body_parts_tpu import configs as jconfigs
from improved_body_parts_tpu.configs import CanonicalConfig
from improved_body_parts_tpu.data.synthetic import SyntheticDataset
from improved_body_parts_tpu.infer import predict as jpredict
from improved_body_parts_tpu.models.imhn import create_model
from improved_body_parts_tpu.utils.checkpoint import convert_torch_state_dict
from improved_body_parts_tpu_torch.infer import predict as tpredict
from improved_body_parts_tpu_torch import configs as tconfigs
from improved_body_parts_tpu_torch.infer.serving import PipelinedServer
from improved_body_parts_tpu_torch.models.imhn import PoseNet

ATOL = 1e-4
SIZE = 128
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def single_torch_thread():
    """One intra-op thread for a module's CPU work, restored after it: the
    port's small tensors gain nothing from more, and threads that spin on
    them oversubscribe the cores (tests/test_torch_apps.py alone took 112 s
    with the default threads and 46 s with one; the parallel tier-1 run
    multiplies the difference). Imported by the other port test modules."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(cfgs=tconfigs):
    """The tiny config, built from the port's ``configs`` (or, for the JAX
    side, from ``jconfigs``)."""
    cfg = cfgs.CanonicalConfig(width=SIZE, height=SIZE,
                               model=cfgs.ModelConfig(nstack=2, inp_dim=32,
                                                      increase=16, se_reduction=8))
    return dataclasses.replace(cfg, infer=dataclasses.replace(
        cfg.infer, boxsize=SIZE, thre1=0.05, thre2=0.05,
        min_person_score=0.0, min_person_parts=1))


@pytest.fixture(scope="module")
def pair():
    """(JAX Predictor, port Predictor) over the same fp32 weights."""
    config = _config()
    g = torch.Generator().manual_seed(0)
    port_model = PoseNet(config.model, compute_dtype=torch.float32, generator=g)
    with torch.no_grad():   # weights large enough to give a few peaks
        for m in port_model.modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
                m.weight.normal_(0.0, 0.1, generator=g)
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0.0, 0.2, generator=g)
                m.running_var.uniform_(0.5, 2.0, generator=g)
    port_model.eval()
    params, stats = convert_torch_state_dict(port_model.state_dict())
    jconfig = _config(jconfigs)
    jmodel = create_model(jconfig.model, dtype=jnp.float32)
    jpred = jpredict.Predictor(jmodel, {"params": params, "batch_stats": stats},
                               jconfig)
    return jpred, tpredict.Predictor(port_model, config, device=CPU)


def _frames(n, seed):
    ds = SyntheticDataset(CanonicalConfig(), length=n, image_size=SIZE, seed=seed)
    return np.stack([(ds[i][0] * 255).astype(np.uint8) for i in range(n)])


def _assert_tables_match(got_buf, want_buf, P):
    gp, gc = tpredict.unpack_results(got_buf, P)
    wp, wc = jpredict.unpack_results(want_buf, P)
    np.testing.assert_array_equal(gp.valid, wp.valid)
    np.testing.assert_array_equal(gp.n_raw, wp.n_raw)
    np.testing.assert_allclose(gp.xy[gp.valid], wp.xy[wp.valid], rtol=0, atol=ATOL)
    np.testing.assert_allclose(gp.score[gp.valid], wp.score[wp.valid],
                               rtol=0, atol=ATOL)
    np.testing.assert_array_equal(gc.valid, wc.valid)
    v = gc.valid
    np.testing.assert_array_equal(gc.src_slot[v], wc.src_slot[v])
    np.testing.assert_array_equal(gc.dst_slot[v], wc.dst_slot[v])
    np.testing.assert_allclose(gc.score[v], wc.score[v], rtol=0, atol=ATOL)
    np.testing.assert_allclose(gc.limb_len[v], wc.limb_len[v], rtol=0, atol=ATOL)
    return int(gp.valid.sum())


def _assert_people_match(got, want):
    assert len(got) == len(want)
    for (gk, gs), (wk, ws) in zip(got, want):
        assert gk.shape == wk.shape
        np.testing.assert_allclose(gk, wk, rtol=0, atol=ATOL)
        np.testing.assert_allclose(gs, ws, rtol=0, atol=ATOL)


def test_predict_batch_matches_jax(pair):
    jpred, tpred = pair
    imgs = _frames(2, seed=1)
    hs = np.float32([SIZE, SIZE * 0.75])
    chws = np.float32([[SIZE, SIZE], [SIZE * 0.75, SIZE]])
    want = np.asarray(jpred._device_fn_batch(2, SIZE, SIZE)(
        jpred.variables, jnp.asarray(imgs), jnp.asarray(hs), jnp.asarray(chws)))
    got, _, _ = tpred._run(imgs, hs, chws)
    P = tpred.config.infer.max_peaks
    n_peaks = sum(_assert_tables_match(got.numpy()[b], want[b], P)
                  for b in range(2))
    assert n_peaks > 0, "the comparison saw no peaks"
    _assert_people_match(
        tpred.predict_batch(imgs, img_hs=hs, content_hws=chws, use_cpp=True),
        jpred.predict_batch(imgs, img_hs=hs, content_hws=chws, use_cpp=True))


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_postprocess_on_gt_maps_matches_jax(pair, fused):
    jpred, tpred = pair
    jpred = jpredict.Predictor(jpred.model, jpred.variables, jpred.config,
                               fused_peaks=fused)
    tpred = tpredict.Predictor(tpred.model, tpred.config, device=CPU,
                               fused_peaks=fused)
    ds = SyntheticDataset(CanonicalConfig(), length=2, image_size=256, seed=5)
    maps = np.stack([ds[i][2] for i in range(2)]).astype(np.float32)
    hs = np.float32([256, 230])
    chws = np.float32([[256, 256], [230, 200]])
    got, _, _ = tpred._postprocess(torch.from_numpy(maps), torch.from_numpy(hs),
                                   torch.from_numpy(chws))
    post = jax.jit(jpred._postprocess)
    P = tpred.config.infer.max_peaks
    for b in range(2):
        want, _, _ = post(jnp.asarray(maps[b]), jnp.float32(hs[b]),
                          jnp.asarray(chws[b]))
        assert _assert_tables_match(got.numpy()[b], np.asarray(want), P) > 0
        gp, gc = tpredict.unpack_results(got.numpy()[b], P)
        wp, wc = jpredict.unpack_results(np.asarray(want), P)
        g_table, g_cands = tpred._group(gp, gc, use_cpp=True)
        w_table, w_cands = jpred._group(wp, wc, use_cpp=True)
        assert len(g_table) == len(w_table) > 0
        np.testing.assert_allclose(g_table, w_table, rtol=0, atol=ATOL)


def test_pipelined_server_drives_port(pair):
    """The port's PipelinedServer over the port's Predictor gives what the
    port's own predict_batch gives for each letterboxed frame."""
    _, tpred = pair
    frames = _frames(5, seed=2)
    imgs = [frames[0], frames[1][:, :96], frames[2][:100],   # no resize needed
            frames[3][:64, :80], frames[4]]                  # upscaled by cv2
    serve = PipelinedServer(tpred, batch_size=2, depth=2, flush_ms=20.0,
                            use_cpp=True)
    try:
        served = [f.result(timeout=300) for f in [serve.submit(im) for im in imgs]]
    finally:
        serve.close()
    for img, (kps, scores) in zip(imgs, served):
        boxed, scale = tpred.letterbox(img)
        h, w = img.shape[:2]
        (want_k, want_s), = tpred.predict_batch(
            boxed[None], img_hs=np.float32([h * scale]),
            content_hws=np.float32([[h * scale, w * scale]]), use_cpp=True)
        want_k = np.array(want_k, copy=True)
        want_k[:, :, :2] /= scale
        assert kps.shape == want_k.shape
        np.testing.assert_allclose(kps, want_k, rtol=0, atol=ATOL)
        np.testing.assert_allclose(scores, want_s, rtol=0, atol=ATOL)


@pytest.mark.parametrize("refine,suppress", [
    ("centroid", True), ("none", True), ("bicubic8", True), ("bicubic", False)])
def test_postprocess_options_match_jax(pair, refine, suppress):
    """Predictor(refine=..., suppress_pad_peaks=...) on GT scene maps."""
    jpred, tpred = pair
    jpred = jpredict.Predictor(jpred.model, jpred.variables, jpred.config,
                               refine=refine, suppress_pad_peaks=suppress)
    tpred = tpredict.Predictor(tpred.model, tpred.config, device=CPU,
                               refine=refine, suppress_pad_peaks=suppress)
    ds = SyntheticDataset(CanonicalConfig(), length=2, image_size=256, seed=6)
    maps = np.stack([ds[i][2] for i in range(2)]).astype(np.float32)
    hs = np.float32([256, 230])
    chws = np.float32([[256, 256], [230, 200]])
    got, _, _ = tpred._postprocess(torch.from_numpy(maps), torch.from_numpy(hs),
                                   torch.from_numpy(chws))
    post = jax.jit(jpred._postprocess)
    P = tpred.config.infer.max_peaks
    for b in range(2):
        want, _, _ = post(jnp.asarray(maps[b]), jnp.float32(hs[b]),
                          jnp.asarray(chws[b]))
        assert _assert_tables_match(got.numpy()[b], np.asarray(want), P) > 0


TTA_SCALES = (0.5, 1.0, 1.5)
TTA_ANGLES = (0.0, 15.0)


def test_predict_maps_tta_matches_jax(pair):
    """The single-image TTA program: averaged maps and the packed buffer,
    on a frame that needs bucket padding (100 x 128)."""
    jpred, tpred = pair
    img = _frames(1, seed=3)[0][:100]
    want_packed, want_paf, want_heat, want_hw = jpred.predict_maps_tta(
        img, TTA_SCALES, TTA_ANGLES)
    got_packed, got_paf, got_heat, got_hw = tpred.predict_maps_tta(
        img, TTA_SCALES, TTA_ANGLES)
    assert got_hw == want_hw == (100, SIZE)
    assert got_paf.shape == want_paf.shape == (SIZE // 4, SIZE // 4, 30)
    np.testing.assert_allclose(got_paf.numpy(), np.asarray(want_paf),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(got_heat.numpy(), np.asarray(want_heat),
                               rtol=0, atol=ATOL)
    _assert_tables_match(got_packed.numpy(), np.asarray(want_packed),
                         tpred.config.infer.max_peaks)
    kw = dict(scales=TTA_SCALES, angles=TTA_ANGLES, use_cpp=True)
    gk, gs, _ = tpred.predict_skeletons(img, **kw)
    wk, ws, _ = jpred.predict_skeletons(img, **kw)
    _assert_people_match([(gk, gs)], [(wk, ws)])


def test_predict_batch_tta_matches_jax(pair):
    jpred, tpred = pair
    imgs = _frames(2, seed=4)
    hs = np.float32([SIZE, SIZE * 0.75])
    chws = np.float32([[SIZE, SIZE], [SIZE * 0.75, SIZE]])
    want = np.asarray(jpred._device_fn_batch_tta(
        2, SIZE, SIZE, TTA_SCALES, TTA_ANGLES)(
        jpred.variables, jnp.asarray(imgs), jnp.asarray(hs), jnp.asarray(chws)))
    got, _, _ = tpred._run(imgs, hs, chws, TTA_SCALES, TTA_ANGLES)
    P = tpred.config.infer.max_peaks
    n_peaks = sum(_assert_tables_match(got.numpy()[b], want[b], P)
                  for b in range(2))
    assert n_peaks > 0, "the comparison saw no peaks"
    kw = dict(img_hs=hs, content_hws=chws, use_cpp=True, scales=TTA_SCALES,
              angles=TTA_ANGLES)
    _assert_people_match(tpred.predict_batch(imgs, **kw),
                         jpred.predict_batch(imgs, **kw))


def test_predict_avg_maps_matches_jax(pair):
    jpred, tpred = pair
    img = _frames(1, seed=5)[0][:90, :110]            # padded to 128 x 128
    got, got_hw = tpred.predict_avg_maps(img)
    want, want_hw = jpred.predict_avg_maps(img)
    assert got_hw == want_hw == (90, 110)
    assert got.shape == want.shape == (SIZE // 4, SIZE // 4, 50)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_center_pad_and_gaussian_blur_match_jax():
    img = np.random.RandomState(0).randint(0, 255, (50, 70, 3), np.uint8)
    got = tpredict.center_pad_to_bucket(img, bucket=64, pad_value=128)
    want = jpredict.center_pad_to_bucket(img, bucket=64, pad_value=128)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:] and got[1] == [7, 29, 7, 29]
    maps = np.random.RandomState(1).rand(2, 3, 20, 24).astype(np.float32)
    for ks, sigma in ((5, 1.0), (7, 2.0)):
        np.testing.assert_allclose(
            tpredict.gaussian_blur(torch.from_numpy(maps), ks, sigma).numpy(),
            np.asarray(jpredict.gaussian_blur(jnp.asarray(maps), ks, sigma)),
            rtol=0, atol=1e-6)


def test_pipelined_server_tta_drives_port(pair):
    """PipelinedServer(scales=..., angles=...) over the port gives what the
    port's own TTA predict_batch gives for each letterboxed frame."""
    _, tpred = pair
    frames = _frames(3, seed=7)
    imgs = [frames[0], frames[1][:, :96], frames[2][:100]]
    serve = PipelinedServer(tpred, batch_size=2, depth=2, flush_ms=20.0,
                            use_cpp=True, scales=TTA_SCALES, angles=TTA_ANGLES)
    try:
        served = [f.result(timeout=300) for f in [serve.submit(im) for im in imgs]]
    finally:
        serve.close()
    for img, (kps, scores) in zip(imgs, served):
        boxed, scale = tpred.letterbox(img)
        h, w = img.shape[:2]
        (want_k, want_s), = tpred.predict_batch(
            boxed[None], img_hs=np.float32([h * scale]),
            content_hws=np.float32([[h * scale, w * scale]]), use_cpp=True,
            scales=TTA_SCALES, angles=TTA_ANGLES)
        assert kps.shape == want_k.shape
        np.testing.assert_allclose(kps, want_k, rtol=0, atol=ATOL)
        np.testing.assert_allclose(scores, want_s, rtol=0, atol=ATOL)


def test_unported_serving_options_raise(pair):
    """Mesh-sharded serving is ported (tests/test_torch_mesh.py); a mesh
    that is not a ``parallel/mesh.Mesh`` is refused."""
    _, tpred = pair
    imgs = np.zeros((1, SIZE, SIZE, 3), np.uint8)
    for kw in (dict(mesh=object()), dict(mesh=object(), scales=(0.5, 1.0)),
               dict(mesh=object(), angles=(0.0, 10.0))):
        with pytest.raises(TypeError):
            tpred.predict_batch(imgs, **kw)
