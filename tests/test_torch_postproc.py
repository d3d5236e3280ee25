"""The port's batched post-processing (find_peaks, score_connections,
select_connections, pack/unpack) against the JAX functions, on GT-rendered
scene maps from data.synthetic (random weights would give no peaks).

Exact: valid masks, n_raw, peak cells, connection slots. Floats (refined
coordinates, scores, limb lengths): 1e-4 absolute, fp32 on both sides; the
two frameworks sum the cubic taps and basis products in other orders.
The JAX fused path runs the Pallas kernel in interpret mode, as the JAX
package's own tests do on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from improved_body_parts_tpu.configs import (
    CanonicalConfig, NUM_PARTS, PAF_LAYERS,
)
from improved_body_parts_tpu.data.synthetic import SyntheticDataset
from improved_body_parts_tpu.infer import predict as jpredict
from improved_body_parts_tpu.ops import limbs as jlimbs
from improved_body_parts_tpu.ops import peaks as jpeaks
from improved_body_parts_tpu_torch.infer import predict as tpredict
from improved_body_parts_tpu_torch.ops import limbs as tlimbs
from improved_body_parts_tpu_torch.ops import peaks as tpeaks
from tests.test_torch_predict import single_torch_thread  # noqa: F401  (autouse)

ATOL = 1e-4
ICFG = CanonicalConfig().infer


@pytest.fixture(scope="module", params=[128, 256])
def scenes(request):
    """(2, s/4, s/4, 50) GT maps of two multi-person scenes, their image
    heights and content extents that cut into both axes."""
    size = request.param
    ds = SyntheticDataset(CanonicalConfig(), length=4, image_size=size, seed=3)
    maps = np.stack([ds[i][2] for i in range(2)]).astype(np.float32)
    content = np.float32([[size * 0.8, size], [size, size * 0.7]])
    return maps, np.float32([size, size * 0.9]), content


def _jax_peaks(maps, content, fused, **kw):
    out = []
    for b in range(maps.shape[0]):
        pk = jpeaks.find_peaks(
            jnp.asarray(maps[b, ..., PAF_LAYERS:PAF_LAYERS + NUM_PARTS]),
            thre=ICFG.thre1, max_peaks=ICFG.max_peaks, stride=4, fused=fused,
            content_hw=None if content is None else jnp.asarray(content[b]),
            **kw)
        out.append([np.asarray(a) for a in pk])
    return [np.stack(f) for f in zip(*out)]   # xy, score, valid, grid_yx, n_raw


def _port_peaks(maps, content, fused, **kw):
    pk = tpeaks.find_peaks(
        torch.from_numpy(maps[..., PAF_LAYERS:PAF_LAYERS + NUM_PARTS]),
        thre=ICFG.thre1, max_peaks=ICFG.max_peaks, stride=4, fused=fused,
        content_hw=None if content is None else torch.from_numpy(content),
        **kw)
    return [a.numpy() for a in pk]


def _assert_peaks_match(got, want):
    xy, score, valid, grid_yx, n_raw = got
    assert valid.shape == (2, NUM_PARTS, ICFG.max_peaks) and valid.any()
    np.testing.assert_array_equal(valid, want[2])
    np.testing.assert_array_equal(n_raw, want[4])
    np.testing.assert_array_equal(grid_yx, want[3])
    np.testing.assert_allclose(score, want[1], rtol=0, atol=ATOL)
    np.testing.assert_allclose(xy[valid], want[0][valid], rtol=0, atol=ATOL)


@pytest.mark.parametrize("use_content", [False, True], ids=["full", "content"])
@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_find_peaks_matches_jax(scenes, fused, use_content):
    maps, _, content = scenes
    content = content if use_content else None
    want = _jax_peaks(maps, content, fused)
    got = _port_peaks(maps, content, fused)
    xy, score, valid, grid_yx, n_raw = got
    assert valid.shape == (2, NUM_PARTS, ICFG.max_peaks) and valid.any()
    np.testing.assert_array_equal(valid, want[2])
    np.testing.assert_array_equal(n_raw, want[4])
    np.testing.assert_array_equal(grid_yx, want[3])
    np.testing.assert_allclose(score, want[1], rtol=0, atol=ATOL)
    np.testing.assert_allclose(xy[valid], want[0][valid], rtol=0, atol=ATOL)


@pytest.fixture(scope="module")
def scenes128():
    ds = SyntheticDataset(CanonicalConfig(), length=2, image_size=128, seed=4)
    maps = np.stack([ds[i][2] for i in range(2)]).astype(np.float32)
    return maps, np.float32([[128 * 0.8, 128], [128, 128 * 0.7]])


@pytest.mark.parametrize("use_content", [False, True], ids=["full", "content"])
@pytest.mark.parametrize("footprint", ["plus", "square"])
@pytest.mark.parametrize("refine", ["bicubic", "centroid", "none", "bicubic8"])
def test_find_peaks_refinements_match_jax(scenes128, refine, footprint,
                                          use_content):
    maps, content = scenes128
    content = content if use_content else None
    kw = dict(footprint=footprint)
    if refine == "bicubic8":
        kw.update(refine="bicubic", refine_upsample=8)
    else:
        kw.update(refine=refine)
    _assert_peaks_match(_port_peaks(maps, content, False, **kw),
                        _jax_peaks(maps, content, False, **kw))


@pytest.mark.parametrize("refine", ["centroid", "bicubic8"])
def test_find_peaks_fused_options_match_jax(scenes128, refine):
    """fused=True with a refinement the fused kernel does not serve takes
    the unfused path (centroid), and bicubicN rides the fused patches."""
    maps, content = scenes128
    kw = (dict(refine="centroid") if refine == "centroid"
          else dict(refine="bicubic", refine_upsample=8))
    _assert_peaks_match(_port_peaks(maps, content, True, **kw),
                        _jax_peaks(maps, content, True, **kw))


def test_default_footprint_and_cubic_a():
    """The default footprint follows the refinement (plus for bicubic,
    square otherwise), and ``cubic_a`` reaches the refinement basis."""
    maps = np.zeros((1, 16, 16, NUM_PARTS), np.float32)
    maps[0, 5, 5, 0] = maps[0, 5, 6, 0] = 0.8            # a plateau pair
    maps[0, 6, 6, 0] = 0.8                               # diagonal neighbour
    maps[0, 7, 7, 0] = 0.7            # a peak for "plus", not for "square"
    maps[0, 9, 3, 1], maps[0, 9, 4, 1], maps[0, 10, 3, 1] = 0.9, 0.5, 0.3
    heat = torch.from_numpy(maps)
    for refine, fp in (("bicubic", "plus"), ("centroid", "square"),
                       ("none", "square")):
        a = tpeaks.find_peaks(heat, refine=refine)
        b = tpeaks.find_peaks(heat, refine=refine, footprint=fp)
        for x, y in zip(a, b):
            assert torch.equal(x, y)
        j = jpeaks.find_peaks(jnp.asarray(maps[0]), refine=refine)
        np.testing.assert_array_equal(a.valid[0].numpy(), np.asarray(j.valid))
    assert int(tpeaks.find_peaks(heat, footprint="plus").n_raw[0, 0]) == 4
    assert int(tpeaks.find_peaks(heat, footprint="square").n_raw[0, 0]) == 3
    k = tpeaks.find_peaks(heat, cubic_a=-0.5)
    jk = jpeaks.find_peaks(jnp.asarray(maps[0]), cubic_a=-0.5)
    v = k.valid[0].numpy()
    np.testing.assert_allclose(k.score[0].numpy()[v], np.asarray(jk.score)[v],
                               rtol=0, atol=ATOL)
    assert not torch.equal(k.score, tpeaks.find_peaks(heat).score)


@pytest.mark.parametrize("use_content", [False, True], ids=["full", "content"])
def test_connections_match_jax(scenes, use_content):
    """Both sides score the SAME peak table (JAX's), so this isolates the
    limb sampler and the greedy selection."""
    _check_connections(scenes, use_content, "reference")


@pytest.mark.parametrize("use_content", [False, True], ids=["full", "content"])
def test_bilinear_connections_match_jax(scenes, use_content):
    _check_connections(scenes, use_content, "bilinear")


def _check_connections(scenes, use_content, sampling):
    maps, img_h, content = scenes
    xy, score, valid, _, _ = _jax_peaks(maps, content if use_content else None,
                                        fused=False)
    kw = dict(mid_num=ICFG.mid_num, stride=4, thre2=ICFG.thre2,
              connect_ration=ICFG.connect_ration, sampling=sampling)
    got_c = tlimbs.score_connections(
        torch.from_numpy(maps[..., :PAF_LAYERS]), torch.from_numpy(xy),
        torch.from_numpy(score), torch.from_numpy(valid),
        torch.from_numpy(img_h), **kw)
    got = tlimbs.select_connections(got_c, torch.from_numpy(valid))
    for b in range(2):
        cand = jlimbs.score_connections(
            jnp.asarray(maps[b, ..., :PAF_LAYERS]), jnp.asarray(xy[b]),
            jnp.asarray(score[b]), jnp.asarray(valid[b]), jnp.float32(img_h[b]),
            **kw)
        want = jlimbs.select_connections(cand, jnp.asarray(valid[b]))
        cvalid = np.asarray(cand.valid)
        np.testing.assert_array_equal(got_c.valid[b].numpy(), cvalid)
        np.testing.assert_allclose(got_c.conn_score[b].numpy()[cvalid],
                                   np.asarray(cand.conn_score)[cvalid],
                                   rtol=0, atol=ATOL)
        assert np.asarray(want.valid).any()
        for name in ("src_slot", "dst_slot", "valid"):
            np.testing.assert_array_equal(getattr(got, name)[b].numpy(),
                                          np.asarray(getattr(want, name)),
                                          err_msg=name)
        for name in ("score", "limb_len"):
            np.testing.assert_allclose(getattr(got, name)[b].numpy(),
                                       np.asarray(getattr(want, name)),
                                       rtol=0, atol=ATOL, err_msg=name)


def test_postproc_matches_reference_golden():
    """The port's post-processing on the reference goldens of
    tests/golden/postproc_golden.npz, read as tests/test_reference_parity.py
    reads them for the JAX package: the same peaks, connections and
    people on all scenes."""
    import json
    import os

    from improved_body_parts_tpu.ops import group
    from tests.reference_parity_common import blob_scene, person_signatures
    from tests.test_reference_parity import ICFG as RCFG
    from tests.test_reference_parity import conns_rows, peaks_rows

    d = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "golden", "postproc_golden.npz"))
    n_scenes = int(d["n_scenes"])
    assert n_scenes == 6
    for si in range(n_scenes):
        heat, paf, img_h = blob_scene(si)
        pk = tpeaks.find_peaks(torch.from_numpy(heat)[None], thre=RCFG.thre1,
                               max_peaks=32, stride=4, refine="bicubic")
        cand = tlimbs.score_connections(
            torch.from_numpy(paf)[None], pk.xy, pk.score, pk.valid,
            torch.tensor([img_h]), mid_num=RCFG.mid_num, stride=4,
            thre2=RCFG.thre2, connect_ration=RCFG.connect_ration)
        conns = tlimbs.select_connections(cand, pk.valid)
        pk1 = tpeaks.PeakTable(*(t[0] for t in pk))
        connected = tlimbs.connections_to_numpy(
            tlimbs.Connections(*(t[0] for t in conns)), pk1)
        cands = group.build_joint_candidates(
            pk1.xy.numpy(), pk1.score.numpy(), pk1.valid.numpy())
        table, _ = group.find_humans(connected, cands, RCFG)

        want_peaks = sorted(
            (int(r[0]), round(float(r[1]), 3), round(float(r[2]), 3),
             round(float(r[3]), 4)) for r in d[f"s{si}_peaks"])
        assert peaks_rows(pk1) == want_peaks, f"scene {si}: peak mismatch"
        want_conns = sorted(
            (int(r[0]), round(float(r[1]), 3), round(float(r[2]), 3),
             round(float(r[3]), 3), round(float(r[4]), 3),
             round(float(r[5]), 4), round(float(r[6]), 3))
            for r in d[f"s{si}_conns"])
        assert conns_rows(connected, pk1) == want_conns, \
            f"scene {si}: connection mismatch"
        want_persons = json.loads(bytes(d[f"s{si}_persons"]).decode())
        got_persons = person_signatures(table, cands)
        assert json.loads(json.dumps(got_persons)) == want_persons, \
            f"scene {si}: person mismatch"


def test_pack_unpack_round_trip(scenes):
    maps, img_h, content = scenes
    pk = tpeaks.find_peaks(
        torch.from_numpy(maps[..., PAF_LAYERS:PAF_LAYERS + NUM_PARTS]),
        content_hw=torch.from_numpy(content))
    cand = tlimbs.score_connections(torch.from_numpy(maps[..., :PAF_LAYERS]),
                                    pk.xy, pk.score, pk.valid,
                                    torch.from_numpy(img_h))
    conns = tlimbs.select_connections(cand, pk.valid)
    packed = tpredict.pack_results(pk, conns).numpy()
    P = ICFG.max_peaks
    assert packed.shape == (2, tpredict.packed_size(P))
    assert tpredict.packed_size(P) == jpredict.packed_size(P)
    for b in range(2):
        peaks_np, conns_np = tpredict.unpack_results(packed[b], P)
        np.testing.assert_array_equal(peaks_np.xy, pk.xy[b].numpy())
        np.testing.assert_array_equal(peaks_np.valid, pk.valid[b].numpy())
        np.testing.assert_array_equal(peaks_np.n_raw, pk.n_raw[b].numpy())
        for name in tlimbs.Connections._fields:
            np.testing.assert_array_equal(getattr(conns_np, name),
                                          getattr(conns, name)[b].numpy())
        # the JAX unpacker reads the port's buffer identically
        j_peaks, j_conns = jpredict.unpack_results(packed[b], P)
        np.testing.assert_array_equal(j_peaks.score, peaks_np.score)
        np.testing.assert_array_equal(j_conns.src_slot, conns_np.src_slot)


def test_unported_options_raise():
    """Post-processing, the model variants and int8 are ported; what still
    raises is quantizing the legacy-block family (refused in JAX too)."""
    import dataclasses

    from improved_body_parts_tpu_torch.configs import ModelConfig
    from improved_body_parts_tpu_torch.models.imhn import PoseNet, create_model
    tiny = ModelConfig(nstack=1, inp_dim=16, increase=8, se_reduction=4)
    for kw in (dict(extra_attention=True), dict(cross_stack=False)):
        assert type(create_model(dataclasses.replace(tiny, **kw), device="meta",
                                 quant="int8")) is PoseNet
    with pytest.raises(ValueError):
        create_model(dataclasses.replace(tiny, legacy_blocks=True), device="meta",
                     quant="int8")
