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


def _jax_peaks(maps, content, fused):
    out = []
    for b in range(maps.shape[0]):
        pk = jpeaks.find_peaks(
            jnp.asarray(maps[b, ..., PAF_LAYERS:PAF_LAYERS + NUM_PARTS]),
            thre=ICFG.thre1, max_peaks=ICFG.max_peaks, stride=4, fused=fused,
            content_hw=None if content is None else jnp.asarray(content[b]))
        out.append([np.asarray(a) for a in pk])
    return [np.stack(f) for f in zip(*out)]   # xy, score, valid, grid_yx, n_raw


def _port_peaks(maps, content, fused):
    pk = tpeaks.find_peaks(
        torch.from_numpy(maps[..., PAF_LAYERS:PAF_LAYERS + NUM_PARTS]),
        thre=ICFG.thre1, max_peaks=ICFG.max_peaks, stride=4, fused=fused,
        content_hw=None if content is None else torch.from_numpy(content))
    return [a.numpy() for a in pk]


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


@pytest.mark.parametrize("use_content", [False, True], ids=["full", "content"])
def test_connections_match_jax(scenes, use_content):
    """Both sides score the SAME peak table (JAX's), so this isolates the
    limb sampler and the greedy selection."""
    maps, img_h, content = scenes
    xy, score, valid, _, _ = _jax_peaks(maps, content if use_content else None,
                                        fused=False)
    kw = dict(mid_num=ICFG.mid_num, stride=4, thre2=ICFG.thre2,
              connect_ration=ICFG.connect_ration)
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
    heat = torch.zeros((1, 8, 8, NUM_PARTS))
    for kw in (dict(refine="centroid"), dict(refine="none"),
               dict(refine_upsample=8)):
        with pytest.raises(NotImplementedError):
            tpeaks.find_peaks(heat, **kw)
