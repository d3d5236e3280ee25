"""The port's two CUDA kernels: their plain PyTorch versions against the TPU
kernels (Pallas in interpret mode, as tests/test_pallas_kernels.py runs
them), and the CUDA kernels against the plain versions on the card.

Every comparison is exact: both kernels are pure compares and copies. This
module imports no jax at the top, so on the machine with the card (which
has no jax) the CUDA cases run with
``python -m pytest tests/test_torch_kernels.py --noconftest -k cuda``.
"""

import numpy as np
import pytest
import torch

from improved_body_parts_tpu_torch.ops import kernels

FOOTPRINTS = ("plus", "square")


@pytest.fixture(scope="module")
def pallas():
    pytest.importorskip("jax")
    from improved_body_parts_tpu.ops import pallas_kernels
    return pallas_kernels


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _pallas_nms(pallas, heat, footprint):
    import jax.numpy as jnp
    return np.asarray(pallas.nms_pallas(jnp.asarray(heat), 0.1,
                                        footprint=footprint, interpret=True))


def _pallas_fused(pallas, heat, footprint, max_peaks):
    import jax.numpy as jnp
    out = pallas.fused_peaks_pallas(jnp.asarray(heat), 0.1,
                                    max_peaks=max_peaks, footprint=footprint,
                                    interpret=True)
    return [np.asarray(a) for a in out]


def _structured():
    heat = np.zeros((1, 16, 16), np.float32)
    heat[0, 4, 4] = 0.9
    heat[0, 4, 5] = 0.5     # suppressed neighbour
    heat[0, 0, 0] = 0.3     # border peak survives
    heat[0, 10, 10] = 0.05  # below threshold
    return heat


def _plateau():
    heat = np.zeros((1, 8, 8), np.float32)
    heat[0, 3, 3] = heat[0, 3, 4] = 0.7     # equal adjacent maxima
    return heat


@pytest.mark.parametrize("footprint", FOOTPRINTS)
@pytest.mark.parametrize("seed", range(3))
def test_nms_plain_matches_pallas_random(pallas, seed, footprint):
    heat = np.random.RandomState(seed).rand(6, 32, 32).astype(np.float32) * 0.5
    got = kernels.nms_plain(torch.from_numpy(heat), 0.1, footprint).numpy()
    np.testing.assert_array_equal(got, _pallas_nms(pallas, heat, footprint))


@pytest.mark.parametrize("footprint", FOOTPRINTS)
@pytest.mark.parametrize("case", ["structured", "plateau"])
def test_nms_plain_matches_pallas_cases(pallas, case, footprint):
    heat = _structured() if case == "structured" else _plateau()
    got = kernels.nms_plain(torch.from_numpy(heat), 0.1, footprint).numpy()
    np.testing.assert_array_equal(got, _pallas_nms(pallas, heat, footprint))
    if case == "structured":
        assert got[0, 4, 4] == np.float32(0.9) and got[0, 4, 5] == 0.0
        assert got[0, 0, 0] == np.float32(0.3) and got[0, 10, 10] == 0.0
    else:
        assert got[0, 3, 3] == got[0, 3, 4] == np.float32(0.7)


def _fused_case(case: str) -> np.ndarray:
    """(K, 24, 20) maps. random: noise with a few strong peaks; borders:
    peaks on all four borders and corners; saturated: isolated maxima on a
    checkerboard (n_raw >> P), exact score ties, a map with fewer peaks than
    P, and an empty map."""
    rng = np.random.RandomState({"random": 0, "borders": 1, "saturated": 2}[case])
    h, w = 24, 20
    if case == "random":
        heat = rng.rand(6, h, w).astype(np.float32) * 0.6
        for y, x, c in [(0, 0, 0), (23, 19, 1), (5, 7, 2), (12, 3, 2), (1, 18, 4)]:
            heat[c, y, x] = 0.9 + 0.01 * c
        return heat
    heat = np.zeros((4, h, w), np.float32)
    if case == "borders":
        for c in range(4):
            for y, x in [(0, 0), (0, w - 1), (h - 1, 0), (h - 1, w - 1),
                         (0, 7), (h - 1, 11), (9, 0), (15, w - 1), (1, 1)]:
                heat[c, y, x] = rng.uniform(0.2, 1.0)
        return heat
    yy, xx = np.mgrid[0:h, 0:w]
    heat[0] = np.where((yy + xx) % 2 == 0, rng.uniform(0.3, 1.0, (h, w)), 0.05)
    heat[1] = np.where((yy % 3 == 0) & (xx % 3 == 0), 0.5, 0.0)     # all tied
    heat[2, 5, 5], heat[2, 17, 9] = 0.8, 0.8                        # 2 peaks
    return heat.astype(np.float32)


@pytest.mark.parametrize("footprint", FOOTPRINTS)
@pytest.mark.parametrize("case", ["random", "borders", "saturated"])
def test_fused_peaks_plain_matches_pallas(pallas, case, footprint):
    """All four outputs exactly, invalid slots included."""
    heat = _fused_case(case)
    P = 8
    want = _pallas_fused(pallas, heat, footprint, P)
    got = [a.numpy() for a in kernels.fused_peaks_plain(
        torch.from_numpy(heat), 0.1, P, footprint)]
    for name, g, wnt in zip(("scores", "yx", "n_raw", "patches"), got, want):
        assert g.dtype == wnt.dtype, name
        np.testing.assert_array_equal(g, wnt, err_msg=name)
    if case == "saturated":
        assert (got[2][:2] > P).all()                # n_raw beyond the cut
        assert (got[0][2, 2:] == 0).all() and (got[0][3] == 0).all()


# ---------------------------------------------------------------------------
# the one-pass selection rule of csrc/fused_peaks.cu
# ---------------------------------------------------------------------------

THRES = (0.1, 0.0, -0.2)
PEAK_COUNTS = (1, 8, 33)


def _edge_maps(k: int, h: int, w: int, seed: int) -> np.ndarray:
    """(k, h, w): channel c is case c % 8 of: noise; a checkerboard of
    isolated maxima (n_raw >> P); noise with -0 and +0 ties; all zeros; a
    constant negative plateau above -0.2 (every cell kept, all negative,
    when thre < -0.1); a constant plateau below -0.2 (nothing kept);
    signed noise; a constant positive plateau (every cell kept)."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    heat = np.zeros((k, h, w), np.float32)
    for c in range(k):
        case = c % 8
        noise = rng.rand(h, w).astype(np.float32)
        if case == 0:
            heat[c] = noise * 0.6
        elif case == 1:
            heat[c] = np.where((yy + xx) % 2 == 0, noise * 0.5 + 0.5, 0.0)
        elif case == 2:
            heat[c] = np.where(noise < 0.3, np.float32(-0.0),
                               np.where(noise < 0.5, np.float32(0.0), noise))
        elif case == 4:
            heat[c] = -0.1
        elif case == 5:
            heat[c] = -0.5
        elif case == 6:
            heat[c] = noise - 0.5
        elif case == 7:
            heat[c] = 0.25
    return heat


def _one_pass_rule(heat: np.ndarray, thre: float, max_peaks: int,
                   footprint: str, win: int):
    """numpy model of the rule the CUDA kernel applies after one pass:
    the kept cells with value > 0 in (value desc, index asc) order; if
    fewer than P, every further slot is Z = the lowest index whose NMS value
    is 0 once those picks are zeroed, with score 0; if there is no such
    cell (every cell kept and negative), the best negative cell with its
    value, then that cell with score 0. Patches from the input map, zeros
    outside it."""
    k, h, w = heat.shape
    padded = np.pad(heat, ((0, 0), (1, 1), (1, 1)), constant_values=-np.inf)
    offsets = ((0, 1), (2, 1), (1, 0), (1, 2)) if footprint == "plus" else \
        tuple((dy, dx) for dy in range(3) for dx in range(3) if (dy, dx) != (1, 1))
    hmax = heat.copy()
    for dy, dx in offsets:
        hmax = np.maximum(hmax, padded[:, dy:dy + h, dx:dx + w])
    above = heat > thre if footprint == "plus" else heat >= thre
    keep = (heat >= hmax) & above
    size = 2 * win + 1
    scores = np.zeros((k, max_peaks), np.float32)
    idx = np.zeros((k, max_peaks), np.int64)
    for c in range(k):
        v, kept = heat[c].ravel(), keep[c].ravel()
        pos = np.flatnonzero(kept & (v > 0))
        picks = pos[np.lexsort((pos, -v[pos]))][:max_peaks]
        n = len(picks)
        idx[c, :n], scores[c, :n] = picks, v[picks]
        if n == max_peaks:
            continue
        zeros = np.flatnonzero(~kept | (v == 0))
        if zeros.size or n:
            idx[c, n:] = min(list(zeros[:1]) + list(picks))
        else:
            neg = np.flatnonzero(kept & (v < 0))
            best = neg[np.lexsort((neg, -v[neg]))][0]
            idx[c, n:] = best
            scores[c, n] = v[best]
    cy, cx = idx // w, idx % w
    pad = np.pad(heat, ((0, 0), (win, win), (win, win)))
    taps = np.arange(size)
    patches = pad[np.arange(k)[:, None, None, None],
                  cy[:, :, None, None] + taps[:, None],
                  cx[:, :, None, None] + taps[None, :]]
    yx = np.stack([cy, cx], -1).astype(np.int32)
    return scores, yx, keep.reshape(k, -1).sum(1).astype(np.int32), patches


def _assert_outputs_equal(got, want):
    for name, g, wnt in zip(("scores", "yx", "n_raw", "patches"), got, want):
        assert g.shape == wnt.shape and g.dtype == wnt.dtype, name
        np.testing.assert_array_equal(g, wnt, err_msg=name)


@pytest.mark.parametrize("win", (1, 2))
@pytest.mark.parametrize("footprint", FOOTPRINTS)
@pytest.mark.parametrize("max_peaks", PEAK_COUNTS)
@pytest.mark.parametrize("thre", THRES)
def test_one_pass_rule_matches_plain(thre, max_peaks, footprint, win):
    """The rule equals P rounds of arg-max, invalid slots included."""
    heat = _edge_maps(16, 12, 10, seed=max_peaks)
    want = [a.numpy() for a in kernels.fused_peaks_plain(
        torch.from_numpy(heat), thre, max_peaks, footprint, win)]
    _assert_outputs_equal(_one_pass_rule(heat, thre, max_peaks, footprint, win),
                          want)
    if thre < -0.1:      # the all-negative plateau took the negative branch
        assert want[0][4, 0] == np.float32(-0.1) and want[2][4] == 120
        assert (want[0][4, 1:] == 0).all() and (want[1][4] == want[1][4, 0]).all()
    if footprint == "plus":                # the checkerboard saturates
        assert want[2][1] > max_peaks


@pytest.mark.parametrize("footprint,win", (("plus", 2), ("square", 1)))
@pytest.mark.parametrize("max_peaks", PEAK_COUNTS)
@pytest.mark.parametrize("thre", THRES)
def test_one_pass_rule_matches_pallas(pallas, thre, max_peaks, footprint, win):
    import jax.numpy as jnp
    heat = _edge_maps(8, 12, 10, seed=max_peaks)
    want = [np.asarray(a) for a in pallas.fused_peaks_pallas(
        jnp.asarray(heat), thre, max_peaks=max_peaks, footprint=footprint,
        win=win, interpret=True)]
    _assert_outputs_equal(_one_pass_rule(heat, thre, max_peaks, footprint, win),
                          want)


def test_wrappers_take_plain_version_on_cpu():
    heat = torch.from_numpy(_fused_case("random"))
    before = (kernels.nms.launches, kernels.fused_peaks.launches)
    assert torch.equal(kernels.nms(heat), kernels.nms_plain(heat))
    for a, b in zip(kernels.fused_peaks(heat, max_peaks=8),
                    kernels.fused_peaks_plain(heat, max_peaks=8)):
        assert torch.equal(a, b)
    assert (kernels.nms.launches, kernels.fused_peaks.launches) == before
    with pytest.raises(ValueError):          # neither CPU nor CUDA: no fallback
        kernels.nms(torch.zeros((1, 4, 4), device="meta"))


def _main_path_maps(device) -> torch.Tensor:
    """(144, 128, 128): B=8 x 18 joint maps, one saturated channel."""
    g = torch.Generator().manual_seed(0)
    heat = torch.rand((144, 128, 128), generator=g) * 0.6
    heat[3] = torch.where(
        (torch.arange(128)[:, None] + torch.arange(128)[None]) % 2 == 0,
        heat[3] + 0.5, torch.zeros(()))
    return heat.to(device)


@pytest.mark.parametrize("footprint", FOOTPRINTS)
def test_nms_cuda_matches_plain(cuda, footprint):
    heat = _main_path_maps(cuda)
    n0 = kernels.nms.launches
    got = kernels.nms(heat, 0.1, footprint)
    torch.cuda.synchronize()
    assert kernels.nms.launches == n0 + 1
    assert torch.equal(got, kernels.nms_plain(heat, 0.1, footprint))
    plateau = torch.from_numpy(_plateau()).to(cuda)
    assert torch.equal(kernels.nms(plateau, 0.1, footprint),
                       kernels.nms_plain(plateau, 0.1, footprint))


@pytest.mark.parametrize("footprint", FOOTPRINTS)
def test_fused_peaks_cuda_matches_plain(cuda, footprint):
    heat = _main_path_maps(cuda)
    n0 = kernels.fused_peaks.launches
    got = kernels.fused_peaks(heat, 0.1, 32, footprint)
    torch.cuda.synchronize()
    assert kernels.fused_peaks.launches == n0 + 1
    want = kernels.fused_peaks_plain(heat, 0.1, 32, footprint)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert got[2][3] > 32


def _large_maps(device) -> torch.Tensor:
    """(18, 272, 480): the joint maps of one 1088x1920 frame, beyond one
    block's shared memory; channel 3 saturated, channel 5 empty (every slot
    repeats cell (0, 0)), channel 7 holds -0 and +0 ties."""
    g = torch.Generator().manual_seed(1)
    heat = torch.rand((18, 272, 480), generator=g) * 0.6
    heat[3] = torch.where(
        (torch.arange(272)[:, None] + torch.arange(480)[None]) % 2 == 0,
        heat[3] + 0.5, torch.zeros(()))
    heat[5] = 0.0
    heat[7] = torch.where(heat[7] < 0.3, torch.tensor(-0.0), heat[7])
    return heat.to(device)


@pytest.mark.parametrize("footprint", FOOTPRINTS)
def test_fused_peaks_cuda_matches_plain_beyond_shared_memory(cuda, footprint):
    """A channel split over a cluster of blocks (272x480 at k=18)."""
    heat = _large_maps(cuda)
    n0 = kernels.fused_peaks.launches
    got = kernels.fused_peaks(heat, 0.1, 32, footprint)
    torch.cuda.synchronize()
    assert kernels.fused_peaks.launches == n0 + 1
    want = kernels.fused_peaks_plain(heat, 0.1, 32, footprint)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert got[2][3] > 32 and got[2][5] == 0
    assert (got[1][5] == 0).all()


@pytest.mark.parametrize("footprint,win", (("plus", 2), ("square", 1)))
@pytest.mark.parametrize("max_peaks", PEAK_COUNTS)
@pytest.mark.parametrize("thre", THRES)
@pytest.mark.parametrize("shape", ((144, 128, 128), (18, 272, 480)))
def test_fused_peaks_cuda_edge_grid(cuda, shape, thre, max_peaks, footprint, win):
    """The edge-case channels at the main-path shapes (one block a channel,
    and a channel split over a cluster), exact against the plain version."""
    heat = torch.from_numpy(_edge_maps(*shape, seed=max_peaks)).to(cuda)
    got = kernels.fused_peaks(heat, thre, max_peaks, footprint, win)
    want = kernels.fused_peaks_plain(heat, thre, max_peaks, footprint, win)
    torch.cuda.synchronize()
    for name, a, b in zip(("scores", "yx", "n_raw", "patches"), got, want):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("max_peaks", (300, 5000))
def test_fused_peaks_cuda_long_lists(cuda, max_peaks):
    """Lists beyond 48 KB of shared memory (P = 300: 10 rows a warp), and
    P above the map's cell count (fewer warps, so the lists still fit)."""
    heat = torch.from_numpy(_edge_maps(8, 64, 64, seed=3)).to(cuda)
    got = kernels.fused_peaks(heat, 0.1, max_peaks, "plus", 2)
    want = kernels.fused_peaks_plain(heat, 0.1, max_peaks, "plus", 2)
    torch.cuda.synchronize()
    for name, a, b in zip(("scores", "yx", "n_raw", "patches"), got, want):
        assert torch.equal(a, b), name
