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
    heat = _large_maps(cuda)
    assert heat.shape[1] * heat.shape[2] * 4 > kernels.FUSED_PEAKS_SMEM_BYTES
    n0 = kernels.fused_peaks.launches
    got = kernels.fused_peaks(heat, 0.1, 32, footprint)
    torch.cuda.synchronize()
    assert kernels.fused_peaks.launches == n0 + 1
    want = kernels.fused_peaks_plain(heat, 0.1, 32, footprint)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert got[2][3] > 32 and got[2][5] == 0
    assert (got[1][5] == 0).all()

