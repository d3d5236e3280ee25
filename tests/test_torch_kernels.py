"""The port's CUDA kernels: their plain PyTorch versions against the TPU
kernels (Pallas in interpret mode, as tests/test_pallas_kernels.py runs
them), the int8 plain twins against each other, and the CUDA kernels
against the plain versions on the card (``int8_conv`` on both of its
routes, with float and int8 input and output).

Every comparison is exact: ``nms`` and ``fused_peaks`` are pure compares
and copies, ``int8_quantize`` and ``int8_conv`` round each float step as
their plain versions do. This module imports no jax at the top, so on the
machine with the card (which has no jax) the CUDA cases run with
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


def _int8_conv_case(k, stride, dilation, cin, cout, dtype, seed, size=(19, 13)):
    """Random NHWC activations with exact ties (a_scale a power of two and
    half-integer multiples of it) and outliers beyond the clip, an int8
    kernel over the full range, per-channel scales and a bias."""
    rng = np.random.RandomState(seed)
    a_scale = np.float32(2.0 ** -5)
    x = rng.randn(2, *size, cin).astype(np.float32) * 1.5
    ties = rng.rand(*x.shape) < 0.2
    x[ties] = (rng.randint(-130, 130, ties.sum()) + 0.5) * a_scale
    w = rng.randint(-127, 128, (cout, k, k, cin)).astype(np.int8)
    w_scale = (rng.rand(cout) * 1e-3 + 1e-4).astype(np.float32)
    bias = rng.randn(cout).astype(np.float32) * 0.1
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    return (t(x).to(dtype), t(w), t(bias), t(w_scale), torch.tensor(a_scale),
            dilation * (k - 1) // 2)


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("cin", (3, 50, 64))
@pytest.mark.parametrize("stride", (1, 2))
@pytest.mark.parametrize("k,dilation", ((1, 1), (3, 1), (3, 3), (3, 5), (7, 1),
                                        (7, 3), (7, 5)))
def test_int8_conv_cuda_matches_plain(cuda, k, dilation, stride, cin, dtype):
    """Every kernel size, stride and dilation of the grid, Cin not a
    multiple of 32 (3, 50) and one that is, Cout below and above one
    block's 64/128 columns: bit-identical to the plain version."""
    cout = 50 if cin != 64 else 130
    x, w, bias, w_scale, a_scale, pad = (
        t.to(cuda) if isinstance(t, torch.Tensor) else t
        for t in _int8_conv_case(k, stride, dilation, cin, cout, dtype,
                                 seed=k * 100 + cin))
    relu = (k + stride + dilation) % 2 == 0
    n0 = kernels.int8_conv.launches
    got = kernels.int8_conv(x, w, bias, w_scale, a_scale, stride, pad,
                            dilation, relu)
    torch.cuda.synchronize()
    assert kernels.int8_conv.launches == n0 + 1
    want = kernels.int8_conv_plain(x, w, bias, w_scale, a_scale, stride, pad,
                                   dilation, relu)
    assert got.shape == want.shape and got.dtype == dtype
    assert torch.equal(got, want), (got.float() - want.float()).abs().max()


@pytest.mark.parametrize("shape", ((16, 8, 8, 768, 768, 3), (2, 64, 64, 3, 64, 7),
                                   (4, 1, 1, 32, 16, 3)))
def test_int8_conv_cuda_model_edges(cuda, shape):
    """The largest K (3x3 on 768 channels at the 8x8 scale-4 map of a 512²
    batch of 16), the 7x7/s2 stem on 3 channels, and a 1x1 map."""
    n, h, w_, cin, cout, k = shape
    rng = np.random.RandomState(cin)
    x = torch.from_numpy(rng.randn(n, h, w_, cin).astype(np.float32)).to(cuda)
    # the extreme operand: every product 127 * 127, the sums near 127^2 * K
    w = torch.full((cout, k, k, cin), 127, dtype=torch.int8, device=cuda)
    args = (w, torch.zeros(cout, device=cuda), torch.full((cout,), 1e-6, device=cuda),
            torch.tensor(1e-3, device=cuda))
    stride = 2 if k == 7 else 1
    for xx in (x.bfloat16(), x.abs() + 1.0):
        got = kernels.int8_conv(xx, *args, stride, (k - 1) // 2, 1, False)
        want = kernels.int8_conv_plain(xx, *args, stride, (k - 1) // 2, 1, False)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# int8_quantize and the int8 input/output of int8_conv: plain twins on the
# CPU, the kernels on the card
# ---------------------------------------------------------------------------

QUANT_CASES = [(k, s, d, c) for k, d in ((1, 1), (3, 1), (3, 5), (7, 3))
               for s in (1, 2) for c in (3, 50, 64)]


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("k,stride,dilation,cin", QUANT_CASES[:6])
def test_int8_quantize_plain_is_the_conv_first_step(k, stride, dilation, cin, dtype):
    """``int8_quantize_plain`` is the first line of the JAX block (and of
    ``int8_conv_plain``): ties to even and the clip included."""
    x, _, _, _, a_scale, _ = _int8_conv_case(k, stride, dilation, cin, 8, dtype,
                                             seed=cin + k)
    got = kernels.int8_quantize_plain(x, a_scale)
    want = torch.clamp(torch.round(x.float() / a_scale), -127, 127)
    assert got.dtype == torch.int8 and torch.equal(got.float(), want)
    xf = x.float()
    ties = ((xf / a_scale - torch.floor(xf / a_scale)) == 0.5) & ((xf / a_scale).abs() < 127)
    assert ties.any() and (got.abs() == 127).any()
    assert torch.equal(got[ties].float(), torch.round(xf[ties] / a_scale))


@pytest.mark.parametrize("k,stride,dilation,cin", QUANT_CASES)
def test_int8_conv_plain_on_quantized_input(k, stride, dilation, cin):
    """A pre-quantized int8 input gives the float input's result, and the
    requantizing output is ``int8_quantize_plain`` of the float output."""
    cout = 24
    for dtype in (torch.float32, torch.bfloat16):
        x, w, bias, w_scale, a_scale, pad = _int8_conv_case(
            k, stride, dilation, cin, cout, dtype, seed=k * 7 + cin)
        args = (w, bias, w_scale, a_scale, stride, pad, dilation, True)
        want = kernels.int8_conv_plain(x, *args)
        xq = kernels.int8_quantize_plain(x, a_scale)
        got = kernels.int8_conv_plain(xq, *args, out_dtype=dtype)
        assert got.dtype == dtype and torch.equal(got, want)
        a_next = torch.tensor(np.float32(2.0 ** -3))
        req = kernels.int8_conv_plain(x, *args, a_next=a_next)
        assert torch.equal(req, kernels.int8_quantize_plain(want, a_next))
        assert torch.equal(kernels.int8_conv_plain(xq, *args, out_dtype=dtype,
                                                   a_next=a_next), req)
        # the CPU wrapper is the plain twin, int8 in and out included
        assert torch.equal(kernels.int8_conv(xq, *args, out_dtype=dtype,
                                             a_next=a_next), req)
    with pytest.raises(ValueError):          # an int8 input names its type
        kernels.int8_conv_plain(xq, *args)


def test_int8_conv_route_is_static():
    """The route depends on the shape alone: Cin and the stride, and for a
    float-in, float-out call the table of shapes where the mma.sync kernel was
    measured faster."""
    assert kernels.int8_conv_route(64, 1) == "wgmma"
    assert kernels.int8_conv_route(16, 1) == "wgmma"
    assert kernels.int8_conv_route(50, 1) == "mma_sync"
    assert kernels.int8_conv_route(3, 2) == "mma_sync"
    assert kernels.int8_conv_route(64, 2) == "mma_sync"
    for h, w, cin, cout, k in kernels._MMA_SYNC_FASTER:
        assert kernels.int8_conv_route(cin, 1, h, w, cout, k) == "mma_sync"
        assert kernels.int8_conv_route(cin, 1, h, w, cout, k, int8_io=True) == "wgmma"
        assert kernels.int8_conv_route(cin, 1, h, w + 1, cout, k) == "wgmma"


@pytest.mark.parametrize("shape", ((2, 19, 13, 64), (3, 5, 7, 16), (1, 1, 1, 33),
                                   (16, 8, 8, 384)))
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_int8_quantize_cuda_matches_plain(cuda, shape, dtype):
    """Element counts that are and are not multiples of a thread's 16;
    ties and clipped outliers."""
    rng = np.random.RandomState(sum(shape))
    a = np.float32(2.0 ** -5)
    x = rng.randn(*shape).astype(np.float32) * 1.5
    ties = rng.rand(*shape) < 0.2
    x[ties] = (rng.randint(-130, 130, ties.sum()) + 0.5) * a
    x = torch.from_numpy(x).to(cuda, dtype)
    a_scale = torch.tensor(a, device=cuda)
    n0 = kernels.int8_quantize.launches
    got = kernels.int8_quantize(x, a_scale)
    torch.cuda.synchronize()
    assert kernels.int8_quantize.launches == n0 + 1
    assert torch.equal(got, kernels.int8_quantize_plain(x, a_scale))


# (N, H, W, Cin, Cout, k, dilation): maps narrower than the 16-column box
# (8x8, 16x16, 1x1), H*W no multiple of the 128-pixel tile, Cout no
# multiple of 64 or 128, Cin below one 64-channel slice, dilation 3, 4 and
# 5 reaching past the map's edges, batch 1; the last two take the
# 256-column tile
WGMMA_CASES = ((16, 8, 8, 64, 64, 3, 1), (16, 16, 16, 320, 320, 3, 1),
               (2, 19, 13, 32, 50, 3, 3), (1, 23, 29, 48, 130, 3, 4),
               (2, 12, 12, 64, 200, 3, 5), (3, 5, 7, 16, 24, 1, 1),
               (1, 1, 1, 64, 16, 3, 1), (4, 33, 17, 192, 136, 1, 1),
               (2, 16, 16, 256, 50, 1, 1), (16, 64, 64, 128, 256, 3, 1),
               (4, 96, 90, 128, 512, 3, 1))
IO_MODES = ("float", "int8 in", "int8 out", "int8 in and out")


@pytest.mark.parametrize("io", IO_MODES)
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("case", WGMMA_CASES)
def test_int8_conv_cuda_wgmma_route(cuda, case, dtype, io):
    """The TMA + wgmma route against the plain twin, bit for bit, with
    float or int8 input and float or requantized int8 output."""
    n, h, w_, cin, cout, k, dil = case
    x, w, bias, w_scale, a_scale, pad = (
        t.to(cuda) if isinstance(t, torch.Tensor) else t
        for t in _int8_conv_case(k, 1, dil, cin, cout, dtype, seed=sum(case),
                                 size=(h, w_)))
    x = x[:1].expand(n, *x.shape[1:]).contiguous() if n > 2 else x[:n].contiguous()
    relu = (cin + dil) % 2 == 0
    a_next = torch.tensor(2.0 ** -3, device=cuda) if "out" in io else None
    if "in" in io:
        x = kernels.int8_quantize(x, a_scale)
    args = (w, bias, w_scale, a_scale, 1, pad, dil, relu, dtype, a_next)
    r0 = kernels.int8_conv.launches_by_route["wgmma"]
    got = kernels.int8_conv(x, *args)
    torch.cuda.synchronize()
    assert kernels.int8_conv.launches_by_route["wgmma"] == r0 + 1
    want = kernels.int8_conv_plain(x, *args)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.equal(got, want), (got.float() - want.float()).abs().max()


def test_int8_conv_cuda_mma_sync_route_refuses_int8(cuda):
    """Cin 50 takes the mma.sync kernel, which has no int8 input or output."""
    x, w, bias, w_scale, a_scale, pad = (
        t.to(cuda) if isinstance(t, torch.Tensor) else t
        for t in _int8_conv_case(1, 1, 1, 50, 64, torch.bfloat16, seed=5))
    xq = kernels.int8_quantize(x, a_scale)
    with pytest.raises(ValueError, match="mma_sync"):
        kernels.int8_conv(xq, w, bias, w_scale, a_scale, 1, 0, 1, False,
                          torch.bfloat16)
    with pytest.raises(ValueError, match="mma_sync"):
        kernels.int8_conv(x, w, bias, w_scale, a_scale, 1, 0, 1, False,
                          a_next=a_scale)
    r0 = dict(kernels.int8_conv.launches_by_route)
    got = kernels.int8_conv(x, w, bias, w_scale, a_scale, 1, 0, 1, True)
    torch.cuda.synchronize()
    assert kernels.int8_conv.launches_by_route["mma_sync"] == r0["mma_sync"] + 1
    assert torch.equal(got, kernels.int8_conv_plain(x, w, bias, w_scale, a_scale,
                                                    1, 0, 1, True))


def test_probe_int8_conv_variants_match_the_source():
    """Each text substitution of tools/probe_int8_conv names a line that
    csrc/int8_conv.cu holds exactly once, so the probe cannot drift from
    the kernel silently."""
    from improved_body_parts_tpu_torch.tools import probe_int8_conv as probe
    with open(probe.SRC) as f:
        src = f.read()
    assert set(probe.VARIANTS) == {"kernel", "no_wgmma", "bn128", "deep_ring",
                                   "tie_call", "one_block", "cvt_round"}
    for name, subs in probe.VARIANTS.items():
        for old, _ in subs:
            assert src.count(old) == 1, name
    assert all(kernels.int8_conv_route(s[3], s[6]) == ("wgmma" if s[3] % 16 == 0
                                                       else "mma_sync")
               for s in probe.SHAPES)


@pytest.mark.parametrize("shape", sorted(kernels._MMA_SYNC_FASTER))
def test_int8_conv_cuda_route_table(cuda, shape):
    """At a shape of the table a float-in, float-out call takes the mma.sync
    kernel, and a call with int8 output keeps the wgmma route; both bit
    for bit."""
    h, w_, cin, cout, k = shape
    x, w, bias, w_scale, a_scale, pad = (
        t.to(cuda) if isinstance(t, torch.Tensor) else t
        for t in _int8_conv_case(k, 1, 1, cin, cout, torch.bfloat16, seed=cin,
                                 size=(h, w_)))
    a_next = torch.tensor(2.0 ** -3, device=cuda)
    for nxt, route in ((None, "mma_sync"), (a_next, "wgmma")):
        args = (w, bias, w_scale, a_scale, 1, pad, 1, True, None, nxt)
        r0 = kernels.int8_conv.launches_by_route[route]
        got = kernels.int8_conv(x, *args)
        torch.cuda.synchronize()
        assert kernels.int8_conv.launches_by_route[route] == r0 + 1
        assert torch.equal(got, kernels.int8_conv_plain(x, *args))
