"""The port's cv2-free uint8 resize (``ops/warp.resize_cubic_u8``) against
cv2 itself, and ``letterbox``/``pad_image_to_bucket`` against the JAX
package's, which call cv2.

The resize follows OpenCV's own INTER_CUBIC code for uint8, and is held to
it bit for bit (hypothesis: frame sides 1..2000, up- and downscaling, odd
sizes, 1-pixel frames, one and three channels, the ``(new_w, new_h)`` form
``letterbox`` uses and the ``fx=fy=scale`` form ``pad_image_to_bucket``
uses) with cv2's Intel IPP route switched off (``cv2.ipp.setUseIPP``).
An OpenCV built with IPP (this one: IPP 2026.0) sends frames of 4 x 4
and more to IPP's cubic, which rounds differently: there the largest
deviation is one level, on up to ~6% of the values (none of 442,368 for a
1920x1080 frame to 512x288 in one seed, 2 in another; 4.4% for 300x1000
to 154x512; 5.8% for 300x300 to 9x7), and the tests hold that bound. With IPP off, ``letterbox`` and ``pad_image_to_bucket`` give the
JAX package's uint8 canvases and scales bit for bit.

The bilinear ``resize_linear_u8`` (the int8 export's calibration resize)
is held to cv2's default ``cv2.resize(img, dsize)`` bit for bit with IPP
on and off: OpenCV keeps IPP's linear resize off by default, as it does
not match its own, so both routes are OpenCV's fixed point; an exact
halving of both sides is OpenCV's 2 x 2 area mean.
"""

import contextlib
import os
import subprocess
import sys
import types

import cv2
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from improved_body_parts_tpu import configs as jconfigs
from improved_body_parts_tpu.infer import predict as jpredict
from improved_body_parts_tpu_torch import configs as tconfigs
from improved_body_parts_tpu_torch.infer import predict as tpredict
from improved_body_parts_tpu_torch.ops.warp import resize_cubic_u8, resize_linear_u8
from tests.test_torch_predict import single_torch_thread  # noqa: F401  (autouse)

FRAMES = [(1080, 1920), (480, 640), (1000, 300), (512, 384), (384, 512),
          (2000, 3), (1, 1), (7, 513), (511, 1)]


@contextlib.contextmanager
def ipp(on: bool):
    was = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(on)
    try:
        yield
    finally:
        cv2.ipp.setUseIPP(was)


def _frame(rng, h, w, c):
    shape = (h, w) if c == 0 else (h, w, c)
    return rng.randint(0, 256, shape).astype(np.uint8)


side = st.integers(1, 2000)


@settings(max_examples=30, deadline=None)
@given(h=side, w=side, oh=side, ow=side, c=st.sampled_from([0, 1, 3]),
       seed=st.integers(0, 2 ** 31 - 1))
def test_resize_dsize_is_cv2_bit_for_bit(h, w, oh, ow, c, seed):
    img = _frame(np.random.RandomState(seed), h, w, c)
    with ipp(False):
        want = cv2.resize(img, (ow, oh), interpolation=cv2.INTER_CUBIC)
    got = resize_cubic_u8(img, (ow, oh))
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@settings(max_examples=30, deadline=None)
@given(h=side, w=side, scale=st.floats(0.02, 3.0), c=st.sampled_from([1, 3]),
       seed=st.integers(0, 2 ** 31 - 1))
def test_resize_fx_fy_is_cv2_bit_for_bit(h, w, scale, c, seed):
    if int(np.rint(h * scale)) < 1 or int(np.rint(w * scale)) < 1:
        return                        # cv2 refuses an empty size too
    img = _frame(np.random.RandomState(seed), h, w, c)
    with ipp(False):
        want = cv2.resize(img, (0, 0), fx=scale, fy=scale,
                          interpolation=cv2.INTER_CUBIC)
    got = resize_cubic_u8(img, fx=scale, fy=scale)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("h,w,oh,ow", [(1080, 1920, 288, 512), (480, 640, 384, 512),
                                       (1000, 300, 512, 154), (37, 53, 200, 301),
                                       (300, 300, 7, 9)])
def test_resize_against_cv2_with_ipp_within_one_level(h, w, oh, ow):
    """cv2's default route on this build (IPP): at most one level off, on at
    most a tenth of the values."""
    img = _frame(np.random.RandomState(h * w), h, w, 3)
    with ipp(True):
        want = cv2.resize(img, (ow, oh), interpolation=cv2.INTER_CUBIC)
    d = np.abs(resize_cubic_u8(img, (ow, oh)).astype(int) - want)
    assert d.max() <= 1 and (d > 0).mean() <= 0.1, (d.max(), (d > 0).sum())


@settings(max_examples=30, deadline=None)
@given(h=st.integers(1, 800), w=st.integers(1, 800), oh=st.integers(1, 800),
       ow=st.integers(1, 800), c=st.sampled_from([0, 1, 3, 4]),
       use_ipp=st.booleans(), seed=st.integers(0, 2 ** 31 - 1))
def test_resize_linear_is_cv2_bit_for_bit(h, w, oh, ow, c, use_ipp, seed):
    img = _frame(np.random.RandomState(seed), h, w, c)
    with ipp(use_ipp):
        want = cv2.resize(img, (ow, oh))
    got = resize_linear_u8(img, (ow, oh))
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("h,w,oh,ow,c", [(128, 128, 64, 64, 3), (6, 10, 3, 5, 1),
                                         (2, 2, 1, 1, 4), (8, 8, 4, 4, 2),
                                         (512, 384, 256, 192, 0), (7, 13, 7, 13, 3),
                                         (1, 1, 64, 64, 3), (40, 40, 20, 40, 3)])
def test_resize_linear_halving_and_edges_are_cv2(h, w, oh, ow, c):
    """The exact halvings (OpenCV's fast area mean, rounded up for 1, 3 or 4
    channels, half to even for 2), an identity, a 1-pixel frame and a
    halving of one side only (bilinear)."""
    img = _frame(np.random.RandomState(h + w + c), h, w, c)
    for use_ipp in (False, True):
        with ipp(use_ipp):
            want = cv2.resize(img, (ow, oh))
        np.testing.assert_array_equal(resize_linear_u8(img, (ow, oh)), want)


def _predictors():
    jself = types.SimpleNamespace(config=jconfigs.CanonicalConfig())
    return jself, tpredict.Predictor(None, tconfigs.CanonicalConfig(), device="cpu")


@pytest.mark.parametrize("h,w", FRAMES)
def test_letterbox_matches_jax(h, w):
    jself, tpred = _predictors()
    img = _frame(np.random.RandomState(h + w), h, w, 3)
    got, scale = tpred.letterbox(img)
    with ipp(False):
        want, jscale = jpredict.Predictor.letterbox(jself, img)
    assert scale == jscale and got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    with ipp(True):
        want, _ = jpredict.Predictor.letterbox(jself, img)
    assert np.abs(got.astype(int) - want).max() <= 1


@pytest.mark.parametrize("h,w,max_hw", [(237, 311, (100, 150)), (90, 400, (64, 200)),
                                        (50, 40, (100, 100)), (3000, 20, (2600, 3800))])
def test_pad_image_to_bucket_matches_jax(h, w, max_hw):
    img = _frame(np.random.RandomState(h), h, w, 3)
    got, got_hw = tpredict.pad_image_to_bucket(img, 64, 128, max_hw)
    with ipp(False):
        want, want_hw = jpredict.pad_image_to_bucket(img, 64, 128, max_hw)
    assert got_hw == want_hw
    np.testing.assert_array_equal(got, want)


def test_letterbox_and_bucket_pad_import_no_cv2():
    """In a fresh interpreter where ``import cv2`` fails, both resize."""
    code = (
        "import sys; sys.modules['cv2'] = None\n"
        "import numpy as np\n"
        "from improved_body_parts_tpu_torch import configs\n"
        "from improved_body_parts_tpu_torch.infer import predict\n"
        "img = np.random.RandomState(0).randint(0, 256, (480, 640, 3)).astype(np.uint8)\n"
        "p = predict.Predictor(None, configs.CanonicalConfig(), device='cpu')\n"
        "out, scale = p.letterbox(img)\n"
        "assert out.shape == (512, 512, 3) and scale == 0.8, (out.shape, scale)\n"
        "big, hw = predict.pad_image_to_bucket(img, 64, 128, (100, 100))\n"
        "assert hw == (75, 100) and big.shape == (128, 128, 3), (hw, big.shape)\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
