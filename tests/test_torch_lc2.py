"""LC2 and ImageLC2 (the multimodal similarity) in the port against
keymorph_tpu's on the CPU, on the same seeded numpy volumes.

Both packages compute in fp32: the gradient filter's differences are exact
in either (taps +1 and -1), the 3x3 normal system's sums run over up to
(2r+1)^3 = 3375 voxels in another order, so scores are held within LC2_ABS
(a score lies in [0, 1]). The port's float64 run is the oracle the card's
result is held against (chip_smoke.py phase 13); here keymorph_tpu's fp32
scores must lie within LC2_ABS of it too.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from keymorph_tpu import metrics as jmetrics
from keymorph_tpu_torch import metrics as M
from keymorph_tpu_torch.ops import cuda as kernels

LC2_ABS = 1e-5


def _pair(rng, shape):
    """A volume and a nonlinear, noisy function of it (a stand-in for two
    modalities of one anatomy): LC2 reads well above 0."""
    mr = rng.normal(size=shape).astype(np.float32)
    us = (np.tanh(2 * mr) + 0.3 * rng.normal(size=shape)).astype(np.float32)
    return us, mr


@pytest.mark.parametrize("radiuses", [(3,), (3, 5, 7)])
def test_lc2_matches_jax(rng, radiuses):
    """``LC2(radiuses)`` of a batch of 3 odd cubes of 17^3: (B,) scores
    within LC2_ABS of keymorph_tpu's and of the port's float64 run; a volume
    with itself scores near 1. No kernel counter moves."""
    us, mr = _pair(rng, (3, 1, 17, 17, 17))
    want = np.asarray(jmetrics.LC2(radiuses)(jnp.asarray(us), jnp.asarray(mr)))
    kernels.reset_counters()
    got = M.LC2(radiuses)(torch.tensor(us), torch.tensor(mr))
    assert all(c["launches"] == c["plain_calls"] == 0 for c in kernels.counters().values())
    got64 = M.LC2(radiuses, dtype=torch.float64)(torch.tensor(us), torch.tensor(mr))
    assert got.shape == (3,) and got.dtype == torch.float32
    print(f"LC2{radiuses}: {got.numpy()} port vs keymorph_tpu "
          f"{np.abs(got.numpy() - want).max():.3g}, vs float64 "
          f"{(got.double() - got64).abs().max().item():.3g}")
    np.testing.assert_allclose(got.numpy(), want, atol=LC2_ABS, rtol=0)
    np.testing.assert_allclose(want, got64.numpy(), atol=LC2_ABS, rtol=0)
    assert float(got.min()) > 0.05
    same = M.LC2(radiuses)(torch.tensor(mr), torch.tensor(mr))
    assert float(same.min()) > 0.95


def test_lc2_gradient_filter_is_the_reference_conv(rng):
    """``lc2_gradient`` equals |conv3d(mr, keymorph_tpu's _GRAD_FILTER,
    padding 1)| over the three channels, bit for bit before the norm."""
    mr = rng.normal(size=(2, 9, 10, 11)).astype(np.float32)
    conv = torch.nn.functional.conv3d(torch.tensor(mr)[:, None],
                                      torch.tensor(jmetrics._GRAD_FILTER), padding=1)
    want = torch.sqrt((conv * conv).sum(dim=1))
    torch.testing.assert_close(M.lc2_gradient(torch.tensor(mr)), want, atol=0, rtol=0)


@pytest.mark.parametrize("dims", [2, 3], ids=["2d", "3d"])
def test_patch2batch_matches_jax(rng, dims):
    """``ImageLC2.patch2batch`` in 2D and 3D, with two channels, sizes that
    leave a remainder: the same patches in the same order as keymorph_tpu's,
    bit for bit. A stride other than the size is refused by both (the crop
    and reshape cover non-overlapping patches only)."""
    shape = (2, 2) + ((23, 26) if dims == 2 else (11, 13, 12))
    x = rng.normal(size=shape).astype(np.float32)
    for size in (5, 3):
        want = np.asarray(jmetrics.ImageLC2.patch2batch(jnp.asarray(x), size, size))
        got = M.ImageLC2.patch2batch(torch.tensor(x), size, size)
        np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(TypeError):
        jmetrics.ImageLC2.patch2batch(jnp.asarray(x), 5, 3)
    with pytest.raises(RuntimeError):
        M.ImageLC2.patch2batch(torch.tensor(x), 5, 3)


def test_image_lc2_matches_jax(rng):
    """``ImageLC2(patch_size=15, radiuses=(3, 5))`` of a 31 x 45 x 30 pair
    (2 x 3 x 2 patches): the mean within LC2_ABS of keymorph_tpu's and of
    float64, each patch's score with ``reduction=None``."""
    us, mr = _pair(rng, (1, 1, 31, 45, 30))
    for reduction in ("mean", None):
        want = np.asarray(jmetrics.ImageLC2(15, (3, 5), reduction)(jnp.asarray(us),
                                                                   jnp.asarray(mr)))
        got = M.ImageLC2(15, (3, 5), reduction)(torch.tensor(us), torch.tensor(mr))
        got64 = M.ImageLC2(15, (3, 5), reduction, dtype=torch.float64)(torch.tensor(us),
                                                                       torch.tensor(mr))
        assert got.shape == want.shape == ((12,) if reduction is None else ())
        np.testing.assert_allclose(got.numpy(), want, atol=LC2_ABS, rtol=0)
        np.testing.assert_allclose(got64.numpy(), want, atol=LC2_ABS, rtol=0)


def test_lc2_refusals_match_jax(rng):
    """keymorph_tpu refuses an even size (its assertion names it, the case
    of tests/test_review_fixes.py), a non-cubic volume, a 2D patch batch
    (its cubic check indexes a third axis) and an unknown reduction; the
    port raises a ValueError for each."""
    even = rng.normal(size=(1, 1, 16, 16, 16)).astype(np.float32)
    with pytest.raises(AssertionError, match="odd"):
        jmetrics.LC2(radiuses=(3,))(jnp.asarray(even), jnp.asarray(even))
    with pytest.raises(ValueError, match="odd"):
        M.LC2(radiuses=(3,))(torch.tensor(even), torch.tensor(even))
    flat = rng.normal(size=(1, 1, 15, 15, 17)).astype(np.float32)
    with pytest.raises(AssertionError, match="cubic"):
        jmetrics.LC2(radiuses=(3,))(jnp.asarray(flat), jnp.asarray(flat))
    with pytest.raises(ValueError, match="cubic"):
        M.LC2(radiuses=(3,))(torch.tensor(flat), torch.tensor(flat))
    img2d = rng.normal(size=(1, 1, 30, 30)).astype(np.float32)
    with pytest.raises(IndexError):
        jmetrics.ImageLC2(15)(jnp.asarray(img2d), jnp.asarray(img2d))
    with pytest.raises(ValueError, match="cubic"):
        M.ImageLC2(15)(torch.tensor(img2d), torch.tensor(img2d))
    with pytest.raises(AssertionError):
        jmetrics.ImageLC2(reduction="sum")
    with pytest.raises(ValueError, match="reduction"):
        M.ImageLC2(reduction="sum")
