"""The port's metrics (keymorph_tpu_torch.metrics) and the helpers of
keymorph_tpu_torch.utils against keymorph_tpu's on the same numpy inputs,
made from a seed.

Bars: the label-map Dice, Dice and the Hausdorff distance (KD-tree and EDT
paths) exactly; the Jacobian determinant within 1e-6 of its largest
magnitude (fp32 sums of the same central differences); jdstd within 1e-6
relative, jdlessthan0 exactly; the aggregate classes within 1e-6 of their
mean."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from keymorph_tpu import metrics as JM
from keymorph_tpu import utils as JU
from keymorph_tpu_torch import metrics as M
from keymorph_tpu_torch import utils as U


def _onehot(labels, c):
    return np.eye(c, dtype=np.float32)[labels].transpose(0, 4, 1, 2, 3)


def _blob_masks(rng, n=28):
    z, y, x = np.mgrid[:n, :n, :n]
    m1 = ((z - 13) ** 2 + (y - 14) ** 2 + (x - 15) ** 2) < 8 ** 2
    m2 = ((z - 15) ** 2 + 2 * (y - 12) ** 2 + (x - 13) ** 2) < 7 ** 2
    m1 |= rng.random((n, n, n)) > 0.997  # speckle: many small components
    return m1, m2


def _field(rng, shape=(2, 3, 12, 11, 10), amp=0.3, folds=True):
    """A smooth displacement with (``folds``) a region folded over on
    itself: its Jacobian determinant is negative there."""
    axes = [np.linspace(-1, 1, s) for s in shape[2:]]
    z, y, x = np.meshgrid(*axes, indexing="ij")
    disp = amp * rng.normal(size=shape).astype(np.float32)
    disp = disp * np.exp(-(z ** 2 + y ** 2 + x ** 2))[None, None]
    if folds:
        disp[:, 0] += (-20.0 * z * np.exp(-4 * (z ** 2 + y ** 2 + x ** 2)))[None]
    return disp.astype(np.float32)


def test_fast_dice_and_dice_match_jax(rng):
    for c in (1, 3, 6):
        a = _onehot(rng.integers(0, c, (2, 9, 8, 7)), c)
        b = _onehot(rng.integers(0, c, (2, 9, 8, 7)), c)
        assert M.fast_dice(torch.tensor(a), torch.tensor(b)) == JM.fast_dice(a, b)
        assert M.fast_dice(a, a) == pytest.approx(1.0)
    p = rng.random((1, 4, 6, 6, 6)).astype(np.float32)  # probability maps, argmaxed
    q = rng.random((1, 4, 6, 6, 6)).astype(np.float32)
    assert M.fast_dice(p, q) == JM.fast_dice(p, q)
    m1, m2 = _blob_masks(rng)
    assert M.dice(m1, m2) == JM.dice(m1, m2)


@pytest.mark.parametrize("path", ["kdtree", "edt"])
def test_hausdorff_matches_jax(rng, monkeypatch, path):
    """Both surface-distance paths, equal to keymorph_tpu's exactly, on
    masks as one-hot arrays and as tensors."""
    if path == "edt":
        monkeypatch.setattr(M, "_HAUSD_KDTREE_MAX_SURFACE", 0)
        monkeypatch.setattr(JM, "_HAUSD_KDTREE_MAX_SURFACE", 0)
    m1, m2 = _blob_masks(rng)
    d = M._surface_distances(m1, m2, [1.25, 1.25, 10], 1)
    np.testing.assert_array_equal(d, JM._surface_distances(m1, m2, [1.25, 1.25, 10], 1))
    a = np.stack([1.0 - m1, m1], 0)[None].astype(np.float32)
    b = np.stack([1.0 - m2, m2], 0)[None].astype(np.float32)
    for sampling in ((1.25, 1.25, 10), (1, 1, 1)):
        ref = JM.hausdorff_distance(a, b, sampling=sampling)
        assert M.hausdorff_distance(a, b, sampling=sampling) == ref
        assert M.hausdorff_distance(torch.tensor(a), torch.tensor(b), sampling=sampling) == ref


def test_kdtree_path_equals_edt_path(rng):
    m1, m2 = _blob_masks(rng, 40)
    d_kd = M._surface_distances(m1, m2, [1.25, 1.25, 10], 1)
    old = M._HAUSD_KDTREE_MAX_SURFACE
    try:
        M._HAUSD_KDTREE_MAX_SURFACE = 0
        d_edt = M._surface_distances(m1, m2, [1.25, 1.25, 10], 1)
    finally:
        M._HAUSD_KDTREE_MAX_SURFACE = old
    np.testing.assert_allclose(np.sort(d_kd), np.sort(d_edt), atol=1e-9)


def test_channel0_mask_is_greater_than_one_half():
    """Channel 0 is thresholded at > 0.5, as keymorph_tpu does (a value of
    exactly 0.5 is outside the mask)."""
    seg = np.zeros((1, 2, 4, 4, 4), np.float32)
    seg[0, 0, 1:3, 1:3, 1:3] = 0.5
    seg[0, 0, 2, 2, 2] = 0.75
    got = M.ch0_mask(torch.tensor(seg))
    assert got.dtype == bool and got.sum() == 1
    np.testing.assert_array_equal(got, JM._ch0_mask_host(seg))
    np.testing.assert_array_equal(M.ch0_mask(seg), got)


@pytest.mark.parametrize("folds", [False, True])
def test_jacobian_determinant_matches_jax(rng, folds):
    disp = _field(rng, folds=folds)
    ours = M.jacobian_determinant(torch.tensor(disp))
    ref = np.asarray(JM.jacobian_determinant(jnp.asarray(disp)))
    assert ours.shape == ref.shape == (2, 8, 7, 6) and ours.dtype == torch.float32
    err = np.abs(ours.numpy() - ref).max()
    print(f"jacobian determinant: max abs diff {err:.3g} of max {np.abs(ref).max():.3g}")
    assert err <= 1e-6 * np.abs(ref).max()
    f64 = M.jacobian_determinant(torch.tensor(disp), dtype=torch.float64)
    assert f64.dtype == torch.float64
    assert np.abs(f64.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()


def test_jd_statistics_match_jax(rng):
    """jdstd is the population std (ddof 0: ``jnp.std``'s, not torch's
    default ``correction=1``); jdlessthan0 counts a folded field's
    non-positive determinants (> 0 here)."""
    disp = _field(rng, shape=(1, 3, 12, 11, 10))
    det = np.asarray(JM.jacobian_determinant(jnp.asarray(disp)))
    ours, ref = M.jdstd(torch.tensor(disp)), JM.jdstd(disp)
    assert ours == pytest.approx(ref, rel=1e-6)
    assert ours == pytest.approx(float(np.std(det, ddof=0)), rel=1e-5)
    assert abs(ours - float(np.std(det, ddof=1))) > 1e-3 * ours  # the bar sees ddof
    n = M.jdlessthan0(torch.tensor(disp))
    assert n == JM.jdlessthan0(disp) > 0
    assert M.jdlessthan0(torch.tensor(disp), as_percentage=True) == pytest.approx(
        JM.jdlessthan0(disp, as_percentage=True), rel=1e-6)
    ident = np.zeros((1, 3, 8, 8, 8), np.float32)
    assert M.jdstd(torch.tensor(ident)) == pytest.approx(0.0, abs=1e-6)
    assert M.jdlessthan0(torch.tensor(ident)) == 0


def test_pairwise_aggregates_match_jax(rng, tmp_path):
    """MultipleAvgSegPairwiseMetric and the single-metric pairwise averages,
    on arrays and on .npy paths."""
    labels = rng.integers(0, 3, (3, 10, 10, 10))
    segs = _onehot(labels, 3) * 0.8 + 0.1 * rng.random((3, 3, 10, 10, 10)).astype(np.float32)
    paths = []
    for i in range(3):
        paths.append(str(tmp_path / f"seg{i}.npy"))
        np.save(paths[-1], segs[i: i + 1])
    names = ["dice", "harddice", "harddiceroi", "softdice", "hausd"]
    ref = JM.MultipleAvgSegPairwiseMetric()(jnp.asarray(segs), names)
    for given in (segs, paths):
        ours = M.MultipleAvgSegPairwiseMetric()(given, names)
        assert set(ours) == set(names)
        for k in names:
            np.testing.assert_allclose(ours[k], np.asarray(ref[k]), rtol=1e-6, atol=1e-7)
    for cls, jcls in ((M.MSEPairwiseLoss, JM.MSEPairwiseLoss),
                      (M.SoftDicePairwiseLoss, JM.SoftDicePairwiseLoss),
                      (M.HardDicePairwiseLoss, JM.HardDicePairwiseLoss),
                      (M.HausdorffPairwiseLoss, JM.HausdorffPairwiseLoss)):
        want = float(jcls()(jnp.asarray(segs)))
        assert cls()(segs) == pytest.approx(want, rel=1e-6)
        assert cls()(paths) == pytest.approx(want, rel=1e-6)


def test_grid_aggregates_match_jax(rng, tmp_path):
    """MultipleAvgGridMetric, AvgJDStd and AvgJDLessThan0 over channel-last
    grids (arrays and .npy paths)."""
    grids = np.stack([np.moveaxis(_field(np.random.default_rng(s), (1, 3, 10, 9, 8))[0], 0, -1)
                      for s in range(3)])
    paths = []
    for i in range(3):
        paths.append(str(tmp_path / f"grid{i}.npy"))
        np.save(paths[-1], grids[i: i + 1])
    names = ["jdstd", "jdlessthan0"]
    ref = JM.MultipleAvgGridMetric()(jnp.asarray(grids), names)
    for given in (grids, paths):
        ours = M.MultipleAvgGridMetric()(given, names)
        assert ours["jdstd"] == pytest.approx(float(ref["jdstd"]), rel=1e-6)
        assert ours["jdlessthan0"] == pytest.approx(float(ref["jdlessthan0"]), rel=1e-6)
        assert M.AvgJDStd()(given) == pytest.approx(float(JM.AvgJDStd()(jnp.asarray(grids))),
                                                    rel=1e-6)
        assert M.AvgJDLessThan0()(given) == JM.AvgJDLessThan0()(jnp.asarray(grids))
    assert ref["jdlessthan0"] > 0


def test_utils_helpers_match_jax(rng):
    assert U.str_or_float("0.5") == JU.str_or_float("0.5") == 0.5
    assert U.str_or_float("loguniform") == "loguniform"
    assert U.parse_test_mod("T1_T2") == JU.parse_test_mod("T1_T2") == ("T1", "T2")
    assert U.parse_test_mod(("PD", "T1")) == ("PD", "T1")
    asegs = rng.choice([0, 2, 3, 4, 7, 8, 10, 16, 24, 41, 42, 53, 60, 77], (2, 1, 6, 5, 4))
    np.testing.assert_array_equal(U.one_hot_eval_synthseg(torch.tensor(asegs)).numpy(),
                                  np.asarray(JU.one_hot_eval_synthseg(asegs)))
    x = rng.normal(size=(3, 7, 8)).astype(np.float32) * 40.0 + 3.0
    for kw in ({}, {"out_range": (-1, 2), "percentiles": (2, 98)}):
        np.testing.assert_allclose(U.rescale_intensity(torch.tensor(x), **kw).numpy(),
                                   np.asarray(JU.rescale_intensity(x, **kw)), atol=1e-6)
    assert float(U.rescale_intensity(np.full((4,), 3.0)).max()) == 0.0
    labels = rng.integers(0, 5, (2, 1, 4, 4, 4))
    np.testing.assert_array_equal(U.one_hot(torch.tensor(labels), 6).numpy(),
                                  np.asarray(JU.one_hot(labels, 6)))
    with pytest.raises(ValueError, match="labels outside"):
        U.one_hot(torch.tensor(labels), 3)
