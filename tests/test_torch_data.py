"""The port's data layer (keymorph_tpu_torch.data, .native.kmio) against
keymorph_tpu's on the same files: every case of tests/test_data.py on the
port's modules (the cases that read the original example data, which the
repo does not hold, run on files that ``save_nifti`` or keymorph_tpu's
``make_synthetic_dataset`` writes), and the port held bit for bit against
keymorph_tpu: ``load_nifti`` (data and affine; sform, qform and int files),
``to_canonical`` (flips and permutations), ``resize_volume`` (linear and
nearest), ``Preprocessor`` (img, seg, affine), the CSV and IXI subject
lists and ``DataLoader`` batches. The C++ helper (built at first use) is held against Python's gzip
and ``resize_volume``; its cases skip only where ``g++`` is absent."""

import gzip
import shutil
import struct
import threading
import time

import numpy as np
import pytest
import torch

from keymorph_tpu.data import datasets as jdatasets
from keymorph_tpu.data import nifti as jnifti
from keymorph_tpu.data import preprocess as jpreprocess
from keymorph_tpu_torch.data.datasets import (
    CSVDataset,
    DataLoader,
    IXIDataset,
    PairedDataset,
    SingleDataset,
    Subject,
)
from keymorph_tpu_torch.data.loader import ThreadPrefetcher, device_prefetch
from keymorph_tpu_torch.data.nifti import (
    NiftiImage,
    gzip_reader,
    load_nifti,
    orientation_transform,
    save_nifti,
    to_canonical,
)
from keymorph_tpu_torch.data.preprocess import Preprocessor, resize_volume
from keymorph_tpu_torch.native import kmio

@pytest.fixture
def needs_gxx():
    if shutil.which("g++") is None:
        pytest.skip("no g++: the C++ helper cannot be built")


@pytest.fixture(scope="module")
def seg_file(tmp_path_factory):
    """A 14-label segmentation with a scanner affine (anisotropic voxels,
    turned 10 degrees), as .nii.gz: the stand-in for the reference's
    example segmentation."""
    rng = np.random.default_rng(3)
    z, y, x = np.meshgrid(*[np.linspace(-1, 1, n) for n in (20, 18, 14)], indexing="ij")
    seg = np.zeros((20, 18, 14), np.int16)
    for label in range(1, 14):
        c = rng.uniform(-0.6, 0.6, 3)
        seg[((z - c[0]) ** 2 + (y - c[1]) ** 2 + (x - c[2]) ** 2) < 0.08] = label
    path = str(tmp_path_factory.mktemp("seg") / "seg.nii.gz")
    save_nifti(path, seg, _scanner_affine((0.94, 0.94, 1.2), 10.0))
    return path


@pytest.fixture(scope="module")
def synthetic(tmp_path_factory):
    """keymorph_tpu's synthetic dataset: 3 subjects x (T1, T2) at 16^3 with
    4-label segmentations and a CSV in the modality schema."""
    from keymorph_tpu.tools.make_synthetic_dataset import main

    out = tmp_path_factory.mktemp("synthetic")
    csv_path = main(["--out", str(out), "--n", "3", "--size", "16",
                     "--modalities", "T1", "T2", "--n_test", "1"])
    return out, csv_path


def _scanner_affine(spacing, degrees, shift=(3.0, -2.0, 4.0)):
    a = np.deg2rad(degrees)
    rot = np.array([[1, 0, 0], [0, np.cos(a), -np.sin(a)], [0, np.sin(a), np.cos(a)]])
    aff = np.eye(4)
    aff[:3, :3] = rot @ np.diag(spacing)
    aff[:3, 3] = shift
    return aff


def _same_image(a, b):
    np.testing.assert_array_equal(a.data, b.data)
    assert a.data.dtype == b.data.dtype
    np.testing.assert_array_equal(a.affine, b.affine)


# ---------------------------------------------------------------------------
# the cases of tests/test_data.py on the port's modules
# ---------------------------------------------------------------------------


def test_load_real_nifti(seg_file):
    img = load_nifti(seg_file)
    assert img.shape == (20, 18, 14)
    assert img.affine.shape == (4, 4)
    assert len(np.unique(img.data)) == 14
    assert np.isfinite(img.affine).all()


def test_nifti_roundtrip(tmp_path, rng):
    data = rng.normal(size=(9, 11, 13)).astype(np.float32)
    aff = np.eye(4, dtype=np.float64)
    aff[:3, 3] = [1, 2, 3]
    for name in ("a.nii", "a.nii.gz"):
        path = str(tmp_path / name)
        save_nifti(path, data, aff)
        back = load_nifti(path)
        np.testing.assert_allclose(back.data, data, atol=1e-6)
        np.testing.assert_allclose(back.affine, aff, atol=1e-5)


def test_nifti_int_roundtrip(tmp_path, rng):
    data = rng.integers(0, 100, size=(5, 6, 7)).astype(np.int16)
    path = str(tmp_path / "i.nii.gz")
    save_nifti(path, data)
    back = load_nifti(path, dtype=None)
    np.testing.assert_array_equal(back.data, data)


def test_to_canonical_flips():
    data = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    aff = np.diag([-1.0, 1.0, 1.0, 1.0])  # L-A-S -> needs axis-0 flip
    canon = to_canonical(NiftiImage(data=data, affine=aff))
    np.testing.assert_allclose(canon.data, data[::-1])
    assert canon.affine[0, 0] > 0
    # world coordinates of any voxel are preserved
    world_orig = aff @ np.array([0, 1, 2, 1.0])
    world_new = canon.affine @ np.array([1, 1, 2, 1.0])  # flipped axis 0: 0 -> 1
    np.testing.assert_allclose(world_orig, world_new)


def test_to_canonical_permutation():
    rng = np.random.default_rng(0)
    data = rng.normal(size=(3, 4, 5)).astype(np.float32)
    perm_aff = np.zeros((4, 4))
    perm_aff[0, 2] = perm_aff[1, 0] = perm_aff[2, 1] = perm_aff[3, 3] = 1.0
    canon = to_canonical(NiftiImage(data=data, affine=perm_aff))
    assert canon.data.shape == (5, 3, 4)
    np.testing.assert_allclose(np.abs(np.diag(canon.affine))[:3], 1.0)


def test_resize_volume_upsample_matches_jax(rng):
    """Upsampling agrees with jax.image.resize (same centre convention)."""
    import jax
    import jax.numpy as jnp

    src = rng.normal(size=(8, 9, 10)).astype(np.float32)
    out = resize_volume(src, (16, 12, 20))
    ref = np.asarray(jax.image.resize(jnp.asarray(src), (16, 12, 20), method="trilinear"))
    np.testing.assert_allclose(out, ref, atol=2e-5)


def test_resize_volume_downsample_matches_map_coordinates(rng):
    """Downsampling = linear interpolation at output voxel centres."""
    from scipy.ndimage import map_coordinates

    src = rng.normal(size=(8, 9, 10)).astype(np.float32)
    target = (4, 5, 6)
    out = resize_volume(src, target)
    coords = np.meshgrid(*[(np.arange(t) + 0.5) * (s / t) - 0.5
                           for t, s in zip(target, src.shape)], indexing="ij")
    ref = map_coordinates(src, np.stack(coords), order=1, mode="nearest")
    np.testing.assert_allclose(out, ref, atol=1e-5)


def test_native_kmio_available(needs_gxx):
    assert kmio.available(), kmio.build_error()
    assert gzip_reader() == "kmio"


def test_native_gunzip_matches_python(seg_file, needs_gxx):
    with gzip.open(seg_file, "rb") as fh:
        expect = fh.read()
    assert kmio.gunzip_file(seg_file) == expect


def test_native_resize_matches_numpy(rng, needs_gxx):
    """The C++ resize against resize_volume, with tests/test_data.py's
    tolerances (float32 weights in C++, float64 in numpy)."""
    src = rng.normal(size=(16, 16, 16)).astype(np.float32)
    np.testing.assert_allclose(kmio.resize_trilinear(src, (8, 12, 20)),
                               resize_volume(src, (8, 12, 20)), atol=1e-5)
    np.testing.assert_allclose(kmio.resize_trilinear(src, (8, 8, 8), nearest=True),
                               resize_volume(src, (8, 8, 8), order="nearest"), atol=1e-6)


def test_preprocessor_pipeline(seg_file):
    out = Preprocessor(size=(32, 32, 32)).load(seg_file)
    assert out["img"].shape == (1, 32, 32, 32)
    assert out["img"].min() >= 0 and out["img"].max() <= 1.0
    assert out["affine"].shape == (4, 4)
    # the resized affine's spacing is the canonical spacing times the scale
    canon = to_canonical(load_nifti(seg_file))
    scale = np.asarray(canon.shape) / 32.0
    expect = np.linalg.norm(canon.affine[:3, 0]) * scale[0]
    assert np.linalg.norm(out["affine"][:3, 0]) == pytest.approx(expect, rel=1e-4)


def test_csv_dataset_modality_schema(tmp_path, seg_file):
    csv_path = tmp_path / "data.csv"
    csv_path.write_text(
        "img_path,seg_path,mask_path,modality,train\n"
        f"{seg_file},{seg_file},None,T1,True\n"
        f"{seg_file},None,None,T1,True\n"
        f"{seg_file},None,None,T2,True\n"
        f"{seg_file},None,None,T1,False\n")
    ds = CSVDataset(str(csv_path))
    subs = ds.get_subjects(train=True)
    assert set(subs.keys()) == {"T1", "T2"}
    assert len(subs["T1"]) == 2 and len(subs["T2"]) == 1
    assert ds.seg_available
    assert len(ds.get_subjects(train=False)["T1"]) == 1


def test_csv_dataset_pairs_schema(tmp_path, seg_file):
    csv_path = tmp_path / "pairs.csv"
    csv_path.write_text(
        "fixed_img_path,fixed_seg_path,fixed_mask_path,"
        "moving_img_path,moving_seg_path,moving_mask_path,train\n"
        f"{seg_file},None,None,{seg_file},None,None,True\n")
    fixed, moving = CSVDataset(str(csv_path)).get_subjects(train=True)
    assert len(fixed) == 1 and len(moving) == 1
    assert fixed[0].modality == "fixed"


def test_paired_loader_batching(seg_file):
    subs = [Subject(img_path=seg_file, modality="T1") for _ in range(3)]
    loader = DataLoader(PairedDataset(list(zip(subs, subs)), Preprocessor(size=(16, 16, 16))),
                        batch_size=2, shuffle=True)
    batches = list(loader)
    assert len(batches) == 2
    b1, b2 = batches[0]
    assert b1["img"].shape == (2, 1, 16, 16, 16)
    assert b2["img"].shape == (2, 1, 16, 16, 16)
    assert b1["affine"].shape == (2, 4, 4)


def _ixi_tree(root):
    for mod in ("T1", "T2", "PD"):
        (root / mod).mkdir(parents=True)
        (root / f"{mod}_mask").mkdir()
        (root / f"{mod}_seg").mkdir()
    for i in range(3):
        save_nifti(str(root / "T1" / f"sub{i}.nii.gz"), np.zeros((4, 4, 4), np.float32))
        save_nifti(str(root / "T1_mask" / f"sub{i}_mask.nii.gz"), np.ones((4, 4, 4), np.float32))
    save_nifti(str(root / "T1_seg" / "sub1_seg.nii.gz"), np.ones((4, 4, 4), np.int16))
    save_nifti(str(root / "T2" / "sub0.nii.gz"), np.zeros((4, 4, 4), np.float32))


def test_ixi_dataset_layout(tmp_path):
    _ixi_tree(tmp_path / "ixi")
    ds = IXIDataset(str(tmp_path / "ixi"))
    ds.TRAIN_SLICE = (0, 1)
    ds.TEST_SLICE = (1, 2)
    subs = ds.get_subjects(train=True)
    assert len(subs["T1"]) == 1
    assert subs["T1"][0].mask_path is not None
    assert subs["T1"][0].seg_path is None
    assert len(ds.get_subjects(train=False)["T1"]) == 1


def test_thread_prefetcher_order_and_reuse():
    pf = ThreadPrefetcher([1, 2, 3, 4], depth=2)
    assert list(pf) == [1, 2, 3, 4]
    assert list(pf) == [1, 2, 3, 4]  # re-iterable
    assert len(pf) == 4


def test_thread_prefetcher_propagates_errors():
    def gen():
        yield 1
        raise RuntimeError("boom")

    class L:
        def __iter__(self):
            return gen()

    it = iter(ThreadPrefetcher(L(), depth=1))
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="boom"):
        next(it)


def test_thread_prefetcher_early_break_releases_worker():
    """Breaking out of a prefetched loop releases the worker thread."""
    produced = []

    class L:
        def __iter__(self):
            for i in range(100):
                produced.append(i)
                yield i

    before = threading.active_count()
    for x in ThreadPrefetcher(L(), depth=2):
        if x == 3:
            break
    deadline = time.time() + 3.0
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before, "prefetch worker still alive"
    assert len(produced) < 100, "worker consumed the whole loader anyway"


def test_device_prefetch_mapping():
    assert list(device_prefetch([1, 2, 3], to_device=lambda x: x * 10, depth=1)) == [10, 20, 30]


def test_prefetcher_overlaps_io():
    """Prefetch overlaps producer latency with consumer work (against a
    measured serial baseline)."""
    class SlowLoader:
        def __iter__(self):
            for i in range(4):
                time.sleep(0.05)
                yield i

    t0 = time.time()
    for _ in SlowLoader():
        time.sleep(0.05)
    serial = time.time() - t0
    t0 = time.time()
    for _ in ThreadPrefetcher(SlowLoader(), depth=2):
        time.sleep(0.05)
    overlapped = time.time() - t0
    assert overlapped < 0.9 * serial, f"no overlap: {overlapped:.2f}s vs serial {serial:.2f}s"


# ---------------------------------------------------------------------------
# the port against keymorph_tpu on the same files, bit for bit
# ---------------------------------------------------------------------------


def _qform_file(path, data, spacing, quat, offset, qfac=-1.0):
    """A .nii whose affine is a qform only (sform_code 0)."""
    save_nifti(path, data)
    raw = bytearray(open(path, "rb").read())
    struct.pack_into("<8f", raw, 76, qfac, *spacing, 1.0, 1.0, 1.0, 1.0)
    struct.pack_into("<h", raw, 252, 1)  # qform_code
    struct.pack_into("<h", raw, 254, 0)  # sform_code
    struct.pack_into("<6f", raw, 256, *quat, *offset)
    open(path, "wb").write(bytes(raw))


def test_load_nifti_matches_jax(tmp_path, rng, seg_file):
    """Data and affine bit for bit: float .nii and .nii.gz with a scanner
    sform, an int16 label file, a uint8 file read raw, a qform-only file."""
    paths = [seg_file]
    vol = rng.normal(size=(7, 9, 11)).astype(np.float32)
    for name in ("f.nii", "f.nii.gz"):
        save_nifti(str(tmp_path / name), vol, _scanner_affine((1.1, 0.9, 1.3), -25.0))
        paths.append(str(tmp_path / name))
    save_nifti(str(tmp_path / "u.nii.gz"), rng.integers(0, 255, (5, 6, 7)).astype(np.uint8))
    _qform_file(str(tmp_path / "q.nii"), vol, (0.9, 1.1, 1.4), (0.1, -0.2, 0.3),
                (-10.0, 20.0, 5.0))
    paths += [str(tmp_path / "u.nii.gz"), str(tmp_path / "q.nii")]
    for path in paths:
        for dtype in (np.float32, None):
            _same_image(load_nifti(path, dtype=dtype), jnifti.load_nifti(path, dtype=dtype))
    q = load_nifti(str(tmp_path / "q.nii"))
    assert not np.allclose(q.affine[:3, :3], np.diag(np.diag(q.affine[:3, :3])))  # rotated


@pytest.mark.parametrize("seed", range(6))
def test_to_canonical_matches_jax(seed):
    """Random permutations and flips of a turned anisotropic affine: the
    port's orientation, data and affine equal keymorph_tpu's exactly."""
    rng = np.random.default_rng(seed)
    data = rng.normal(size=(4, 5, 6)).astype(np.float32)
    base = _scanner_affine(rng.uniform(0.8, 1.5, 3), rng.uniform(-30, 30))
    perm = rng.permutation(3)
    flips = np.where(rng.random(3) < 0.5, -1.0, 1.0)
    aff = base.copy()
    aff[:3, :3] = (base[:3, :3] * flips)[:, perm]
    img = NiftiImage(data=data, affine=aff)
    assert orientation_transform(aff) == jnifti.orientation_transform(aff)
    _same_image(to_canonical(img), jnifti.to_canonical(jnifti.NiftiImage(data=data, affine=aff)))


@pytest.mark.parametrize("order", ["linear", "nearest"])
def test_resize_volume_matches_jax(rng, order):
    for src_shape, target in (((8, 9, 10), (16, 12, 20)), ((20, 18, 14), (8, 8, 8))):
        src = rng.normal(size=src_shape).astype(np.float32)
        out = resize_volume(src, target, order=order)
        ref = jpreprocess.resize_volume(src, target, order=order)
        np.testing.assert_array_equal(out, ref)
        assert out.dtype == ref.dtype


def test_preprocessor_matches_jax(tmp_path, seg_file):
    """img, seg and affine equal keymorph_tpu's for a masked, resized,
    canonicalized scan, with percentile clipping and without."""
    rng = np.random.default_rng(7)
    aff = _scanner_affine((0.94, 0.94, 1.2), 10.0)
    aff[:3, :3] = aff[:3, [2, 0, 1]] * np.array([1.0, -1.0, 1.0])  # permuted, flipped
    img_path, mask_path = str(tmp_path / "img.nii.gz"), str(tmp_path / "mask.nii.gz")
    save_nifti(img_path, rng.random((20, 18, 14)).astype(np.float32) * 300.0, aff)
    save_nifti(mask_path, (rng.random((20, 18, 14)) > 0.2).astype(np.uint8), aff)
    for kw in (dict(size=(16, 24, 12)), dict(size=(20, 18, 14), percentiles=(1, 99))):
        out = Preprocessor(**kw).load(img_path, seg_file, mask_path)
        ref = jpreprocess.Preprocessor(**kw).load(img_path, seg_file, mask_path)
        assert set(out) == set(ref)
        for k in ("img", "seg", "affine"):
            np.testing.assert_array_equal(out[k], ref[k])
            assert out[k].dtype == ref[k].dtype


def _subject_fields(s):
    return (s.img_path, s.seg_path, s.mask_path, s.modality, s.name)


def _subject_lists(subs):
    if isinstance(subs, dict):
        return {k: [_subject_fields(s) for s in v] for k, v in subs.items()}
    return [[_subject_fields(s) for s in lst] for lst in subs]


def test_subject_lists_match_jax(tmp_path, synthetic):
    """The CSV (both schemas) and IXI subject lists are keymorph_tpu's."""
    out, csv_path = synthetic
    pairs_csv = tmp_path / "pairs.csv"
    pairs_csv.write_text(
        "fixed_img_path,fixed_seg_path,fixed_mask_path,"
        "moving_img_path,moving_seg_path,moving_mask_path,train\n"
        f"{out}/img0_T1.nii.gz,{out}/seg0_T1.nii.gz,None,{out}/img1_T1.nii.gz,None,None,True\n"
        f"{out}/img2_T1.nii.gz,None,None,{out}/img1_T2.nii.gz,{out}/seg1_T2.nii.gz,None,False\n")
    _ixi_tree(tmp_path / "ixi")
    for ours, theirs in ((CSVDataset(csv_path), jdatasets.CSVDataset(csv_path)),
                         (CSVDataset(str(pairs_csv)), jdatasets.CSVDataset(str(pairs_csv))),
                         (IXIDataset(str(tmp_path / "ixi")),
                          jdatasets.IXIDataset(str(tmp_path / "ixi")))):
        for train in (True, False):
            assert (_subject_lists(ours.get_subjects(train))
                    == _subject_lists(theirs.get_subjects(train)))
        assert ours.seg_available == theirs.seg_available


def _same_batch(a, b):
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same_batch(x, y)
        return
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k])
            assert a[k].dtype == b[k].dtype
        else:
            assert a[k] == b[k]


def test_loader_batches_match_jax(synthetic):
    """Pretrain, train and test loaders of the synthetic CSV: the same
    batches in the same (seeded, shuffled) order as keymorph_tpu's."""
    _, csv_path = synthetic
    ours = CSVDataset(csv_path).get_loaders(2, 1, True, Preprocessor(size=(12, 12, 12)),
                                            ["T1_T1", "T1_T2"])
    theirs = jdatasets.CSVDataset(csv_path).get_loaders(
        2, 1, True, jpreprocess.Preprocessor(size=(12, 12, 12)), ["T1_T1", "T1_T2"])
    for lo, lt in zip(ours, theirs):
        assert len(lo) == len(lt)
        bo, bt = list(lo), list(lt)
        assert len(bo) == len(bt) > 0
        for x, y in zip(bo, bt):
            _same_batch(x, y)


def test_single_dataset_and_gzip_reader(synthetic):
    """SingleDataset loads what Subject.load gives; .gz files read the same
    through either reader."""
    out, _ = synthetic
    subj = Subject(img_path=f"{out}/img0_T1.nii.gz", seg_path=f"{out}/seg0_T1.nii.gz",
                   modality="T1")
    item = SingleDataset([subj], Preprocessor(size=(8, 8, 8)))[0]
    assert item["img"].shape == (1, 8, 8, 8) and item["name"] == "img0_T1"
    raw = open(f"{out}/img0_T1.nii.gz", "rb").read()
    assert gzip.decompress(raw) == jnifti._read_bytes(f"{out}/img0_T1.nii.gz")
    assert gzip_reader() in ("kmio", "gzip")


def test_device_prefetch_moves_batches_to_the_device(synthetic):
    """The default transfer: every array of a (paired) batch becomes a
    tensor on the device asked for, names pass through."""
    _, csv_path = synthetic
    loader = CSVDataset(csv_path).get_test_loaders(1, 1, Preprocessor(size=(8, 8, 8)),
                                                   ["T1_T2"])
    got = list(device_prefetch(loader, device="cpu"))
    want = list(loader)
    assert len(got) == len(want) == 1
    (f, m), (wf, wm) = got[0], want[0]
    assert torch.is_tensor(f["img"]) and f["img"].device.type == "cpu"
    np.testing.assert_array_equal(f["img"].numpy(), wf["img"])
    np.testing.assert_array_equal(m["seg"].numpy(), wm["seg"])
    assert f["modality"] == wf["modality"]
