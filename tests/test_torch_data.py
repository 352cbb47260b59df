"""The port's dataset and loader (data/datasets.py, data/augment.py) against
the JAX package's on the same files.

augment=False (square and rect): images byte-equal, labels atol 1e-6, the
same masks, shapes meta and batch shapes. augment=True with scratch-low
(mosaic, HSV, flips, random perspective): the JAX package's global
generators and the port's own seeded alike, one worker; the host ops are
byte-equal to cv2 (tests/test_torch_image_ops.py), so images are held
byte-equal too and labels to atol 1e-4.
"""

import random
import shutil
from pathlib import Path

import numpy as np
import pytest
import yaml

from yolov3_tpu.data import datasets as jax_datasets
from yolov3_tpu.data.augment import mixup as jax_mixup
from yolov3_tpu.data.augment import mosaic4 as jax_mosaic4
from yolov3_tpu_torch.data import augment, datasets, synthetic
from yolov3_tpu_torch.data.dataset_yaml import check_dataset

ROOT = Path(__file__).resolve().parents[1]
HYP = yaml.safe_load((ROOT / "yolov3_tpu_torch/data/hyps/scratch-low.yaml").read_text())
IMGSZ = 64


@pytest.fixture(scope="module")
def dataset_dir(tmp_path_factory):
    out = tmp_path_factory.mktemp("data") / "shapes"
    synthetic.generate(out, n_images=12, imgsz=IMGSZ, seed=1, n_val=0)
    return out


def fresh_copy(src, dst):
    """A copy of the dataset without any label cache."""
    shutil.copytree(src, dst)
    for f in Path(dst).rglob("*.cache.npz"):
        f.unlink()
    return Path(dst) / "images" / "train"


def assert_samples_equal(a, b, label_atol):
    np.testing.assert_array_equal(b[0], a[0])
    np.testing.assert_allclose(b[1], a[1], atol=label_atol)
    assert b[2] == a[2]


@pytest.mark.parametrize("rect", [False, True])
def test_dataset_without_augment_equals_jax(dataset_dir, tmp_path, rect):
    images = fresh_copy(dataset_dir, tmp_path / "d")
    kw = dict(imgsz=IMGSZ, augment=False, rect=rect, stride=32, pad=0.5 if rect else 0.0, batch_size=4, num_cls=5)
    jds = jax_datasets.DetectionDataset(str(images), **kw)
    pds = datasets.DetectionDataset(str(images), **kw)
    assert pds.im_files == jds.im_files and len(pds) == 12
    if rect:
        np.testing.assert_array_equal(pds.batch_shapes, jds.batch_shapes)
    for i in range(len(pds)):
        assert_samples_equal(jds[i], pds[i], 1e-6)


def test_dataset_with_augment_equals_jax(dataset_dir, tmp_path):
    images = fresh_copy(dataset_dir, tmp_path / "d")
    kw = dict(imgsz=IMGSZ, augment=True, hyp={**HYP, "mixup": 0.5, "degrees": 5.0, "shear": 2.0}, stride=32,
              batch_size=4, num_cls=5)
    jds = jax_datasets.DetectionDataset(str(images), **kw)
    pds = datasets.DetectionDataset(str(images), rng=random.Random(3), np_rng=np.random.RandomState(3), **kw)
    random.seed(3)
    np.random.seed(3)
    for i in range(len(pds)):
        assert_samples_equal(jds[i], pds[i], 1e-4)


def test_letterbox_path_with_perspective_equals_jax(dataset_dir, tmp_path):
    """mosaic off: the letterbox + random_perspective branch, with perspective."""
    images = fresh_copy(dataset_dir, tmp_path / "d")
    hyp = {**HYP, "mosaic": 0.0, "perspective": 5e-4, "degrees": 3.0, "flipud": 0.5}
    kw = dict(imgsz=IMGSZ, augment=True, hyp=hyp, stride=32, batch_size=4, num_cls=5)
    jds = jax_datasets.DetectionDataset(str(images), **kw)
    pds = datasets.DetectionDataset(str(images), rng=random.Random(5), np_rng=np.random.RandomState(5), **kw)
    random.seed(5)
    np.random.seed(5)
    for i in range(len(pds)):
        assert_samples_equal(jds[i], pds[i], 1e-4)


@pytest.mark.parametrize("quad,multi_scale", [(False, False), (True, False), (False, True)])
def test_loader_equals_jax(dataset_dir, tmp_path, quad, multi_scale):
    images = fresh_copy(dataset_dir, tmp_path / "d")
    kw = dict(imgsz=IMGSZ, augment=True, hyp=HYP, stride=32, batch_size=4, num_cls=5)
    lkw = dict(batch_size=4, shuffle=True, max_labels=300, seed=7, drop_last=True, quad=quad, workers=1,
               label_buckets=True)
    jl = jax_datasets.DataLoader(jax_datasets.DetectionDataset(str(images), **kw), **lkw)
    pl = datasets.DataLoader(datasets.DetectionDataset(str(images), rng=random.Random(7),
                                                       np_rng=np.random.RandomState(7), **kw), **lkw)
    if multi_scale:
        jl.set_multi_scale([32, 64, 96], seed=7, period=1)
        pl.set_multi_scale([32, 64, 96], seed=7, period=1)
    assert len(pl) == len(jl) == 3
    random.seed(7)
    np.random.seed(7)
    want = list(jl)
    got = list(pl)
    assert len(got) == len(want) == 3
    for (ja, jt, jm, js), (pa, pt, pm, ps) in zip(want, got):
        assert pa.dtype == np.uint8 and pt.dtype == np.float32 and pm.dtype == bool
        np.testing.assert_array_equal(pa, ja)
        np.testing.assert_allclose(pt, jt, atol=1e-4)
        np.testing.assert_array_equal(pm, jm)
        assert ps == js
    if quad:
        assert got[0][0].shape == (1, 2 * IMGSZ, 2 * IMGSZ, 3)


def test_collate_fixed_and_quad_equal_jax():
    rng = np.random.default_rng(0)
    samples = [(rng.integers(0, 256, (32, 32, 3), dtype=np.uint8),
                rng.uniform(0.1, 0.9, (int(n), 5)).astype(np.float32), None) for n in (3, 0, 40, 7)]
    for fn, jfn in ((datasets.collate_fixed, jax_datasets.collate_fixed),
                    (datasets.collate_quad, jax_datasets.collate_quad)):
        for bucket in (False, True):
            got, want = fn(samples, 300, bucket=bucket), jfn(samples, 300, bucket=bucket)
            for g, w in zip(got[:3], want[:3]):
                np.testing.assert_array_equal(g, w)
    assert datasets.collate_fixed(samples, 300, bucket=True)[1].shape == (4, 64, 5)
    assert [datasets.label_bucket(n, 300) for n in (0, 33, 200, 300, 999)] == [32, 64, 256, 300, 300]


def test_mosaic_and_mixup_equal_jax():
    rng = np.random.default_rng(1)
    images = [rng.integers(0, 256, (int(h), int(w), 3), dtype=np.uint8) for h, w in rng.integers(40, 90, (4, 2))]
    labels = [np.array([[k % 3, 0.5, 0.5, 0.3, 0.4]], np.float32) for k in range(4)]
    random.seed(11)
    want = jax_mosaic4(images, labels, [[] for _ in range(4)], 64, [-32, -32], HYP)
    got = augment.mosaic4(images, labels, 64, [-32, -32], HYP, rng=random.Random(11))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], atol=1e-4)
    np.random.seed(2)
    want = jax_mixup(images[0][:40, :40], labels[0], images[1][:40, :40], labels[1])
    got = augment.mixup(images[0][:40, :40], labels[0], images[1][:40, :40], labels[1],
                        np_rng=np.random.RandomState(2))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_cutout_equals_jax():
    from yolov3_tpu.data.augment import cutout as jax_cutout

    im = np.random.default_rng(2).integers(0, 256, (64, 64, 3), dtype=np.uint8)
    labels = np.array([[0, 0.5, 0.5, 0.2, 0.2], [1, 0.2, 0.3, 0.1, 0.1]], np.float32)
    a, b = im.copy(), im.copy()
    random.seed(4)
    want = jax_cutout(a, labels, p=1.0)
    got = augment.cutout(b, labels, p=1.0, rng=random.Random(4))
    np.testing.assert_array_equal(b, a)
    np.testing.assert_array_equal(got, want)


def test_copy_paste_refuses_segments():
    im = np.zeros((8, 8, 3), np.uint8)
    lb = np.zeros((0, 5), np.float32)
    assert augment.copy_paste(im, lb, [], p=0.5, rng=random.Random(0))[0] is im
    with pytest.raises(NotImplementedError, match="segments"):
        augment.copy_paste(im, lb, [np.zeros((3, 2))], p=0.5, rng=random.Random(0))


def test_label_cache_and_corrupt_files(dataset_dir, tmp_path, monkeypatch):
    images = fresh_copy(dataset_dir, tmp_path / "d")
    (images / "zz_corrupt.png").write_bytes(b"not an image at all")
    labels = images.parent.parent / "labels" / "train"
    shutil.copy(images / "00000.png", images / "zz_badlabel.png")
    (labels / "zz_badlabel.txt").write_text("7 0.5 0.5 0.2 0.2\n")  # class out of range
    shutil.copy(images / "00001.png", images / "zz_dup.png")
    (labels / "zz_dup.txt").write_text("1 0.5 0.5 0.2 0.2\n1 0.5 0.5 0.2 0.2\n")  # a duplicate row
    shutil.copy(images / "00002.png", images / "zz_nolabel.png")

    pds = datasets.DetectionDataset(str(images), imgsz=IMGSZ, num_cls=5)
    names = [Path(f).name for f in pds.im_files]
    assert "zz_corrupt.png" not in names and "zz_badlabel.png" not in names
    assert len(pds) == 14 and len(pds.labels[names.index("zz_dup.png")]) == 1
    assert len(pds.labels[names.index("zz_nolabel.png")]) == 0
    cache = labels.with_suffix(".cache.npz")
    assert cache.is_file()

    # the JAX package reads the port's cache (same version and key) and sees the same files and labels
    jds = jax_datasets.DetectionDataset(str(images), imgsz=IMGSZ, num_cls=5)
    assert jds.im_files == pds.im_files
    for a, b in zip(jds.labels, pds.labels):
        np.testing.assert_array_equal(a, b)

    # a second port dataset loads the cache: no file is verified again
    monkeypatch.setattr(datasets, "verify_image_label", lambda *a: pytest.fail("cache not used"))
    again = datasets.DetectionDataset(str(images), imgsz=IMGSZ, num_cls=5)
    assert again.im_files == pds.im_files


@pytest.mark.parametrize("fault", ["truncated", "crc", "no-iend"])
def test_damaged_png_is_dropped_like_jax(dataset_dir, tmp_path, fault):
    """A PNG cut at half its bytes, one with a flipped bit inside IDAT (a bad
    CRC) and one cut just before IEND: both packages' verify_image_label drop
    each, and the datasets keep the same files."""
    images = fresh_copy(dataset_dir, tmp_path / "d")
    data = bytearray((images / "00003.png").read_bytes())
    if fault == "truncated":
        data = data[: len(data) // 2]
    elif fault == "crc":
        data[60] ^= 1  # inside the first IDAT chunk's data: its CRC no longer matches
    else:
        data = data[:-12]  # the IEND chunk is gone
    (images / "zz_damaged.png").write_bytes(bytes(data))
    shutil.copy(images.parent.parent / "labels/train/00003.txt", images.parent.parent / "labels/train/zz_damaged.txt")
    lb_file = str(images.parent.parent / "labels/train/zz_damaged.txt")
    got, want = (mod.verify_image_label(str(images / "zz_damaged.png"), lb_file, 5)
                 for mod in (datasets, jax_datasets))
    assert got[0] is None and want[0] is None and got[2] and want[2]
    assert "zz_damaged.png" in got[2]
    assert datasets.verify_image_label(str(images / "00003.png"), lb_file, 5)[2] is None
    pds = datasets.DetectionDataset(str(images), imgsz=IMGSZ, num_cls=5)
    for f in images.parent.parent.rglob("*.cache.npz"):
        f.unlink()
    jds = jax_datasets.DetectionDataset(str(images), imgsz=IMGSZ, num_cls=5)
    assert pds.im_files == jds.im_files and len(pds) == 12


def test_ram_and_disk_image_cache(dataset_dir, tmp_path):
    images = fresh_copy(dataset_dir, tmp_path / "d")
    plain = datasets.DetectionDataset(str(images), imgsz=IMGSZ, num_cls=5)
    for mode in ("ram", "disk"):
        cached = datasets.DetectionDataset(str(images), imgsz=IMGSZ, num_cls=5, cache_images=mode)
        assert cached.cache_mode == mode
        for i in range(len(plain)):
            assert_samples_equal(plain[i], cached[i], 0)


def test_check_dataset(dataset_dir, tmp_path):
    from yolov3_tpu.data.dataset_yaml import check_dataset as jax_check_dataset

    got, want = check_dataset(dataset_dir / "dataset.yaml"), jax_check_dataset(str(dataset_dir / "dataset.yaml"))
    assert got == want and got["nc"] == 5 and got["names"][4] == "cross"
    with pytest.raises(NotImplementedError, match="clearml"):
        check_dataset("clearml://abc")
    missing = {"path": str(tmp_path), "train": "images", "val": "nowhere", "names": ["a"]}
    with pytest.raises(FileNotFoundError):
        check_dataset(missing)
    with pytest.raises(NotImplementedError, match="download"):
        check_dataset({**missing, "download": "https://example.invalid/x.zip"})


def test_shard_per_host_is_not_ported(dataset_dir):
    loader = datasets.DataLoader(datasets.DetectionDataset(str(dataset_dir / "images/train"), imgsz=IMGSZ,
                                                           num_cls=5))
    with pytest.raises(NotImplementedError, match="item 8"):
        loader.shard_per_host()


def test_synthetic_dataset_layout(tmp_path):
    data = synthetic.generate(tmp_path / "s", n_images=3, imgsz=64, seed=0, n_val=2)
    assert data["train"] == "images/train" and data["val"] == "images/val"
    for split, n in (("train", 3), ("val", 2)):
        ims = sorted((tmp_path / "s/images" / split).glob("*.png"))
        assert len(ims) == n
        for f in ims:
            lb = np.loadtxt(tmp_path / "s/labels" / split / f"{f.stem}.txt", ndmin=2)
            assert lb.shape[1] == 5 and (lb[:, 0] < 5).all() and (lb[:, 1:] > 0).all() and (lb[:, 1:] <= 1).all()
    assert yaml.safe_load((tmp_path / "s/dataset.yaml").read_text())["names"][0] == "circle"
