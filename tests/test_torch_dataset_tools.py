"""The port's dataset tools against the JAX package's, on the CPU: the
converters of data/converters.py on the on-disk fixtures of
tests/test_converters.py (the output trees equal, byte for byte),
`autosplit`, utils/downloads.py on local archives and `file://` URLs, and
the `download:` recipes of check_dataset (a `bash` line, `converter://`
and a URL served from localhost).

No test reaches another host: `urllib.request.urlopen` is wrapped so that
any URL but `file:` and 127.0.0.1 fails the test.
"""

import http.server
import json
import tarfile
import threading
import urllib.request
import zipfile
from pathlib import Path

import cv2
import numpy as np
import pytest

from torch_cores import share_cores  # noqa: F401 — autouse: torch's threads, a worker's share
from yolov3_tpu.data import converters as jax_converters
from yolov3_tpu.data import dataset_yaml as jax_dataset_yaml
from yolov3_tpu.utils import downloads as jax_downloads
from yolov3_tpu_torch.data import converters, dataset_yaml
from yolov3_tpu_torch.utils import downloads


@pytest.fixture(autouse=True)
def local_urls_only(monkeypatch):
    real = urllib.request.urlopen

    def urlopen(url, *a, **k):
        u = url if isinstance(url, str) else url.full_url
        assert u.startswith(("file:", "http://127.0.0.1")), f"a test reached for {u}"
        return real(url, *a, **k)

    monkeypatch.setattr(urllib.request, "urlopen", urlopen)


def tree(root):
    """{relative path: bytes} of every file under root."""
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(Path(root).rglob("*")) if p.is_file()}


def img(path, w, h, value=100):
    path.parent.mkdir(parents=True, exist_ok=True)
    cv2.imwrite(str(path), np.full((h, w, 3), value, np.uint8))


def build_visdrone(root):
    for s in ("VisDrone2019-DET-train", "VisDrone2019-DET-val", "VisDrone2019-DET-test-dev"):
        d = root / s
        img(d / "images" / "0001.jpg", 200, 100)
        img(d / "images" / "0002.jpg", 64, 48)
        (d / "annotations").mkdir(parents=True)
        (d / "annotations" / "0001.txt").write_text("10,20,40,30,1,4,0,0\n0,0,200,100,0,0,0,0\n50,50,100,50,1,1,0,0\n")
        (d / "annotations" / "0002.txt").write_text("1,2,3,4,1,10,0,0\n")


def build_argoverse(root):
    for seq in ("seq-0", "seq-1"):
        img(root / "Argoverse-1.1" / "tracking" / seq / "f0.jpg", 8, 8)
    ann = {"images": [{"name": "f0.jpg", "sid": 0}, {"name": "f0.jpg", "sid": 1}], "seq_dirs": ["seq-0", "seq-1"],
           "annotations": [{"image_id": 0, "category_id": 2, "bbox": [192.0, 120.0, 192.0, 240.0]},
                           {"image_id": 0, "category_id": 5, "bbox": [0.0, 0.0, 1920.0, 1200.0]},
                           {"image_id": 1, "category_id": 1, "bbox": [17.0, 33.0, 101.5, 7.25]}]}
    d = root / "Argoverse-HD" / "annotations"
    d.mkdir(parents=True)
    for s in ("train.json", "val.json"):
        (d / s).write_text(json.dumps(ann))


def build_sku110k(root):
    (root / "annotations").mkdir(parents=True)
    rows = ("im_a.jpg,10,20,110,70,object,200,100\nim_a.jpg,0,0,200,100,object,200,100\n"
            "im_b.jpg,50,25,150,75,object,200,100\nim_c.jpg,1,2,33,44,object,97,131\n")
    for d in ("annotations_train.csv", "annotations_val.csv", "annotations_test.csv"):
        (root / "annotations" / d).write_text(rows)


def build_global_wheat(root):
    for d in ("arvalis_1", "ethz_1", "uq_1"):
        img(root / d / "x.png", 4, 4)
        (root / f"{d}.json").write_text("{}")


def build_xview(root):
    img(root / "train_images" / "100.tif", 100, 50)
    img(root / "train_images" / "101.tif", 33, 17)
    img(root / "val_images" / "200.tif", 10, 10)
    feats = [{"properties": {"bounds_imcoords": "10,10,60,35", "image_id": "100.tif", "type_id": 17}},
             {"properties": {"bounds_imcoords": "0,0,10,10", "image_id": "100.tif", "type_id": 75}},
             {"properties": {"bounds_imcoords": "", "image_id": "100.tif", "type_id": 17}},
             {"properties": {"bounds_imcoords": "0,0,5,5", "image_id": "missing.tif", "type_id": 17}},
             {"properties": {"bounds_imcoords": "-3,2,40,30", "image_id": "101.tif", "type_id": 94}},
             {"properties": {"bounds_imcoords": "1,2,3", "image_id": "101.tif", "type_id": 11}}]
    (root / "xView_train.geojson").write_text(json.dumps({"features": feats}))


def build_objects365(root):
    img(root / "images" / "val" / "patch0" / "img1.jpg", 4, 4)
    img(root / "images" / "val" / "patch1" / "img2.jpg", 4, 4)
    (root / "images" / "train").mkdir(parents=True)
    ann = {"categories": [{"id": 7, "name": "b"}, {"id": 3, "name": "a"}],
           "images": [{"id": 9, "width": 200, "height": 100, "file_name": "patch0/img1.jpg"},
                      {"id": 4, "width": 64, "height": 48, "file_name": "patch1/img2.jpg"}],
           "annotations": [{"image_id": 9, "category_id": 7, "bbox": [10, 20, 100, 50], "iscrowd": 0},
                           {"image_id": 9, "category_id": 3, "bbox": [0, 0, 200, 100], "iscrowd": 0},
                           {"image_id": 9, "category_id": 3, "bbox": [0, 0, 9, 9], "iscrowd": 1},
                           {"image_id": 4, "category_id": 7, "bbox": [-5, 3, 80, 20]}]}
    for s in ("train", "val"):
        (root / f"zhiyuan_objv2_{s}.json").write_text(
            json.dumps(ann if s == "val" else {"categories": [], "images": [], "annotations": []}))


CASES = {"visdrone": build_visdrone, "argoverse": build_argoverse, "sku110k": build_sku110k,
         "global_wheat_2020": build_global_wheat, "xview": build_xview, "objects365": build_objects365}


@pytest.mark.parametrize("name", sorted(CASES))
def test_converter_matches_jax(name, tmp_path):
    """The raw files already on disk (nothing is fetched); the trees after conversion are equal."""
    assert sorted(converters.CONVERTERS) == sorted(jax_converters.CONVERTERS)
    for label in ("jax", "port"):
        CASES[name](tmp_path / label / "ds")
    jax_converters.prepare(name, tmp_path / "jax" / "ds")
    converters.prepare(name, tmp_path / "port" / "ds")
    got, want = tree(tmp_path / "port"), tree(tmp_path / "jax")
    assert got == want
    assert any(k.endswith(".txt") for k in got) or name == "global_wheat_2020"


@pytest.mark.parametrize("name", ["argoverse", "xview"])
def test_converter_missing_data_raises_as_jax(name, tmp_path):
    with pytest.raises(FileNotFoundError, match="manual"):
        converters.prepare(name, tmp_path / "nope")
    with pytest.raises(KeyError, match="unknown dataset converter"):
        converters.prepare("nope", tmp_path)


@pytest.mark.parametrize("weights,seed", [((0.9, 0.1, 0.0), 0), ((0.5, 0.3, 0.2), 1), ((0.8, 0.2, 0.0), 7)])
def test_autosplit_matches_jax(tmp_path, weights, seed):
    for label in ("jax", "port"):
        d = tmp_path / label / "ds" / "images"
        for i in range(23):
            img(d / ("sub" if i % 5 == 0 else "") / f"{i:02d}.{('jpg', 'png', 'bmp')[i % 3]}", 4, 4)
        (d / "notes.txt").write_text("not an image")
    want = jax_converters.autosplit(tmp_path / "jax" / "ds" / "images", weights=weights, seed=seed)
    got = converters.autosplit(tmp_path / "port" / "ds" / "images", weights=weights, seed=seed)
    assert [p.name for p in got] == [p.name for p in want]
    assert tree(tmp_path / "port") == tree(tmp_path / "jax")


def test_image_size_reads_headers_as_cv2(tmp_path):
    for ext, (w, h) in ((".jpg", (37, 21)), (".png", (5, 9)), (".bmp", (8, 3)), (".tif", (11, 7))):
        img(tmp_path / f"a{ext}", w, h)
        assert converters._image_size(tmp_path / f"a{ext}") == jax_converters._image_size(tmp_path / f"a{ext}") == (w, h)


# --- downloads ------------------------------------------------------------------


def archives(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    with zipfile.ZipFile(src / "payload.zip", "w") as z:
        z.writestr("inner/a.txt", "hello")
        z.writestr("inner/b/c.bin", bytes(range(256)))
    with tarfile.open(src / "payload.tar.gz", "w:gz") as t:
        t.add(src / "payload.zip", arcname="nested/payload.zip")
    (src / "plain.txt").write_text("just a file")
    return src


@pytest.mark.parametrize("kind", ["local-zip", "local-tar", "file-url-zip", "file-url-plain", "missing-url"])
def test_download_matches_jax(tmp_path, kind):
    src = archives(tmp_path)
    url = {"local-zip": str(src / "payload.zip"), "local-tar": str(src / "payload.tar.gz"),
           "file-url-zip": (src / "payload.zip").as_uri(), "file-url-plain": (src / "plain.txt").as_uri(),
           "missing-url": (src / "none.zip").as_uri()}[kind]
    for label, fn in (("jax", jax_downloads.download), ("port", downloads.download)):
        fn([url], dir=tmp_path / label, retry=0)
    assert tree(tmp_path / "port") == tree(tmp_path / "jax")
    assert kind == "missing-url" or tree(tmp_path / "port")
    assert sorted(p.name for p in src.iterdir()) == ["payload.tar.gz", "payload.zip", "plain.txt"]  # sources kept


def test_download_refuses_a_path_out_of_the_directory(tmp_path):
    evil = tmp_path / "evil.tar"
    with tarfile.open(evil, "w") as t:
        info = tarfile.TarInfo("../outside.txt")
        info.size = 3
        import io

        t.addfile(info, io.BytesIO(b"bad"))
    for label, fn in (("jax", jax_downloads.download), ("port", downloads.download)):
        with pytest.raises(tarfile.OutsideDestinationError):
            fn([str(evil)], dir=tmp_path / label / "d")
    assert not list(tmp_path.rglob("outside.txt"))


def test_safe_and_attempt_download_offline(tmp_path):
    src = archives(tmp_path)
    for label, mod in (("jax", jax_downloads), ("port", downloads)):
        (tmp_path / label).mkdir()
        f = mod.safe_download(tmp_path / label / "p.zip", (src / "payload.zip").as_uri())
        assert Path(f).read_bytes() == (src / "payload.zip").read_bytes()
        with pytest.raises(FileNotFoundError, match="download failed"):
            mod.safe_download(tmp_path / label / "q.zip", (src / "none.zip").as_uri())
        assert not (tmp_path / label / "q.zip").exists()
        assert mod.attempt_download(src / "plain.txt") == str(src / "plain.txt")
        with pytest.raises(FileNotFoundError, match="does not exist"):
            mod.attempt_download(tmp_path / "missing.yaml")
        with pytest.raises(FileNotFoundError, match="not found locally and download failed"):
            mod.attempt_download(tmp_path / label / "w" / "yolov3.pt", repo_url=(src / "releases").as_uri())
    with pytest.raises(FileNotFoundError, match="offline"):
        downloads.safe_download(tmp_path / "r.zip", (src / "none.zip").as_uri())


# --- check_dataset's download recipes -----------------------------------------


@pytest.fixture
def served(tmp_path):
    """A localhost HTTP server of tmp_path/www (a dataset zip); yields its base URL."""
    www = tmp_path / "www"
    www.mkdir()
    with zipfile.ZipFile(www / "tiny.zip", "w") as z:
        z.writestr("tiny/images/val/a.txt", "x")
        z.writestr("tiny/images/train/b.txt", "y")

    class Quiet(http.server.SimpleHTTPRequestHandler):
        def __init__(self, *a, **k):
            super().__init__(*a, directory=str(www), **k)

        def log_message(self, *a):
            pass

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Quiet)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        yield f"http://127.0.0.1:{srv.server_address[1]}"
    finally:
        srv.shutdown()
        srv.server_close()


@pytest.mark.parametrize("recipe", ["bash", "url", "converter"])
def test_download_recipes_match_jax(tmp_path, monkeypatch, served, recipe):
    def fake(root):
        img(Path(root) / "images" / "val" / "a.jpg", 4, 4)

    monkeypatch.setitem(jax_converters.CONVERTERS, "fake_ds", fake)
    monkeypatch.setitem(converters.CONVERTERS, "fake_ds", fake)
    out = {}
    for label, check in (("jax", jax_dataset_yaml.check_dataset), ("port", dataset_yaml.check_dataset)):
        root = tmp_path / label / "tiny"
        s = {"bash": f"bash -c 'mkdir -p {root}/images/val'", "url": f"{served}/tiny.zip",
             "converter": "converter://fake_ds"}[recipe]
        data = {"path": str(root), "train": "images/val", "val": "images/val", "names": ["x"], "download": s}
        d = check(data)
        out[label] = (Path(d["val"]).relative_to(tmp_path / label), d["nc"], tree(tmp_path / label))
    assert out["port"] == out["jax"] and Path(out["port"][0]).parts[-2:] == ("images", "val")


def test_download_recipe_refusals(tmp_path):
    data = {"path": str(tmp_path / "d"), "train": "images", "val": "images", "names": ["x"]}
    for check in (jax_dataset_yaml.check_dataset, dataset_yaml.check_dataset):
        with pytest.raises(ValueError, match="python exec recipes are not supported"):
            check({**data, "download": "import os; os.system('true')"})
        with pytest.raises(FileNotFoundError, match="no download recipe"):
            check({**data, "download": "bash -c true"}, autodownload=False)
        with pytest.raises(FileNotFoundError, match="did not produce"):
            check({**data, "download": "bash -c true"})
