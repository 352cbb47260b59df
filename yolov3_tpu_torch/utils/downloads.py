"""Downloads (yolov3_tpu/utils/downloads.py): `safe_download`, `download`
and `attempt_download`, with the standard library's urllib, a curl retry,
and archive extraction through zipfile / tarfile.

A host without network access gets an error that says so: a failed
download raises (safe_download, attempt_download) or logs one warning per
URL (download), and leaves no partial file. A path that already exists is
never fetched, and `file://` URLs are read like any other, so local
archives go through the same code.
"""

from __future__ import annotations

import gzip
import shutil
import subprocess
import tarfile
import urllib.request
import zipfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from yolov3_tpu_torch.utils.general import LOGGER

RELEASE_URL = "https://github.com/ultralytics/yolov3/releases/download/v9.6.0"
OFFLINE = "offline, or the URL is unreachable"


def _fetch(url, file, timeout=30):
    """Stream `url` to `file` (urlretrieve has no timeout: a filtered network would hang it)."""
    with urllib.request.urlopen(str(url), timeout=timeout) as r, open(file, "wb") as out:
        shutil.copyfileobj(r, out)


def _curl(url, file, retry=3, quiet=False):
    subprocess.run(["curl", "-L", str(url), "-o", str(file), "--retry", str(retry), "-C", "-"], check=True,
                   capture_output=quiet)


def safe_download(file, url, url2=None, min_bytes=1e0, error_msg=""):
    """Download `url` to `file`, retrying with curl (on `url2` when given);
    raises FileNotFoundError when neither gives a file above `min_bytes`."""
    file = Path(file)
    try:
        LOGGER.info(f"Downloading {url} to {file}...")
        _fetch(url, file)
        assert file.exists() and file.stat().st_size > min_bytes
    except Exception as e:  # noqa: BLE001 — any failure goes to the curl retry
        file.unlink(missing_ok=True)
        LOGGER.warning(f"Download failure ({e}), retrying with curl {url2 or url}")
        try:
            _curl(url2 or url, file)
        except Exception as e2:  # noqa: BLE001
            file.unlink(missing_ok=True)
            raise FileNotFoundError(f"{error_msg or url} download failed ({OFFLINE}): {e2}") from e2
    if not (file.exists() and file.stat().st_size > min_bytes):
        file.unlink(missing_ok=True)
        raise FileNotFoundError(error_msg or f"{url} produced an empty file")
    return file


def extract_archive(f, dir):
    """Unpack a zip, tar(.gz) or .gz into `dir`; tar members are filtered as
    data (no absolute paths, no '..', no links out of `dir`), and zipfile
    drops such parts of member names itself."""
    LOGGER.info(f"Unzipping {f}...")
    if zipfile.is_zipfile(f):
        with zipfile.ZipFile(f) as z:
            z.extractall(dir)
    elif tarfile.is_tarfile(f):
        with tarfile.open(f) as t:
            t.extractall(dir, filter="data")
    elif f.suffix == ".gz":
        with gzip.open(f, "rb") as src, open(f.with_suffix(""), "wb") as dst:
            shutil.copyfileobj(src, dst)


def download(urls, dir=".", unzip=True, delete=True, curl=False, threads=1, retry=3):
    """Fetch URLs into `dir` and unpack .zip / .tar / .gz / .tgz archives
    there (reference utils/general.py:490-534). A local file is not fetched:
    it is unpacked into `dir` and kept. A URL that fails `retry` + 1 times
    logs a warning and is skipped; `delete` removes a fetched archive after
    unpacking it."""
    dir = Path(dir)
    dir.mkdir(parents=True, exist_ok=True)

    def one(url):
        local = Path(str(url)).is_file()
        f = Path(str(url)) if local else dir / Path(str(url)).name
        if not local:
            for i in range(retry + 1):
                try:
                    if curl:
                        _curl(url, f, retry=2, quiet=threads > 1)
                    else:
                        LOGGER.info(f"Downloading {url} to {f}...")
                        _fetch(url, f)
                    assert f.is_file() and f.stat().st_size > 0
                    break
                except Exception as e:  # noqa: BLE001
                    f.unlink(missing_ok=True)
                    if i >= retry:
                        LOGGER.warning(f"Failed to download {url} ({OFFLINE}): {e}")
                        return
                    LOGGER.warning(f"Download failure, retrying {i + 1}/{retry} {url}...")
        if unzip and f.is_file() and f.suffix in (".zip", ".tar", ".gz", ".tgz"):
            extract_archive(f, dir)
            if delete and not local:
                f.unlink()

    urls = [urls] if isinstance(urls, (str, Path)) else list(urls)
    if threads > 1:
        with ThreadPoolExecutor(threads) as pool:
            list(pool.map(one, urls))
    else:
        for u in urls:
            one(u)


def attempt_download(file, repo_url=None):
    """The path of `file`; a missing `.pt` is fetched from the reference's
    release assets (`repo_url`/<name>, RELEASE_URL by default) first.
    Anything else missing raises FileNotFoundError."""
    file = Path(str(file).strip().replace("'", ""))
    if file.exists():
        return str(file)
    if file.suffix == ".pt":
        file.parent.mkdir(parents=True, exist_ok=True)
        return str(safe_download(file, f"{repo_url or RELEASE_URL}/{file.name}", min_bytes=1e5,
                                 error_msg=f"{file.name} not found locally and"))
    raise FileNotFoundError(f"{file} does not exist")
