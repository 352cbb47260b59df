"""Inference sources for detect: image files, directories, globs and lists
(`LoadImages`), video files, webcam / RTSP streams and the screen
(yolov3_tpu/data/loaders.py:27-202). Each yields (path,
letterboxed RGB uint8 HWC image, original BGR image, video capture,
status string).

Images are decoded by data/image_ops.py (JPEG, PNG and BMP without any
library). Video files, `LoadStreams` and `LoadScreenshots` need OpenCV
(cv2) or mss, imported when such a source is opened; without it they raise,
naming the package.
"""

from __future__ import annotations

import glob
import math
import os
import time
from pathlib import Path
from threading import Thread

import numpy as np

from yolov3_tpu_torch.data import image_ops
from yolov3_tpu_torch.data.augment import letterbox
from yolov3_tpu_torch.data.datasets import IMG_FORMATS
from yolov3_tpu_torch.utils.general import LOGGER, clean_str

VID_FORMATS = ("asf", "avi", "gif", "m4v", "mkv", "mov", "mp4", "mpeg", "mpg", "ts", "wmv")


def _import(package, what):
    """cv2 or mss, imported for a source that needs it."""
    try:
        return __import__(package)
    except ImportError:
        pip = {"cv2": "opencv-python"}.get(package, package)
        raise RuntimeError(f"{what} needs the '{package}' package ({pip}), which is not installed; "
                           "images are read without it") from None


class LoadImages:
    """Iterate over image files, directories, globs, lists of them, a .txt
    file listing them, and video files."""

    def __init__(self, path, img_size=640, stride=32, auto=True, vid_stride=1):
        if isinstance(path, str) and Path(path).suffix == ".txt":  # a list of sources
            path = Path(path).read_text().split()
        files = []
        for p in sorted(path) if isinstance(path, (list, tuple)) else [path]:
            p = str(Path(p).resolve())
            if "*" in p:
                files.extend(sorted(glob.glob(p, recursive=True)))
            elif os.path.isdir(p):
                files.extend(sorted(glob.glob(os.path.join(p, "*.*"))))
            elif os.path.isfile(p):
                files.append(p)
            else:
                raise FileNotFoundError(f"{p} does not exist")

        images = [x for x in files if x.split(".")[-1].lower() in IMG_FORMATS]
        videos = [x for x in files if x.split(".")[-1].lower() in VID_FORMATS]
        self.img_size = img_size
        self.stride = stride
        self.files = images + videos
        self.nf = len(images) + len(videos)
        self.video_flag = [False] * len(images) + [True] * len(videos)
        self.mode = "image"
        self.auto = auto
        self.vid_stride = vid_stride
        self.cap = None
        if videos:
            self._new_video(videos[0])
        assert self.nf > 0, f"No images or videos found in {path}"

    def __iter__(self):
        self.count = 0
        return self

    def __next__(self):
        if self.count == self.nf:
            raise StopIteration
        path = self.files[self.count]

        if self.video_flag[self.count]:
            self.mode = "video"
            for _ in range(self.vid_stride):
                self.cap.grab()
            ret, im0 = self.cap.retrieve()
            while not ret:
                self.count += 1
                self.cap.release()
                if self.count == self.nf:
                    raise StopIteration
                path = self.files[self.count]
                self._new_video(path)
                ret, im0 = self.cap.read()
            self.frame += 1
            s = f"video {self.count + 1}/{self.nf} ({self.frame}/{self.frames}) {path}: "
        else:
            self.count += 1
            im0 = image_ops.imread(path)
            s = f"image {self.count}/{self.nf} {path}: "

        im = letterbox(im0, self.img_size, stride=self.stride, auto=self.auto)[0]
        im = np.ascontiguousarray(im[:, :, ::-1])  # BGR->RGB, HWC uint8
        return path, im, im0, self.cap, s

    def _new_video(self, path):
        cv2 = _import("cv2", f"reading the video {path}")
        self.frame = 0
        self.cap = cv2.VideoCapture(path)
        self.frames = max(int(self.cap.get(cv2.CAP_PROP_FRAME_COUNT) / self.vid_stride), 0)

    def __len__(self):
        return self.nf


class LoadStreams:
    """Webcam ids, RTSP/HTTP URLs and .streams files, one reader thread per
    source (needs cv2)."""

    def __init__(self, sources="0", img_size=640, stride=32, auto=True, vid_stride=1):
        cv2 = _import("cv2", "reading a stream")
        self._cv2 = cv2
        self.mode = "stream"
        self.img_size = img_size
        self.stride = stride
        self.vid_stride = vid_stride
        if Path(sources).is_file() and Path(sources).suffix == ".streams":
            sources = Path(sources).read_text().rsplit()
        else:
            sources = [sources]
        n = len(sources)
        self.sources = [clean_str(x) for x in sources]
        self.imgs, self.fps, self.frames, self.threads = [None] * n, [0] * n, [0] * n, [None] * n
        self.auto = auto
        for i, s in enumerate(sources):
            cap = cv2.VideoCapture(int(s) if s.isnumeric() else s)
            assert cap.isOpened(), f"Failed to open {s}"
            w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
            h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
            fps = cap.get(cv2.CAP_PROP_FPS)
            self.frames[i] = max(int(cap.get(cv2.CAP_PROP_FRAME_COUNT)), 0) or float("inf")
            self.fps[i] = max((fps if math.isfinite(fps) else 0) % 100, 0) or 30
            _, self.imgs[i] = cap.read()
            self.threads[i] = Thread(target=self._update, args=(i, cap, s), daemon=True)
            LOGGER.info(f"stream {i + 1}/{n} {s}: {w}x{h} at {self.fps[i]:.2f} FPS")
            self.threads[i].start()

    def _update(self, i, cap, stream):
        n, f = 0, self.frames[i]
        while cap.isOpened() and n < f:
            n += 1
            cap.grab()
            if n % self.vid_stride == 0:
                ok, im = cap.retrieve()
                if ok:
                    self.imgs[i] = im
                else:  # signal loss: reconnect
                    LOGGER.warning(f"video stream {stream} unresponsive; attempting reopen")
                    self.imgs[i] = np.zeros_like(self.imgs[i])
                    cap.open(stream)
            time.sleep(0.0)

    def __iter__(self):
        self.count = -1
        return self

    def __next__(self):
        self.count += 1
        if not all(t.is_alive() for t in self.threads) or self._cv2.waitKey(1) == ord("q"):
            self._cv2.destroyAllWindows()
            raise StopIteration
        im0 = [x.copy() for x in self.imgs]
        im = np.stack([np.ascontiguousarray(letterbox(x, self.img_size, stride=self.stride, auto=self.auto)[0]
                                            [:, :, ::-1]) for x in im0])
        return self.sources, im, im0, None, ""

    def __len__(self):
        return len(self.sources)


class LoadScreenshots:
    """Screen capture through mss: 'screen [N [l t w h]]'."""

    def __init__(self, source, img_size=640, stride=32, auto=True):
        mss = _import("mss", "capturing the screen")
        source, *params = source.split()
        self.screen, left, top, width, height = 0, None, None, None, None
        if len(params) == 1:
            self.screen = int(params[0])
        elif len(params) == 4:
            left, top, width, height = (int(x) for x in params)
        elif len(params) == 5:
            self.screen, left, top, width, height = (int(x) for x in params)
        self.img_size = img_size
        self.stride = stride
        self.auto = auto
        self.mode = "stream"
        self.frame = 0
        self.sct = mss.mss()
        monitor = self.sct.monitors[self.screen]
        self.top = monitor["top"] if top is None else monitor["top"] + top
        self.left = monitor["left"] if left is None else monitor["left"] + left
        self.width = width or monitor["width"]
        self.height = height or monitor["height"]
        self.monitor = {"left": self.left, "top": self.top, "width": self.width, "height": self.height}

    def __iter__(self):
        return self

    def __next__(self):
        im0 = np.array(self.sct.grab(self.monitor))[:, :, :3]
        s = f"screen {self.screen} (LTWH): {self.left},{self.top},{self.width},{self.height}: "
        im = letterbox(im0, self.img_size, stride=self.stride, auto=self.auto)[0]
        im = np.ascontiguousarray(im[:, :, ::-1])
        self.frame += 1
        return str(self.screen), im, im0, None, s
