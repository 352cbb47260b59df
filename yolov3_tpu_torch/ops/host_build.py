"""Build csrc/host_ops.cpp with the system C++ compiler and load it.

The host image ops (data/image_ops.py) are C++ with a plain C interface,
compiled on first use into `_build/libhost_ops-<hash>.so` (the hash covers
the source, the flags, the compiler's version and the machine) and loaded
with ctypes. There is no fallback: if the compiler is missing or the build
fails, `load()` raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading

from yolov3_tpu_torch.ops.cuda_build import BUILD_DIR, CSRC

SOURCE = CSRC / "host_ops.cpp"
# no -march=native: the library may be built on one host and run on another;
# -ffp-contract=off: no fused multiply-adds, whose rounding OpenCV's steps do not have
FLAGS = ["-std=c++17", "-O3", "-shared", "-fPIC", "-ffp-contract=off"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def compiler() -> str:
    """$CXX, else c++, else g++ on $PATH."""
    for name in (os.environ.get("CXX"), "c++", "g++"):
        if name and shutil.which(name):
            return shutil.which(name)
    raise RuntimeError("no C++ compiler found ($CXX, c++, g++): the host image ops are built at first use")


def lib_path():
    """The library's path, keyed by the source, the flags, the compiler's version and the machine,
    so a library built on another host (another compiler or libstdc++) is never loaded here."""
    version = subprocess.run([compiler(), "--version"], capture_output=True, text=True).stdout
    key = "\0".join((" ".join(FLAGS), version, platform.machine())).encode()
    h = hashlib.sha256(SOURCE.read_bytes() + key).hexdigest()[:16]
    return BUILD_DIR / f"libhost_ops-{h}.so"


def build():
    """Compile the library if it is not built yet; returns its path."""
    out = lib_path()
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    r = subprocess.run([compiler(), *FLAGS, str(SOURCE), "-o", str(tmp)], capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"host op build failed ({compiler()} exit {r.returncode}):\n{r.stdout}{r.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a library
    return out


def load() -> ctypes.CDLL:
    """The loaded host-op library, built first if need be."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _declare(ctypes.CDLL(str(build())))
        return _lib


def _declare(lib):
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f64p = ctypes.POINTER(ctypes.c_double)
    i = ctypes.c_int
    sig = {
        "resize_linear_u8": [u8p, i, i, i, u8p, i, i],
        "resize_area_u8": [u8p, i, i, i, u8p, i, i],
        "letterbox_u8": [u8p, i, i, i, u8p, i, i, i, i, i, i, u8p],
        "warp_affine_u8": [u8p, i, i, i, u8p, i, i, f64p, u8p],
        "warp_perspective_u8": [u8p, i, i, i, u8p, i, i, f64p, u8p],
        "bgr2hsv_u8": [u8p, u8p, ctypes.c_long],
        "hsv2bgr_u8": [u8p, u8p, ctypes.c_long, i],
        "png_unfilter": [u8p, i, i, i, u8p],
        "png_filter_sub": [u8p, i, i, i, u8p],
        "jpeg_info": [u8p, ctypes.c_long, ctypes.POINTER(i), ctypes.c_char_p, i],
        "jpeg_decode_bgr": [u8p, ctypes.c_long, u8p, ctypes.c_char_p, i],
        "blend_mask_u8": [u8p, i, i, u8p, i, i, i, i, u8p],
        "draw_rect_stamp": [u8p, i, i, u8p, i, i, i, i, i, i, i, u8p],
    }
    for name, args in sig.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int if name in ("png_unfilter", "jpeg_info", "jpeg_decode_bgr") else None
    return lib
