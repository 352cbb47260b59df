"""Build the CUDA sources under yolov3_tpu_torch/csrc/ with nvcc and load them.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled on its own
into `_build/lib<name>-<hash>.so` (the hash covers the source and flags, so
an edited source is rebuilt), then loaded with ctypes. Nothing is built at
import time: `load(name)` builds on first use, and `build_all()` starts one
nvcc per source at once, for a caller that wants the build up front.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]
# per-source flags; nms: exact IEEE f32 IoU, see the note in csrc/nms.cu
EXTRA_FLAGS = {"nms": ["-fmad=false"]}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, /usr/local/cuda/bin, then $PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")
    return found


def _cmd(name: str) -> list[str]:
    return [ARCH, *FLAGS, *EXTRA_FLAGS.get(name, []), str(CSRC / f"{name}.cu")]


def lib_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes() + " ".join(_cmd(name)).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{h}.so"


def sources() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build_all(names=None) -> dict[str, tuple[float, str]]:
    """Compile every named source (default: all of csrc/) that is not built
    yet, one nvcc process each, all started together. Returns
    {name: (seconds, compiler output)}; raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names or sources():
        out = lib_path(name)
        if out.is_file():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (time.perf_counter(), tmp, out, subprocess.Popen(
            [nvcc(), *_cmd(name), "-o", str(tmp)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    done, failed = {}, []
    for name, (t0, tmp, out, proc) in procs.items():
        log, _ = proc.communicate()
        done[name] = (time.perf_counter() - t0, log)
        if proc.returncode:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)  # atomic: a concurrent loader never sees half a library
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return done


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if need be."""
    with _lock:
        if name not in _libs:
            build_all([name])
            _libs[name] = ctypes.CDLL(str(lib_path(name)))
        return _libs[name]
