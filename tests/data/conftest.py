"""Builds the JAX package's native library (yolov3_tpu/native) once, under a
file lock, before any test module is imported: pytest collects this
directory ahead of the test files beside it.

yolov3_tpu/native compiles its library at first use, in place, and
tests/test_native.py asks for it while the module is imported. Under
pytest-xdist every worker imports every test module, so several workers
compiled it at the same moment, and a worker could load the file while
another worker's linker was rewriting it: that worker found no library and
skipped all of tests/test_native.py ("no C++ toolchain"). Six processes
started together on an empty build directory lost that race 26 times in 90.
With the lock, one worker compiles and the others load its result.

The fix depends on that order: it holds for a run over tests/ (as
`pytest tests/ -n 6`), where this directory is collected before
test_native.py, but not for `pytest tests/test_native.py -n 6` alone, which
never collects it and can still race. The fault is the JAX package's
(its library is written in place, not renamed into place, ROADMAP queue 3);
this file can go once yolov3_tpu/native is fixed.
"""

import fcntl
from pathlib import Path

from yolov3_tpu import native

_BUILD_DIR = Path(native.__file__).resolve().parent / "_build"
_BUILD_DIR.mkdir(exist_ok=True)
with open(_BUILD_DIR / "build.lock", "w") as _lock:
    fcntl.flock(_lock, fcntl.LOCK_EX)
    native.available()
