"""Sweep of the candidate-score kernel's ring (yolov3_tpu_torch/csrc/score.cu) on one CUDA card.

    python3 scripts/k2_sweep.py            # from the repo root, with the card

Builds variants of csrc/score.cu by substituting its STAGES and THREADS
constants, plus two ablations of the shipped form (2 stages, 192 threads):
"no row scan" (each row reads one class logit: the copies and the pipeline
alone) and "no evict-first" (bulk copies without the L2 policy). Each variant
is compiled with the package's nvcc flags (one nvcc per variant, all at once)
into a scratch directory, loaded with ctypes and launched through the same C
entry point as the wrapper, at several tile sizes (cells per tile). For each:
device ms at yolov3@640's 80x80 scale (batch 32, bf16) and for the three
scales, by torch.profiler, and whether the class args equal the plain
version's. Beside them, two read-bandwidth yardsticks on the 80x80 head:
torch.amax and clone. Prints one line per row and the card's name and power
limit; send the output to a file when it runs through a tool that keeps only
its end.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from yolov3_tpu_torch.ops import cuda_build, score_cuda  # noqa: E402

SHIPPED = ("constexpr int THREADS = 192;", "constexpr int STAGES = 2;")
# (label, STAGES, THREADS, cells per tile)
RINGS = (("4 stages, 128 threads", 4, 128, (16, 24, 32, 48)),
         ("3 stages, 128 threads", 3, 128, (32, 64)),
         ("2 stages, 128 threads", 2, 128, (32, 64, 96)),
         ("2 stages, 192 threads (shipped)", 2, 192, (32, 64, 96)),
         ("2 stages, 256 threads", 2, 256, (64, 128)))


def variant_sources(src):
    threads_line, stages_line = SHIPPED
    scan = "Best b = row_argmax<T>(row + 5 * sizeof(T), nc);"
    hinted = "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint [%0], [%1], %2, [%3], %4;"
    missing = [line for line in (threads_line, stages_line, scan, hinted) if line not in src]
    if missing:
        raise RuntimeError(f"csrc/score.cu no longer has the lines this sweep edits: {missing}")
    out = {}
    for label, stages, threads, cells in RINGS:
        text = src.replace(threads_line, f"constexpr int THREADS = {threads};").replace(
            stages_line, f"constexpr int STAGES = {stages};")
        out[label] = (text, cells, True)
    out["no row scan (ablation)"] = (
        src.replace(scan, "Best b = {to_float(*reinterpret_cast<const T*>(row + 5 * sizeof(T))), 0};"), (64,), False)
    out["no evict-first (ablation)"] = (
        src.replace(hinted, "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"),
        (64,), True)
    return out


def build(variants, scratch):
    procs = {}
    for i, (label, (text, _, _)) in enumerate(variants.items()):
        cu = scratch / f"score_{i}.cu"
        cu.write_text(text)
        procs[label] = (cu.with_suffix(".so"), subprocess.Popen(
            [cuda_build.nvcc(), cuda_build.ARCH, *cuda_build.FLAGS, str(cu), "-o", str(cu.with_suffix(".so"))],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for label, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{label}: nvcc failed\n{log}")
        lib = ctypes.CDLL(str(so))
        lib.masked_scores_launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_void_p]
        lib.masked_scores_launch.restype = ctypes.c_int
        libs[label] = lib
    return libs


def main():
    if not torch.cuda.is_available():
        print("k2_sweep: needs a CUDA card", file=sys.stderr)
        return 1
    variants = variant_sources((cuda_build.CSRC / "score.cu").read_text())
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(variants, Path(tmp))
        heads = chip_smoke.make_heads(np.random.default_rng(0), [(32, m, torch.bfloat16, 0) for m in chip_smoke.SCORE_CELLS])
        outs = [(torch.empty(f.shape[0], f.shape[1] * 3, device="cuda"),
                 torch.empty(f.shape[0], f.shape[1] * 3, device="cuda", dtype=torch.int32)) for f in heads]
        want = [score_cuda.masked_scores_plain(f, 3, 85, 0.25)[1] for f in heads]
        mb = heads[0].numel() * 2 / 1e6

        def launch(lib, i, cells):
            f, (s, a) = heads[i], outs[i]
            err = lib.masked_scores_launch(f.data_ptr(), s.data_ptr(), a.data_ptr(), f.shape[0] * f.shape[1], 3, 85,
                                           0, cells, 0.25, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"launch failed: cudaError {err}")

        for label, (_, cells_list, exact) in variants.items():
            lib = libs[label]
            for cells in cells_list:
                for i in range(3):
                    launch(lib, i, cells)
                torch.cuda.synchronize()
                equal = all(torch.equal(outs[i][1], want[i]) for i in range(3))
                if exact and not equal:
                    raise RuntimeError(f"{label}, {cells} cells: class args differ from the plain version")
                t80 = chip_smoke.device_ms(lambda: launch(lib, 0, cells), chip_smoke.SCORE_KERNEL, iters=30)
                t3 = chip_smoke.device_ms(lambda: [launch(lib, i, cells) for i in range(3)], chip_smoke.SCORE_KERNEL,
                                          iters=30, per_call=3)
                print(f"{label}, {cells} cells ({cells * 510} B a tile): args equal {equal}; 80x80 {t80:.4f} ms "
                      f"({mb / t80 / 1e3:.2f} TB/s of input), 3 scales {t3:.4f} ms", flush=True)
    f = heads[0]
    t_amax = chip_smoke.device_ms(lambda: torch.amax(f), "reduce", iters=30)
    t_clone = chip_smoke.device_ms(lambda: f.clone(), ("copy", "elementwise", "Memcpy"), iters=30)
    print(f"yardsticks on the 80x80 head ({mb:.1f} MB): torch.amax {t_amax:.4f} ms ({mb / t_amax / 1e3:.2f} TB/s), "
          f"clone {t_clone:.4f} ms ({2 * mb / t_clone / 1e3:.2f} TB/s read + write)", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
