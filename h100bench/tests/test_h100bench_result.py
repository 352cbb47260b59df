"""The result line, the refusals without a card, and what a run loads."""

import json
import os
import shutil
import subprocess
import sys

import torch

from h100bench_support import small_run
from harness import core

REPO = core.REPO
KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


def test_result_line_has_the_contract_keys():
    run = small_run("yolov3-serve-b32")
    run.check("unmatched", 0.0, 0.1)
    line = core.result(run, {"serve_img_s": 1.5, "setup_s": 2.0}, {"serve_img_s": "img/s", "setup_s": "s"})
    assert set(line) == KEYS and list(line)[-1] == "checks"
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert line["metrics"]["serve_img_s"] == {"value": 1.5, "unit": "img/s"}
    assert line["checks"] == {"unmatched": {"value": 0.0, "limit": 0.1}} and line["correct"] is True
    run.trace_on, run.trace = True, dict(busy_s=0.5, window_s=1.0)
    line = core.result(run, {}, {}, breakdown={"device_ops": [], "idle_gaps": []})
    assert set(line) == KEYS | {"breakdown"} and line["device"]["busy_s"] == 0.5
    run.check("conf_gap", float("nan"), 1.0)
    assert core.result(run, {}, {})["correct"] is False


def _run_py(cwd, env=None):
    return subprocess.run([sys.executable, "h100bench/run.py", "--workload", "yolov3-serve-b32", "--seed", "1",
                           "--seconds", "1", "--trace", "0"], cwd=cwd, capture_output=True, text=True, timeout=300,
                          env=env)


def test_no_card_no_result():
    if torch.cuda.is_available():
        return  # a machine with a card runs the cell instead
    r = _run_py(REPO)
    assert r.returncode == 2 and not r.stdout.strip() and "CUDA" in r.stderr


def test_benchmark_alone_gives_no_result(tmp_path):
    shutil.copytree(REPO / "h100bench", tmp_path / "h100bench", ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    env = dict(os.environ, PYTHONPATH="")
    r = _run_py(tmp_path, env)
    assert r.returncode != 0 and not r.stdout.strip()


def test_a_run_loads_no_jax_and_the_reference_nothing_of_the_port():
    code = ("import sys; sys.path[:0] = ['h100bench', 'h100bench/tests', '.']\n"
            "import reference.model, reference.detect, reference.train, reference.val_metrics\n"
            "assert not [m for m in sys.modules if m.split('.')[0] in ('yolov3_tpu_torch', 'yolov3_tpu', 'jax')]\n"
            "from h100bench_support import small_run, drive\n"
            "from harness import core\n"
            "drive(small_run('yolov3-serve-b32'))\n"
            "print('loaded', core.forbidden_modules())\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == "loaded []"
    assert "yolov3_tpu" in core.FORBIDDEN and "jax" in core.FORBIDDEN


def test_a_workload_file_added_to_a_copy_runs_without_editing_a_file(tmp_path):
    shutil.copytree(REPO / "h100bench", tmp_path / "h100bench", ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    wl = json.loads((REPO / "h100bench/workloads/yolov3-serve-b32.json").read_text())
    wl.update(name="yolov3-tiny-serve-b2", config="yolov3-tiny")
    (tmp_path / "h100bench/workloads/yolov3-tiny-serve-b2.json").write_text(json.dumps(wl))
    bench["workloads"].append(dict(name="yolov3-tiny-serve-b2", config="yolov3-tiny", traffic="batch", chips=1,
                                   why="a cell added as data"))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (f"import sys; sys.path[:0] = ['h100bench', {str(REPO / 'h100bench/tests')!r}, {str(REPO)!r}]\n"
            "from harness import core\n"
            "import h100bench_support as s\n"
            "assert str(core.ROOT).startswith(sys.argv[1])\n"
            "run = s.small_run('yolov3-tiny-serve-b2')\n"
            "s.drive(run)\n"
            "print('ran', sorted(run.e2e), [n for n, _, _ in run.checks])\n")
    r = subprocess.run([sys.executable, "-c", code, str(tmp_path)], cwd=tmp_path, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == "ran ['serve_img_s'] ['unmatched', 'class_flips', 'conf_gap']"
