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


def test_a_four_level_configuration_added_to_a_copy_runs_without_editing_a_file(tmp_path):
    from h100bench_support import YOLOV5X6

    shutil.copytree(REPO / "h100bench", tmp_path / "h100bench", ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    source = "https://github.com/ultralytics/yolov5/blob/master/models/hub/yolov5x6.yaml"
    config = dict(name="yolov5x6", source=source, nc=80, imgsz=1280, params=140794780, reduced=[], model=YOLOV5X6)
    (tmp_path / "h100bench/configs/yolov5x6.json").write_text(json.dumps(config))
    wl = json.loads((REPO / "h100bench/workloads/yolov3-serve-b32.json").read_text())
    # the narrow model's own limits, from CPU runs at 128 px: its bf16 serving read unmatched 0.007-0.019 and
    # class_flips 0.118-0.151 on seeds 1-6, the fp8 control 0.50-0.67 and 0.72-0.75 on seeds 7-8; the widest
    # conf gap (0.31-0.73 against 0.73-0.75) separates nothing at 16-24 channels and is not compared
    wl.update(name="yolov5x6-serve-b2", config="yolov5x6", k_per_scale=[512, 256, 128, 64],
              plant_targets={"8": 224.0, "16": 56.0, "32": 20.0, "64": 6.0},
              check={"unmatched": 0.1, "class_flips": 0.35})
    (tmp_path / "h100bench/workloads/yolov5x6-serve-b2.json").write_text(json.dumps(wl))
    bench["configs"].append(dict(name="yolov5x6", source=source, file="h100bench/configs/yolov5x6.json", reduced=[],
                                 why="a P6 configuration added as data"))
    bench["workloads"].append(dict(name="yolov5x6-serve-b2", config="yolov5x6", traffic="batch", chips=1,
                                   why="a four-level cell added as data"))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (f"import sys; sys.path[:0] = ['h100bench', {str(REPO / 'h100bench/tests')!r}, {str(REPO)!r}]\n"
            "from harness import core\n"
            "from reference.model import Net\n"
            "import h100bench_support as s\n"
            "assert str(core.ROOT).startswith(sys.argv[1])\n"
            "run = s.small_run('yolov5x6-serve-b2')\n"
            "m = run.workload['model']\n"
            "run.workload['imgsz'] = s.frame_size(m)\n"
            "s.drive(run)\n"
            "print('ran', Net(m).strides, run.correct, sorted(run.e2e), [n for n, _, _ in run.checks])\n")
    r = subprocess.run([sys.executable, "-c", code, str(tmp_path)], cwd=tmp_path, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == \
        "ran (8, 16, 32, 64) True ['serve_img_s'] ['unmatched', 'class_flips']"
