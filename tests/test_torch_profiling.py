"""The port's profiling (utils/profiling.py) against the JAX package's on the
same weights: yolov3-tiny at width 0.25 (and full width where cheap), 64 px.

FLOPs. The port counts with torch's FlopCounterMode: 2 per multiply-add of
every tap of every convolution, and nothing else (thop's count, which the
reference prints). The JAX package reads XLA's cost analysis, which counts
only a padded convolution's in-bounds taps and adds the elementwise work
(BatchNorm, activations, pooling). So the two are not equal:
- the port's count equals the analytic 2 * k*k * Cin/groups * Cout * Hout *
  Wout summed over the convolutions, exactly;
- against XLA, a 1x1 convolution and the Detect head agree within 6% (only
  the elementwise work differs); at 64 px the 3x3 convolutions on 2x2 maps
  see 4 of 9 taps in bounds, so there the port counts 2.25x; the narrow
  model's total is 1.30x XLA's, held to [1.0, 1.35].
Parameters per layer equal the JAX rows exactly and sum to num_params(),
fused and unfused. Pruning zeroes the same weights as JAX's `prune`.
"""

import jax
import pytest
import torch
import yaml

from yolov3_tpu.models.detection import DetectionModel as JaxModel
from yolov3_tpu.utils import profiling as jax_profiling
from torch_cores import share_cores  # noqa: F401 — autouse: torch's threads, a worker's share
from yolov3_tpu_torch.models import detection
from yolov3_tpu_torch.models.convert import load_jax_variables
from yolov3_tpu_torch.models.detection import DetectionModel
from yolov3_tpu_torch.models.spec import parse_spec
from yolov3_tpu_torch.utils import profiling
from yolov3_tpu_torch.utils.general import ROOT

IMGSZ = 64


def tiny_cfg(width=0.25):
    d = yaml.safe_load((ROOT / "yolov3_tpu/models/configs/yolov3-tiny.yaml").read_text())
    return dict(d, width_multiple=width)


@pytest.fixture(scope="module")
def models():
    cfg = tiny_cfg()
    ref = JaxModel.from_config(cfg, key=jax.random.PRNGKey(0), imgsz=IMGSZ)
    return ref, load_jax_variables(DetectionModel(parse_spec(cfg)).eval(), ref.variables)


def analytic_conv_flops(model, imgsz):
    """2 * MACs of every tap of every Conv2d in one forward at imgsz."""
    total = []

    def hook(m, _x, y):
        total.append(2 * m.out_channels * m.in_channels // m.groups * m.kernel_size[0] * m.kernel_size[1]
                     * y.shape[0] * y.shape[2] * y.shape[3])

    hooks = [m.register_forward_hook(hook) for m in model.modules() if isinstance(m, torch.nn.Conv2d)]
    with torch.no_grad():
        model(torch.zeros(1, imgsz, imgsz, 3))
    for h in hooks:
        h.remove()
    return float(sum(total))


def test_model_flops_against_xla(models):
    ref, model = models
    got, want = profiling.model_flops(model, IMGSZ), jax_profiling.model_flops(ref, IMGSZ)
    assert got == analytic_conv_flops(model, IMGSZ)
    print(f"port {got:.0f} FLOPs, XLA {want:.0f} ({got / want:.4f}x)")
    assert 1.0 <= got / want <= 1.35
    full = DetectionModel.from_config("yolov3-tiny", device="cpu")
    assert profiling.model_flops(full, IMGSZ) == analytic_conv_flops(full, IMGSZ)


def test_profile_layers_against_jax(models):
    ref, model = models
    rows = profiling.profile_layers(model, imgsz=IMGSZ, batch=1, reps=1)
    want = jax_profiling.profile_layers(ref, imgsz=IMGSZ, batch=1, reps=1)
    assert [(r["i"], r["op"], r["params"]) for r in rows] == [(w["i"], w["op"], w["params"]) for w in want]
    assert sum(r["params"] for r in rows) == model.num_params() == ref.num_params()
    assert sum(r["gflops"] for r in rows) * 1e9 == pytest.approx(profiling.model_flops(model, IMGSZ))
    for r, w, ls in zip(rows, want, model.spec.layers):
        assert r["ms"] > 0
        if ls.op == "Detect" or (ls.op == "Conv" and ls.args[1] == 1):
            assert r["gflops"] == pytest.approx(w["gflops"], rel=0.06), ls
    assert rows[-1]["out"] == [(1, 3, 4, 4, 85), (1, 3, 2, 2, 85)]
    fused = model.fuse()
    rows_f = profiling.profile_layers(fused, imgsz=IMGSZ, batch=1, reps=1)
    assert len(rows_f) == len(model.spec.layers) and sum(r["params"] for r in rows_f) == fused.num_params()


def test_line_profile_cli(monkeypatch):
    lines = []
    monkeypatch.setattr(profiling.LOGGER, "info", lambda msg, *a, **k: lines.append(msg))
    detection._main(["--cfg", "yolov3-tiny", "--imgsz", "64", "--line-profile", "--device", "cpu"])
    assert lines[0].startswith("yolov3-tiny summary: 21 layers, 8,852,366 parameters")
    assert sum(ln.split()[0].isdigit() for ln in lines) == 21 and lines[-1].split()[0] == "total"


def test_model_info_and_memory(models):
    _, model = models
    info = profiling.model_info(model, IMGSZ)
    assert info == {"params": model.num_params(), "gflops": profiling.model_flops(model, IMGSZ) / 1e9}
    with pytest.raises(ValueError, match="CUDA"):  # the peak of the card's memory: no card on the CPU
        profiling.model_memory_bytes(model, 8, IMGSZ)


def test_prune_equals_jax(models):
    ref, model = models
    pruned, sparsity = jax_profiling.prune(ref.variables["params"], amount=0.3)
    model = load_jax_variables(DetectionModel(model.spec).eval(), ref.variables)
    got = profiling.prune(model, amount=0.3)
    assert 0.25 < got < 0.35 and got == pytest.approx(sparsity, abs=1e-12)
    want = load_jax_variables(DetectionModel(model.spec).eval(), {**ref.variables, "params": pruned})
    for (k, a), b in zip(model.state_dict().items(), want.state_dict().values()):
        assert torch.equal(a, b), k
    with torch.no_grad():
        assert all(torch.isfinite(f).all() for f in model(torch.zeros(1, IMGSZ, IMGSZ, 3)))


def test_trace_and_speed_benchmark(tmp_path):
    calls = []

    def fn(x):
        calls.append(1)
        return x.sum()

    with profiling.trace(tmp_path):
        dt = profiling.speed_benchmark(fn, (torch.ones(64),), n=5, warmup=2, label="sum")
    assert dt > 0 and len(calls) == 7
    text = (tmp_path / "trace.json").read_text()
    assert '"traceEvents"' in text and "aten::sum" in text
