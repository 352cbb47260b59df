"""Profiling: FLOPs, peak memory, traces, timing, pruning and the per-layer
profile (yolov3_tpu/utils/profiling.py), in torch's idiom.

The JAX package counts FLOPs with XLA's cost analysis of the compiled
forward and estimates memory from XLA's memory analysis. Here:
- FLOPs come from `torch.utils.flop_counter.FlopCounterMode` over one eval
  forward: it counts the convolutions and matrix products (2 per
  multiply-add) and nothing else, where XLA also counts the elementwise
  work (BatchNorm, activations, additions, resampling), so the port's count
  is the lower of the two by that work (tests/test_torch_profiling.py
  states the gap);
- peak memory is `torch.cuda.max_memory_allocated` over a real forward on
  the card (the CPU raises: there is no card to measure);
- `trace` records torch.profiler and writes a Chrome trace;
- times are synchronised: CUDA events where the arguments are on the card,
  the host clock on the CPU.

    python -m yolov3_tpu_torch.models.detection --cfg yolov3 --imgsz 640 --line-profile
"""

from __future__ import annotations

import contextlib
import copy
import time
from pathlib import Path

import torch
from torch.utils.flop_counter import FlopCounterMode

from yolov3_tpu_torch.nn.modules import MULTI_INPUT_OPS
from yolov3_tpu_torch.utils.general import LOGGER


@torch.no_grad()
def _counted(fn, *args):
    """(fn(*args), FLOPs counted while it ran)."""
    with FlopCounterMode(display=False) as counter:
        out = fn(*args)
    return out, float(counter.get_total_flops())


def model_flops(model, imgsz=640, batch=1):
    """FLOPs of one eval forward at (batch, imgsz, imgsz, 3) (see the module docstring)."""
    x = torch.zeros((batch, imgsz, imgsz, 3), device=model.device)
    was_training = model.training
    model.eval()
    try:
        return _counted(model, x)[1]
    finally:
        model.train(was_training)


def model_memory_bytes(model, batch, imgsz=640, train=False):
    """Peak device bytes of one forward at (batch, imgsz, imgsz, 3): the
    model's weights and buffers plus the most the forward allocated on the
    card above what was allocated before it (the input, the activations,
    the outputs; with train=True, a train-mode forward and backward of a
    copy, its gradients too; the model's BatchNorm statistics stay as they
    are). What else the process holds on the card is not counted: the JAX
    package's estimate is the compiled forward's arguments, temporaries and
    outputs."""
    if model.device.type != "cuda":
        raise ValueError("model_memory_bytes reads the card's peak memory and needs a CUDA model")
    device = model.device
    net = copy.deepcopy(model).train() if train else model
    weights = sum(t.numel() * t.element_size() for t in (*net.parameters(), *net.buffers()))
    torch.cuda.synchronize(device)
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    x = torch.zeros((batch, imgsz, imgsz, 3), device=device)
    if train:
        sum(o.float().mean() for o in net(x)).backward()
    else:
        was_training = net.training
        net.eval()
        with torch.no_grad():
            net(x)
        net.train(was_training)
    torch.cuda.synchronize(device)
    return int(torch.cuda.max_memory_allocated(device) - base + weights)


def model_info(model, imgsz=640):
    """Log and return {"params", "gflops"} of `model` at imgsz."""
    n_p = model.num_params()
    gflops = model_flops(model, imgsz) / 1e9
    LOGGER.info(f"{model.spec.name} summary: {len(model.spec.layers)} layers, {n_p:,} parameters, "
                f"{gflops:.1f} GFLOPs @ {imgsz}px")
    return {"params": n_p, "gflops": gflops}


@contextlib.contextmanager
def trace(logdir="runs/profile"):
    """torch.profiler over the block (CPU, and CUDA where present); the
    profile is yielded and written to logdir/trace.json (chrome://tracing,
    Perfetto)."""
    logdir = Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(logdir / "trace.json"))
    LOGGER.info(f"Profile trace saved to {logdir / 'trace.json'}")


def _on_cuda(args):
    flat = [a for x in args for a in (x if isinstance(x, (list, tuple)) else [x])]
    return any(isinstance(a, torch.Tensor) and a.is_cuda for a in flat)


def speed_benchmark(fn, args, n=10, warmup=2, label=""):
    """Seconds per call of fn(*args) over n calls after `warmup`: CUDA events
    when an argument is on the card, the host clock otherwise."""
    for _ in range(warmup):
        fn(*args)
    if _on_cuda(args):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn(*args)
        end.record()
        end.synchronize()
        dt = start.elapsed_time(end) / 1e3 / n
    else:
        t0 = time.perf_counter()
        for _ in range(n):
            fn(*args)
        dt = (time.perf_counter() - t0) / n
    if label:
        LOGGER.info(f"{label}: {dt * 1e3:.2f} ms/iter")
    return dt


@torch.no_grad()
def prune(model, amount=0.3):
    """Magnitude pruning of every conv weight (reference torch_utils.py:196-204),
    in place: in each one, the weights below the magnitude of rank
    int(size * amount) become 0. Returns the share of zeros among all the
    model's parameters."""
    for name, p in model.named_parameters():
        if not name.endswith("weight") or p.ndim < 4:
            continue
        k = int(p.numel() * amount)
        if k == 0:
            continue
        thresh = torch.sort(p.abs().reshape(-1)).values[k]
        p[p.abs() < thresh] = 0.0
    total = sum(p.numel() for p in model.parameters())
    zeros = sum(int((p == 0).sum()) for p in model.parameters())
    LOGGER.info(f"pruned model to {zeros / total:.3f} global sparsity")
    return zeros / total


@torch.no_grad()
def profile_layers(model, imgsz=640, batch=1, reps=10):
    """Per-layer profile of the eval forward (reference yolo.py:149-161
    _profile_one_layer): for each spec layer its parameters, GFLOPs (the
    FLOP counter) and ms (`speed_benchmark` over `reps` calls on the
    layer's real inputs) and its output shape, walking the graph as
    `DetectionModel.forward` does. Returns the rows and logs a table."""
    spec = model.spec
    was_training = model.training
    model.eval()
    x = torch.zeros((batch, imgsz, imgsz, 3), device=model.device, dtype=model.dtype)
    out = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    saved, prev, rows = {}, -1, []
    LOGGER.info(f"{'layer':>6} {'op':<18}{'params':>12}{'GFLOPs':>10}{'ms':>9}  output")
    try:
        for ls, m in zip(spec.layers, model.model):
            if ls.op in MULTI_INPUT_OPS or ls.op == "Detect":
                inp = [out if j == prev else saved[j] for j in ls.f]
            else:
                inp = out if ls.f[0] == prev else saved[ls.f[0]]
            result, flops = _counted(m, inp)
            ms = speed_benchmark(m, (inp,), n=reps, warmup=2) * 1e3
            params = sum(p.numel() for p in m.parameters())
            shape = [tuple(r.shape) for r in result] if isinstance(result, (tuple, list)) else tuple(result.shape)
            rows.append({"i": ls.i, "op": ls.op, "params": params, "gflops": flops / 1e9, "ms": ms, "out": shape})
            LOGGER.info(f"{ls.i:>6} {ls.op:<18}{params:>12,}{flops / 1e9:>10.2f}{ms:>9.2f}  {shape}")
            out, prev = result, ls.i
            if ls.i in spec.save:
                saved[ls.i] = out
    finally:
        model.train(was_training)
    LOGGER.info(f"{'total':>6} {'':<18}{model.num_params():>12,}{sum(r['gflops'] for r in rows):>10.2f}"
                f"{sum(r['ms'] for r in rows):>9.2f}")
    return rows
