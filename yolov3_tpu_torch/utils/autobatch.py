"""AutoBatch: the largest train batch that fits the card's memory
(yolov3_tpu/utils/autobatch.py, reference utils/autobatch.py:14-82).

The JAX package reads XLA's compile-time memory analysis. Here a trial
forward + backward runs at two batch sizes on a copy of the model, the peak
of `torch.cuda.max_memory_allocated` is fitted with a line in the batch
size, and the batch is the largest whose predicted peak, plus the optimizer
momentum and the EMA copy (two more parameter-sized f32 buffers), stays
within `fraction` of the card's memory.
"""

from __future__ import annotations

import copy

import torch

from yolov3_tpu_torch.utils.general import LOGGER


def _peak_bytes(model, batch, imgsz, compute_dtype):
    device = model.device
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    x = torch.zeros((batch, imgsz, imgsz, 3), device=device)
    with torch.autocast("cuda", dtype=compute_dtype, enabled=compute_dtype != torch.float32):
        out = model(x)
    sum(o.float().mean() for o in out).backward()
    torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device)
    model.zero_grad(set_to_none=True)
    return peak


TRIAL_BATCHES = (2, 4)
MAX_BATCH = 1024


def check_train_batch_size(model, imgsz=640, fraction=0.8, compute_dtype=torch.bfloat16):
    """Largest batch size whose predicted train-step peak fits `fraction` of the card's memory."""
    device = model.device
    if device.type != "cuda":
        raise ValueError("AutoBatch (batch_size=-1) measures the card's memory and needs a CUDA model")
    trial_model = copy.deepcopy(model).train()  # the trial's BatchNorm updates stay off the model
    try:
        (b0, m0), (b1, m1) = [(b, _peak_bytes(trial_model, b, imgsz, compute_dtype)) for b in TRIAL_BATCHES]
    finally:
        del trial_model
        torch.cuda.empty_cache()
    slope = max((m1 - m0) / (b1 - b0), 1.0)
    fixed = m0 - slope * b0 + 2 * sum(p.numel() * 4 for p in model.parameters())
    total = torch.cuda.get_device_properties(device).total_memory
    b = int((total * fraction - fixed) // slope)
    b = max(1, min(b, MAX_BATCH))
    LOGGER.info(f"AutoBatch: batch-size {b} ({slope / 2**20:.0f} MiB per image, {fixed / 2**30:.2f} GiB fixed, "
                f"{fraction:.0%} of {total / 2**30:.0f} GiB)")
    return b
