"""Conv+BN weight folding (yolov3_tpu/models/fuse.py, reference yolo.py:163-172).

At inference BatchNorm with running stats is a per-channel affine:
    weight' = weight * gamma / sqrt(var + eps)        (per output channel)
    bias'   = beta - mean * gamma / sqrt(var + eps)
`fuse_state_dict` folds every `<p>.conv` / `<p>.bn` pair of a state dict in
float32 and casts back to the weight's dtype; the `fused=True` modules
consume the result. A BN with no sibling conv (the standalone BN over the
concat of BottleneckCSP and MixConv2d) stays as it is, with its running
statistics, as the JAX package's `fuse_variables` keeps it.
"""

from __future__ import annotations

import torch

from yolov3_tpu_torch.utils.general import LOGGER

BN_EPS = 1e-3  # must match nn.modules.Conv's BatchNorm epsilon


def fuse_state_dict(sd):
    """Fold every conv+bn pair of `sd`; returns (fused state dict, pairs folded).
    The result shares no storage with `sd`."""
    prefixes = [k[: -len("bn.running_mean")] for k in sd
                if k.endswith("bn.running_mean") and k[: -len("bn.running_mean")] + "conv.weight" in sd]
    fused = {k: v.detach().clone() for k, v in sd.items()}
    for p in prefixes:
        w = sd[p + "conv.weight"]
        gamma, beta = sd[p + "bn.weight"].float(), sd[p + "bn.bias"].float()
        mean, var = sd[p + "bn.running_mean"].float(), sd[p + "bn.running_var"].float()
        f = gamma / torch.sqrt(var + BN_EPS)
        fused[p + "conv.weight"] = (w.float() * f[:, None, None, None]).to(w.dtype)
        fused[p + "conv.bias"] = (beta - mean * f).to(w.dtype)
        for leaf in ("weight", "bias", "running_mean", "running_var", "num_batches_tracked"):
            fused.pop(p + "bn." + leaf, None)
    LOGGER.info(f"fuse: folded {len(prefixes)} Conv+BN pairs")
    return fused, len(prefixes)
