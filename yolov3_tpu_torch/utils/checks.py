"""Run-time checks (yolov3_tpu/utils/checks.py): the bf16 check before
mixed-precision training, version comparisons, and the online and
requirement probes, which report and never install anything.

`check_bf16` is the JAX package's AMP check (reference utils/general.py
check_amp): one image through the model in float32 and under bf16
autocast, the way the train step runs it; bf16 is trusted when the decoded
boxes agree within `atol` of the image size and the confidences within
`atol`.
"""

from __future__ import annotations

import re
import socket
from importlib import metadata

import numpy as np
import torch

from yolov3_tpu_torch.models.detect_head import decode_predictions
from yolov3_tpu_torch.utils.general import LOGGER


@torch.no_grad()
def bf16_deltas(model, imgsz=256):
    """(max box delta / imgsz, max obj and class delta) between the float32
    and the bf16-autocast decoded outputs of `model` on one seeded
    (1, imgsz, imgsz, 3) image of uniform [0, 1) noise, in eval mode."""
    x = torch.from_numpy(np.random.default_rng(0).uniform(0, 1, (1, imgsz, imgsz, 3)).astype(np.float32))
    x = x.to(model.device)
    anchors, strides = model.anchor_table(), model.spec.strides
    was_training = model.training
    model.eval()
    try:
        f32 = decode_predictions(model(x), anchors, strides)
        with torch.autocast(model.device.type, dtype=torch.bfloat16):
            feats = model(x)
        bf16 = decode_predictions([f.float() for f in feats], anchors, strides)
    finally:
        model.train(was_training)
    db = float((f32[..., :4] - bf16[..., :4]).abs().max()) / imgsz
    dc = float((f32[..., 4:] - bf16[..., 4:]).abs().max())
    return db, dc


def check_bf16(model, imgsz=256, atol=0.1):
    """True when `model`'s bf16 outputs agree with its float32 ones (see the module docstring)."""
    db, dc = bf16_deltas(model, imgsz)
    ok = db < atol and dc < atol
    if ok:
        LOGGER.info(f"check_bf16: passed (max box delta {db:.4f} of imgsz, conf delta {dc:.4f})")
    else:
        LOGGER.warning(f"check_bf16: FAILED (box delta {db:.4f}, conf delta {dc:.4f}) — train in f32")
    return ok


def _version_tuple(v):
    """'1.10' -> (1, 10, 0): zero-padded, so '1.10' == '1.10.0'."""
    t = tuple(int(x) for x in str(v).split(".")[:3] if x.isdigit())
    return t + (0,) * (3 - len(t))


def check_version(current, minimum, name="version", hard=False):
    """current >= minimum, as dotted versions; hard=True raises where it is not."""
    ok = _version_tuple(current) >= _version_tuple(minimum)
    if hard and not ok:
        raise ValueError(f"{name} {minimum} required, found {current}")
    return ok


def check_online(timeout=2.0, hosts=("1.1.1.1", "8.8.8.8")):
    """True when a TCP connection to port 53 of one of `hosts` opens within `timeout` s."""
    for host in hosts:
        try:
            socket.create_connection((host, 53), timeout=timeout).close()
            return True
        except OSError:
            continue
    return False


def check_requirements(requirements=("numpy",), exclude=()):
    """The requirement strings ("name", "name>=1.2", ...) that the installed
    packages do not meet, with one warning naming them. Nothing is installed:
    the JAX package installs what is missing when online; the port reports."""
    if isinstance(requirements, (str, bytes)):
        requirements = [requirements]
    missing = []
    for r in requirements:
        name = re.split(r"[><=!~\[ ]", str(r), maxsplit=1)[0].strip()
        if not name or name in exclude:
            continue
        try:
            have = metadata.version(name)
        except metadata.PackageNotFoundError:
            missing.append(str(r))
            continue
        m = re.match(r"(>=|==|<=|>|<)\s*([\w.]+)", str(r)[len(name):].strip())
        if m:
            op, want = m.groups()
            hv, wv = _version_tuple(have), _version_tuple(want)
            if not {">=": hv >= wv, ">": hv > wv, "==": hv == wv, "<=": hv <= wv, "<": hv < wv}[op]:
                missing.append(str(r))
    if missing:
        LOGGER.warning("requirements: missing " + " ".join(f'"{x}"' for x in missing) + " (nothing is installed)")
    return missing
