"""greedy_nms at one candidate count per kernel of csrc/nms.cu (registers up
to K = 512, shared memory up to 8192, global memory beyond) against the JAX
loop, with planted ties; and the arithmetic the kernels rest on: the margin
test that spares the IoU's division must never disagree with the division.

On the CPU the wrapper runs the plain version; the kernels themselves are held
to the plain version on the card by chip_smoke.py at the same three ranges.
"""

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from yolov3_tpu.ops.nms import _greedy_nms
from torch_cores import share_cores  # noqa: F401 — autouse: torch's threads, a worker's share
from yolov3_tpu_torch.ops.nms_cuda import ROUTES, greedy_nms


def xla_loop(args, iou, max_det):
    out, n = jax.vmap(lambda bo, bx, s, c: _greedy_nms(bo, bx, s, c, iou, max_det))(*args)
    return np.asarray(out), np.asarray(n)


@pytest.mark.parametrize("B,K,iou,max_det", [(3, 448, 0.45, 300), (2, 1500, 0.45, 300), (1, 9000, 0.6, 120)],
                         ids=["registers-448", "shared-1500", "global-9000"])
def test_wrapper_equals_jax_loop_with_ties(B, K, iou, max_det):
    args = [t.numpy() for t in chip_smoke.make_candidates(np.random.default_rng(K), B, K, "cpu")]
    scores = args[2]
    assert (scores[:, 1:K // 8] == scores[:, :K // 8 - 1]).any(), "no tie was planted"
    out, n = greedy_nms(*(torch.from_numpy(a) for a in args), iou, max_det)
    ref_out, ref_n = xla_loop(args, iou, max_det)
    np.testing.assert_array_equal(n.numpy(), ref_n)
    np.testing.assert_array_equal(out.numpy(), ref_out)
    assert int(n.min()) > 50


def test_serving_shapes_have_their_own_rows():
    """chip_smoke's NMS shapes reach each of the three kernels' ranges: the
    serving top-k of yolov3 and of yolov3-tiny in registers, the fallback in
    shared memory, the val grade in global memory."""
    ks = {label: K for label, _, K, _ in chip_smoke.NMS_SHAPES}
    assert ks["serving"] == 256 + 128 + 64 and ks["tiny serving"] == 256 + 128
    assert max(ks["serving"], ks["tiny serving"]) <= 512 < ks["fallback"] <= 8192 < ks["val"]
    assert sorted(ROUTES) == [1, 2, 3]


def margin_verdict(inter, uni, thres):
    """The kernels' test in f32, as csrc/nms.cu writes it: 1 above, 0 not, -1 undecided."""
    f = np.float32
    hi, lo = f(thres) * f(1.00002), f(thres) * f(0.99998)
    above, below = inter > uni * hi, inter < uni * lo
    ok = (f(thres) > f(1e-3)) & (f(thres) < f(1e3)) & (uni > f(1e-30)) & (above | below)
    return np.where(ok, np.where(above, 1, 0), -1)


@pytest.mark.parametrize("thres", [0.45, 0.6, 0.05, 0.999])
def test_margin_test_never_disagrees_with_the_division(thres):
    rng = np.random.default_rng(int(thres * 1000))
    f = np.float32
    n = 400_000
    uni = (10.0 ** rng.uniform(-6, 8, size=n)).astype(f)
    # ratios spread over [0, 2], and a dense cloud within a few ulps and 1e-4 of the threshold
    ratio = np.concatenate([rng.uniform(0, 2, size=n // 2),
                            thres * (1 + rng.uniform(-1e-4, 1e-4, size=n // 4)),
                            thres * (1 + rng.integers(-40, 41, size=n // 4) * 2.0 ** -24)])
    inter = (uni.astype(np.float64) * ratio).astype(f)
    verdict = margin_verdict(inter, uni, thres)
    division = (inter / uni > f(thres)).astype(int)  # IEEE f32 division, the plain version's test
    decided = verdict >= 0
    np.testing.assert_array_equal(verdict[decided], division[decided])
    assert decided.mean() > 0.6 and (~decided).sum() > 1000  # both branches were exercised


def test_margin_test_undecided_for_odd_thresholds_and_denominators():
    f = np.float32
    assert margin_verdict(f(1.0), f(2.0), 0.0) == -1  # a threshold of 0: the division decides
    assert margin_verdict(f(1.0), f(-2.0), 0.45) == -1  # a malformed box's negative union
    assert margin_verdict(f(np.nan), f(2.0), 0.45) == -1
