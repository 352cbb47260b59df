"""The traffic repeats from the seed, and every seed offers the same work."""

import numpy as np
import torch

from h100bench_support import small_run
from harness.core import Run, derived_seed
from harness.weights import make_weights
from reference.model import Net
from traffic import stream, train, val
from traffic.batch import frames_pool

BIG = 2 ** 31 + 12345  # the driver's seeds pass 32 signed bits


def test_schedule_repeats_and_every_seed_offers_the_same_gaps():
    sizes = [[480, 640], [720, 1280], [640, 640], [375, 500]]
    a = stream.schedule(BIG, "arrivals", 500.0, 4.0, sizes, 16)
    assert a == stream.schedule(BIG, "arrivals", 500.0, 4.0, sizes, 16)
    b = stream.schedule(BIG + 1, "arrivals", 500.0, 4.0, sizes, 16)
    assert a != b and len(a) == len(b) == 2000
    quantiles = -np.log1p(-(np.arange(2000) + 0.5) / 2000) / 500.0
    for s in (a, b):  # every gap is one of the exponential's quantiles
        gaps = np.diff([t for t, _, _ in s])
        assert np.abs(gaps[:, None] - quantiles[None, :]).min(1).max() < 1e-9
    assert abs(a[-1][0] - 4.0) < 0.05
    for size in map(tuple, sizes):
        assert sum(s == size for _, s, _ in a) == sum(s == size for _, s, _ in b) == 500


def test_frames_and_weights_repeat_from_the_seed():
    run = small_run("yolov3-serve-b32", seed=BIG)
    f1, f2 = frames_pool(run, 2, 32), frames_pool(run, 2, 32)
    assert f1.dtype == np.uint8 and np.array_equal(f1, f2)
    run.seed = BIG + 1
    assert not np.array_equal(f1, frames_pool(run, 2, 32))
    net = Net(run.workload["model"])
    w1, w2 = make_weights(net, BIG, "cpu"), make_weights(net, BIG, "cpu")
    assert all(torch.equal(w1[k], w2[k]) for k in w1)
    assert not torch.equal(w1["model.0.conv.weight"], make_weights(net, BIG + 1, "cpu")["model.0.conv.weight"])


def test_label_and_box_counts_are_the_same_for_every_seed():
    a, b = val.label_counts(256, 7.0, 60, BIG), val.label_counts(256, 7.0, 60, BIG + 1)
    assert not np.array_equal(a, b) and np.array_equal(np.sort(a), np.sort(b))
    assert a.min() >= 1 and a.max() <= 60 and 6.5 < a.mean() < 7.5
    run = small_run("yolov3-train-b64", seed=BIG)
    net = Net(run.workload["model"])
    b1, b2 = train.make_batches(run, net), train.make_batches(run, net)
    assert all(torch.equal(x, y) for p, q in zip(b1, b2) for x, y in zip(p, q))
    counts = sorted(int(m.sum()) for _, _, mask in b1 for m in mask)
    run.seed = BIG + 1
    assert counts == sorted(int(m.sum()) for _, _, mask in train.make_batches(run, net) for m in mask)


def test_derived_seeds_differ_by_purpose():
    assert derived_seed(BIG, "weights") != derived_seed(BIG, "frames")
    assert derived_seed(BIG, "weights") == derived_seed(BIG, "weights") < 2 ** 63
    assert isinstance(Run, type)
