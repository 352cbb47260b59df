"""The port's parallel layer (yolov3_tpu_torch/parallel/mesh.py) and the
pieces that read it, on the CPU.

 - the device Mesh: bounds, shards, replicas, map and gather; shard_batch
   and replicate with and without a mesh; create_mesh's devices;
 - DataLoader.shard_per_host: each rank's batches equal the JAX loader's
   `_batches` with `_host_shard = (rank, world)`, and its length the JAX one;
 - MicroBatcher(min_bucket): the JAX package's bucket lists;
 - initialize_distributed's arguments and backend: gloo on the CPU, NCCL on
   CUDA, a refusal where CUDA ranks would share a card unless the caller
   names gloo;
 - initialize_distributed at world 1 over gloo in this process: the group's
   collectives; the global-batch forms of the conv+statistics plain version,
   its autograd function, `global_batch_norm` and the loss, run through the
   group's collectives, equal their local forms (float64, rtol 1e-12), and
   `synchronized_statistics` changes nothing at one rank; the group left at
   the end. Two processes: tests/test_torch_ddp.py.
"""

import socket

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from yolov3_tpu.data.datasets import DataLoader as JaxDataLoader
from yolov3_tpu.serve import MicroBatcher as JaxMicroBatcher
from torch_cores import share_cores  # noqa: F401 — autouse: torch's threads, a worker's share
from yolov3_tpu_torch.data.datasets import DataLoader
from yolov3_tpu_torch.nn.modules import BatchNorm2d, global_batch_norm
from yolov3_tpu_torch.ops import conv_bn_cuda
from yolov3_tpu_torch.ops.conv_bn_cuda import conv3x3_bn_stats, conv3x3_bn_stats_plain
from yolov3_tpu_torch.parallel import mesh
from yolov3_tpu_torch.serve import MicroBatcher
from yolov3_tpu_torch.train import loss as loss_module
from yolov3_tpu_torch.train.loss import LossConfig, compute_loss


class FakeDataset:
    def __init__(self, n, rect=False):
        self.n, self.rect = n, rect

    def __len__(self):
        return self.n


def test_mesh_bounds_shards_and_gather():
    m = mesh.create_mesh(["cpu", "cpu", torch.device("cpu")])
    assert m.size == 3 and m.devices == (torch.device("cpu"),) * 3
    assert m.divides(6) and not m.divides(7)
    assert m.bounds(6) == [(0, 2), (2, 4), (4, 6)]
    with pytest.raises(ValueError, match="does not divide"):
        m.bounds(7)
    x = np.arange(12).reshape(6, 2)
    shards = m.shard(x)
    assert [s.tolist() for s in shards] == [x[0:2].tolist(), x[2:4].tolist(), x[4:6].tolist()]
    out = m.map(lambda i, a, b: (a * 10 + i, b.sum(1)), x, torch.from_numpy(x))
    np.testing.assert_array_equal(out[0].numpy(), x * 10 + np.repeat([0, 1, 2], 2)[:, None])
    np.testing.assert_array_equal(out[1].numpy(), x.sum(1))
    assert torch.equal(mesh.gather([torch.ones(1), torch.zeros(2)], "cpu"), torch.tensor([1.0, 0.0, 0.0]))


def test_mesh_replicas_and_placement():
    net = torch.nn.Linear(2, 2)
    m = mesh.create_mesh(["cpu", "cpu"])
    assert m.replicas(net) == [net, net]  # the module itself on its own device
    x = np.arange(8).reshape(4, 2)
    assert [s.shape for s in mesh.shard_batch((x, x), m)[0]] == [(2, 2), (2, 2)]
    # without a group: one rank holds every row, replicate changes nothing
    assert np.array_equal(mesh.shard_batch(x), x)
    before = net.weight.detach().clone()
    assert mesh.replicate(net) is net and torch.equal(net.weight, before)
    assert mesh.world_size() == 1 and mesh.rank() == 0 and mesh.is_main_process() and not mesh.grouped()
    with mesh.synchronized_statistics():  # no group: the local batch is the global one
        assert not mesh.statistics_synchronized()
    assert mesh.rank_device("cpu") == torch.device("cpu")


def test_create_mesh_defaults_to_the_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.create_mesh()
    assert mesh.create_mesh([0, 1]).devices == (torch.device("cuda", 0), torch.device("cuda", 1))
    with pytest.raises(ValueError, match="no devices"):
        mesh.create_mesh([])


@pytest.mark.parametrize("n,bs,world,shuffle,drop_last,rect", [
    (64, 16, 2, False, False, False), (70, 8, 2, True, True, False), (70, 8, 3, True, False, False),
    (33, 4, 4, False, True, True), (10, 4, 3, True, False, False),
])
def test_shard_per_host_matches_jax(n, bs, world, shuffle, drop_last, rect):
    seen = []
    for rank in range(world):
        got = DataLoader(FakeDataset(n, rect), batch_size=bs, shuffle=shuffle, seed=3, drop_last=drop_last)
        got._host_shard = (rank, world)  # what shard_per_host sets from the group (tests/test_torch_ddp.py)
        want = JaxDataLoader(FakeDataset(n, rect), batch_size=bs, shuffle=shuffle, seed=3, drop_last=drop_last)
        want._host_shard = (rank, world)
        g, w = [b.tolist() for b in got._batches()], [b.tolist() for b in want._batches()]
        assert g == w and len(got) == len(want) == len(g), (rank, g, w)
        seen += [i for b in g for i in b]
    assert len(seen) == len(set(seen))  # the ranks' batches are disjoint


@pytest.mark.parametrize("max_batch,min_bucket", [(12, 8), (32, 2), (8, 1), (5, 2), (2, 2)])
def test_micro_batcher_buckets_match_jax(max_batch, min_bucket):
    got = MicroBatcher(lambda b: b, max_batch=max_batch, min_bucket=min_bucket)
    want = JaxMicroBatcher(lambda b: b, max_batch=max_batch, min_bucket=min_bucket)
    assert got.buckets == want.buckets and got.max_batch == want.max_batch
    assert all(b % min_bucket == 0 for b in got.buckets)
    with pytest.raises(ValueError, match="min_bucket"):
        MicroBatcher(lambda b: b, max_batch=2, min_bucket=4)


def test_initialize_distributed_arguments(monkeypatch):
    assert mesh.initialize_distributed() is False  # a bare single-process run
    assert mesh.initialize_distributed(None, 1) is False
    with pytest.raises(ValueError, match="coordinator"):
        mesh.initialize_distributed(None, 2, 0)
    with pytest.raises(ValueError, match="process_id 2"):
        mesh.initialize_distributed("127.0.0.1:1", 2, 2)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    assert mesh.default_backend(2, "cpu") == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert mesh.default_backend(2, "cuda") == "nccl"  # a card a process
    with pytest.raises(ValueError, match="NCCL takes one card a rank"):
        mesh.default_backend(3, "cuda")  # ranks would share a card: refused, never gloo unasked
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="backend='gloo'"):
        mesh.initialize_distributed("127.0.0.1:1", 2, 0, device="cuda")  # refused before any connection
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "1")  # two hosts of one card each
    assert mesh.default_backend(2, "cuda") == "nccl"
    monkeypatch.setenv("LOCAL_RANK", "0")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert mesh.rank_device("cuda") == torch.device("cuda", 0)


@pytest.fixture
def world1():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    assert mesh.initialize_distributed(f"127.0.0.1:{port}", 1, 0, device="cpu")
    try:
        yield
    finally:
        mesh.destroy_distributed()
    assert not mesh.grouped()


def test_world1_group_collectives(world1):
    assert mesh.grouped() and mesh.world_size() == 1 and mesh.backend() == "gloo"
    with mesh.synchronized_statistics():  # at one rank the global batch is the local one
        assert not mesh.statistics_synchronized()
    t = torch.arange(4.0)
    assert torch.equal(mesh.all_reduce_sum_(t.clone()), t)
    a, b = torch.ones(2, 3).to(memory_format=torch.contiguous_format), torch.arange(3, dtype=torch.int64)
    mesh.all_reduce_tensors_([a, None, b])
    mesh.broadcast_tensors_([a, b])
    assert torch.equal(a, torch.ones(2, 3)) and torch.equal(b, torch.arange(3))
    assert mesh.broadcast_object({"x": 1}) == {"x": 1}
    assert DataLoader(FakeDataset(8), batch_size=2).shard_per_host()._host_shard == (0, 1)
    x = torch.arange(3.0, requires_grad=True)
    (mesh.all_reduce_sum(x) * torch.tensor([1.0, 2.0, 3.0])).sum().backward()
    assert torch.equal(x.grad, torch.tensor([1.0, 2.0, 3.0]))
    mesh.barrier("cpu")
    with pytest.raises(RuntimeError, match="initialized already"):
        mesh.initialize_distributed("127.0.0.1:1", 1, 0)


def test_world1_synchronized_statistics_equal_the_local_ones(world1, monkeypatch):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(2, 6, 5, 3))).requires_grad_()
    w = torch.from_numpy(rng.normal(size=(3, 3, 3, 4))).requires_grad_()
    gy = torch.from_numpy(rng.normal(size=(2, 6, 5, 4)))
    gm, gv = torch.from_numpy(rng.normal(size=4)), torch.from_numpy(rng.normal(size=4))

    def run(fn, sync=None):
        x.grad = w.grad = None
        if sync is not None:  # sync=True: the global-batch form, as statistics_synchronized() reads at two ranks
            monkeypatch.setattr(conv_bn_cuda, "statistics_synchronized", lambda: sync)
        y, mean, var = fn(x, w)
        ((y * gy).sum() + (mean * gm).sum() + (var * gv).sum()).backward()
        return [t.detach().clone() for t in (y, mean, var, x.grad, w.grad)]

    want = run(conv3x3_bn_stats_plain, False)
    for fn in (conv3x3_bn_stats_plain, conv3x3_bn_stats):  # the plain version's all-reduce; the function's
        for got, ref in zip(run(fn, True), want):
            np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-12, atol=1e-12)
    monkeypatch.undo()
    for fn in (conv3x3_bn_stats_plain, conv3x3_bn_stats):
        local = run(fn)
        with mesh.synchronized_statistics():  # at one rank the local form runs, in its bits
            assert all(torch.equal(got, ref) for got, ref in zip(run(fn), local))


def test_world1_global_batch_norm_equals_batch_norm(world1):
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(2.0, 3.0, size=(3, 4, 5, 6))).requires_grad_()
    bn, ref = BatchNorm2d(4).double(), BatchNorm2d(4).double()
    scale = torch.from_numpy(rng.normal(size=4))
    with torch.no_grad():
        for m in (bn, ref):
            m.weight.copy_(scale)
            m.bias.copy_(torch.tensor([0.1, -0.2, 0.3, 0.0], dtype=torch.float64))
    g = torch.from_numpy(rng.normal(size=(3, 4, 5, 6)))
    y = global_batch_norm(x, bn)
    (y * g).sum().backward()
    got = [y.detach(), x.grad.clone(), bn.weight.grad, bn.bias.grad]
    x.grad = None
    y_ref = F.batch_norm(x, ref.running_mean, ref.running_var, ref.weight, ref.bias, True, ref.momentum, ref.eps)
    (y_ref * g).sum().backward()
    want = [y_ref.detach(), x.grad, ref.weight.grad, ref.bias.grad]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12, atol=1e-12)
    for name in ("running_mean", "running_var"):
        np.testing.assert_allclose(getattr(bn, name).numpy(), getattr(ref, name).numpy(), rtol=1e-12)
    assert int(bn.num_batches_tracked) == 1
    with mesh.synchronized_statistics():  # at world 1 the module keeps F.batch_norm
        bn.train()(x)
    assert int(bn.num_batches_tracked) == 2


def test_world1_global_batch_loss_equals_the_local_loss(world1, monkeypatch):
    rng = np.random.default_rng(2)
    cfg = LossConfig(nc=3, nl=2, na=3, anchors=(((1.0, 1.5), (2.0, 2.5), (3.0, 2.0)),) * 2, strides=(8, 16))
    feats = [torch.from_numpy(rng.normal(size=(2, 3, s, s, 8))) for s in (8, 4)]
    targets = np.zeros((2, 3, 5), np.float32)
    targets[:, :, 0] = rng.integers(0, 3, (2, 3))
    targets[:, :, 1:] = rng.uniform(0.2, 0.6, (2, 3, 4))
    mask = np.array([[1, 1, 0], [1, 0, 0]], bool)
    local = compute_loss(feats, targets, mask, cfg, return_per_layer_obj=True)
    with mesh.synchronized_statistics():  # at one rank: the local loss, in its bits
        for a, b in zip(compute_loss(feats, targets, mask, cfg, return_per_layer_obj=True), local):
            assert torch.equal(a, b)
    # the global-batch form, its counts added over the group: as statistics_synchronized() reads at two ranks
    monkeypatch.setattr(loss_module, "statistics_synchronized", lambda: True)
    shared = compute_loss(feats, targets, mask, cfg, return_per_layer_obj=True)
    for a, b in zip(shared, local):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=1e-12)
