"""Data parallelism (yolov3_tpu/parallel/mesh.py) in torch's idiom.

The JAX package runs one program over a `jax.sharding.Mesh` with a "data"
axis: parameters replicated, the batch sharded on its leading axis, and XLA
inserts the collectives. The port has two forms of it:

- Training runs one process per card in a `torch.distributed` process group
  (`initialize_distributed`; NCCL between cards, gloo on the CPU, or on
  CUDA ranks that share a card when the caller names it). `batch_size` is per process. Every rank holds a
  replica of the train state, broadcast from rank 0 at the start
  (`replicate`), and its own rows of the global batch (`shard_batch`,
  `DataLoader.shard_per_host`). The train step (train/step.py) computes the
  rank's share of the global-batch loss with BatchNorm statistics over the
  global batch (`synchronized_statistics`), and sums the shares' gradients.
  The JAX package runs one process per host over that host's devices; here
  each rank is one device, so its gcd device-subset rule has no counterpart.
- Serving and validation shard a batch in one process over a `Mesh` of local
  devices: a replica of the model on each device, the rows split evenly,
  each device runs its rows, the results gathered (`Mesh.map`); a batch the
  mesh does not divide runs whole on the first device (`Mesh.apply`).

Every collective here is the identity when no process group is initialized,
so one process runs as it always did. None is caught: a collective that
fails raises.
"""

from __future__ import annotations

import contextlib
import copy
import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from yolov3_tpu_torch.utils.general import LOGGER, select_device


def local_processes(num_processes):
    """The processes of the run on this host: LOCAL_WORLD_SIZE when the
    launcher sets it (torchrun does; a run over several hosts sets it on
    each), else `num_processes` (one host)."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))


def default_backend(num_processes, device=None):
    """The backend of a process group on `device`: gloo on the CPU, NCCL on
    CUDA. NCCL takes a card of its own for each rank, so CUDA ranks that
    would share a card (more `local_processes` on this host than cards)
    raise: a caller that means them to share one names gloo itself."""
    device = torch.device(device) if device is not None else torch.device(
        "cuda" if torch.cuda.is_available() else "cpu")
    if device.type != "cuda":
        return "gloo"
    local, cards = local_processes(num_processes), torch.cuda.device_count()
    if local > cards:
        raise ValueError(f"initialize_distributed: {local} processes on this host and {cards} cards; NCCL takes "
                         "one card a rank. Set LOCAL_WORLD_SIZE to this host's processes when the run spans "
                         "hosts, or pass backend='gloo' (--dist-backend gloo) for ranks that share a card")
    return "nccl"


def initialize_distributed(coordinator=None, num_processes=None, process_id=None, device=None, backend=None):
    """Join the process group of a multi-process run over `tcp://coordinator`
    (host:port of process 0), as rank `process_id` of `num_processes`.

    Runs whenever a coordinator is given, also at num_processes=1, as the JAX
    package's does; a bare single-process run skips it. The backend is
    `backend` when given ("gloo" lets CUDA ranks share a card, each
    collective staged through the host), else `default_backend`; one that
    cannot start raises. Returns True when a group was initialized."""
    if not num_processes or not (num_processes > 1 or coordinator):
        return False
    if not coordinator:
        raise ValueError("initialize_distributed: more than one process needs the coordinator's host:port")
    process_id = 0 if process_id is None and num_processes == 1 else process_id
    if process_id is None or not 0 <= process_id < num_processes:
        raise ValueError(f"initialize_distributed: process_id {process_id} is not in [0, {num_processes})")
    if dist.is_initialized():
        raise RuntimeError("initialize_distributed: a process group is initialized already")
    name = backend or default_backend(num_processes, device)
    dist.init_process_group(name, init_method=f"tcp://{coordinator}", world_size=int(num_processes),
                            rank=int(process_id))
    LOGGER.info(f"initialized distributed: process {process_id}/{num_processes} ({name})")
    return True


def destroy_distributed():
    """Leave the process group, if any."""
    if grouped():
        dist.destroy_process_group()


def grouped():
    """Whether a process group is initialized."""
    return dist.is_available() and dist.is_initialized()


def world_size():
    return dist.get_world_size() if grouped() else 1


def rank():
    return dist.get_rank() if grouped() else 0


def is_main_process():
    return rank() == 0


def backend():
    return dist.get_backend() if grouped() else None


def rank_device(device=None):
    """This rank's device: `select_device(device)`, and for a CUDA device
    without an index cuda:{local rank % cards}; the local rank is LOCAL_RANK
    when the launcher sets it, else the rank (ranks beyond the cards share
    them, which only gloo allows)."""
    device = select_device(device)
    if device.type == "cuda" and device.index is None:
        local = int(os.environ.get("LOCAL_RANK", rank()))
        device = torch.device("cuda", local % torch.cuda.device_count())
    return device


# ------------------------------------------------------------ collectives ----


def all_reduce_sum_(t):
    """Sum `t` over the ranks, in place; the identity without a group."""
    if grouped():
        dist.all_reduce(t)
    return t


class _AllReduceSum(torch.autograd.Function):
    """y = the sum of x over the ranks; the cotangent of x is the sum of y's
    cotangents over the ranks (each rank's loss reads the same y)."""

    @staticmethod
    def forward(ctx, x):
        y = x.contiguous().clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g)
        return g


def all_reduce_sum(x):
    """Differentiable sum over the ranks; `x` itself without a group."""
    return _AllReduceSum.apply(x) if grouped() else x


def _flat_groups(tensors):
    groups = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    return groups.values()


def _flat_apply_(tensors, op):
    """`op` on one flat buffer per (dtype, device) of `tensors`, the result
    copied back into each (any memory format)."""
    for group in _flat_groups(tensors):
        flat = torch.cat([t.reshape(-1) for t in group])
        op(flat)
        offset = 0
        for t in group:
            t.copy_(flat[offset:offset + t.numel()].view(t.shape))
            offset += t.numel()


def all_reduce_tensors_(tensors):
    """Sum every tensor of `tensors` over the ranks, in place, in one
    collective per dtype and device."""
    tensors = [t for t in tensors if t is not None]
    if grouped() and tensors:
        _flat_apply_(tensors, dist.all_reduce)
    return tensors


def broadcast_tensors_(tensors, src=0):
    """Rank `src`'s values into every tensor of `tensors`, in place."""
    tensors = [t for t in tensors if t is not None]
    if grouped() and tensors:
        _flat_apply_(tensors, lambda flat: dist.broadcast(flat, src))
    return tensors


def broadcast_object(obj, src=0):
    """Rank `src`'s picklable object on every rank (a run directory, anchors);
    on NCCL the current CUDA device carries it."""
    if not grouped():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src)
    return box[0]


def barrier(device=None):
    """Wait for every rank; on NCCL the rank's card is named so no other is touched."""
    if grouped():
        if backend() == "nccl" and device is not None and torch.device(device).type == "cuda":
            dist.barrier(device_ids=[torch.device(device).index or 0])
        else:
            dist.barrier()


_SYNC = [False]


@contextlib.contextmanager
def synchronized_statistics(on=True):
    """While on, under a process group of more than one rank, the train-mode
    BatchNorm statistics (the conv+statistics function and BatchNorm2d) and
    the loss are those of the global batch: the one signal that the train
    step sets around its forward and backward, so a train-mode forward
    elsewhere (one rank alone) never waits on the others. At one rank the
    global batch is the local one and nothing changes. Process-wide, not
    thread-local: autograd runs an activation checkpoint's recompute on a
    thread of its own."""
    prev = _SYNC[0]
    _SYNC[0] = bool(on)
    try:
        yield
    finally:
        _SYNC[0] = prev


def statistics_synchronized():
    return _SYNC[0] and world_size() > 1


# ---------------------------------------------------------- placement ----


def replicate(obj):
    """Rank 0's values broadcast into `obj` (a module's parameters and
    buffers, a tensor, or a dict / list of tensors) on every rank; returns
    `obj`. A `Mesh` of one process makes its replicas with `Mesh.replicas`."""
    if isinstance(obj, torch.nn.Module):
        tensors = [t.data for t in obj.parameters()] + list(obj.buffers())
    elif isinstance(obj, torch.Tensor):
        tensors = [obj.data]
    elif isinstance(obj, dict):
        tensors = list(obj.values())
    else:
        tensors = list(obj)
    with torch.no_grad():
        broadcast_tensors_(tensors)
    return obj


def shard_batch(batch, mesh=None):
    """Without a mesh: this rank's rows of a global batch (an array or
    tensor, or a tuple of them), an even contiguous split over the ranks.
    With a `Mesh`: the list of its devices' shards (`Mesh.shard`)."""
    if isinstance(batch, tuple):
        return tuple(shard_batch(b, mesh) for b in batch)
    if mesh is not None:
        return mesh.shard(batch)
    n, w, r = len(batch), world_size(), rank()
    if n % w:
        raise ValueError(f"shard_batch: a batch of {n} rows does not divide over {w} ranks")
    return batch[r * (n // w):(r + 1) * (n // w)]


@dataclass(frozen=True)
class Mesh:
    """A 1-D data-parallel mesh of local devices (a device may repeat: two
    shards on one card). A batch's rows split evenly over it in order."""

    devices: tuple

    @property
    def size(self):
        return len(self.devices)

    def divides(self, n):
        return n % self.size == 0

    def bounds(self, n):
        """(start, stop) rows of each shard of a batch of n."""
        if not self.divides(n):
            raise ValueError(f"Mesh: a batch of {n} rows does not divide over {self.size} devices")
        k = n // self.size
        return [(i * k, (i + 1) * k) for i in range(self.size)]

    def shard(self, x):
        """Each device's rows of `x` (a tensor or an array), on that device."""
        x = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.ascontiguousarray(x))
        return [x[a:b].to(d, non_blocking=True) for (a, b), d in zip(self.bounds(len(x)), self.devices)]

    def replicas(self, module):
        """One copy of `module` per device (the module itself on the device it
        is on; a deep copy moved to each other), listed per shard."""
        here = next(iter(module.parameters()), torch.empty(0)).device
        copies = {}
        for d in self.devices:
            if d not in copies:
                copies[d] = module if d == here else copy.deepcopy(module).to(d)
        return [copies[d] for d in self.devices]

    def map(self, fn, *arrays):
        """fn(i, *shards of `arrays` on device i) on each shard, in order; the
        outputs (a tensor or a tuple of them per shard) concatenated on the
        first device of the mesh. The shards are issued one after another
        from this thread: the devices' work overlaps only as far as their
        launches run ahead of it."""
        shards = [self.shard(a) for a in arrays]
        outs = [fn(i, *(s[i] for s in shards)) for i in range(self.size)]
        return gather(outs, self.devices[0])

    def apply(self, fn, *arrays):
        """The split rule of sharded serving, validation and NMS: a batch the
        mesh divides runs `map(fn, *arrays)`, gathered on the first device; a
        batch it does not divide runs whole as fn(0, *arrays), the first
        device's function (MicroBatcher's buckets and the validator's batches
        divide; a tail batch may not)."""
        return self.map(fn, *arrays) if self.divides(len(arrays[0])) else fn(0, *arrays)


def gather(outs, device):
    """Concatenate per-shard outputs (tensors, or tuples of tensors) on `device`."""
    if isinstance(outs[0], torch.Tensor):
        return torch.cat([o.to(device) for o in outs])
    return tuple(torch.cat([o[j].to(device) for o in outs]) for j in range(len(outs[0])))


def create_mesh(devices=None):
    """A `Mesh` over `devices` (torch.devices, names such as "cuda:0" or
    "cpu", or CUDA indices), all local CUDA devices by default."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("create_mesh: no CUDA device; pass the devices (e.g. ['cpu', 'cpu'])")
        devices = range(torch.cuda.device_count())
    devices = tuple(torch.device("cuda", d) if isinstance(d, int) else torch.device(d) for d in devices)
    devices = tuple(torch.device("cuda", torch.cuda.current_device()) if d.type == "cuda" and d.index is None
                    else d for d in devices)
    if not devices:
        raise ValueError("create_mesh: no devices")
    return Mesh(devices)
