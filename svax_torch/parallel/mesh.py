"""Process groups for data × component parallelism (``svax/parallel/mesh.py``).

The reference runs its train steps under ``shard_map`` over a ("data",) or
("data", "comp") device mesh and psums inside the step. Here every rank is
one process of ``torch.distributed``, and a ``Mesh`` is the default group
plus the subgroups the steps reduce over: rank r sits at (data r // comp,
comp r % comp), the reshape of ``make_data_comp_mesh``; ``data_group``
holds the ranks that share this rank's comp index (a sum over the data
axis), ``comp_group`` those that share its data index (a sum over the comp
axis). An axis of size 1 has no group (None): nothing is reduced over it.

``psum`` is the differentiable SUM all-reduce: its backward all-reduces the
cotangents, the transpose JAX gives psum under ``check_vma=False``, so a
loss that is replicated across a group gets each rank's gradient scaled by
the group's size (``train.svae_step`` divides it out, as the reference's
step does). ``pmax_const`` is a MAX all-reduce of a detached tensor: the
stabilising shift of a logsumexp, which carries no gradient.

``init_distributed`` joins the default group: under ``torchrun`` from its
environment (rank r on ``cuda:LOCAL_RANK``, never two ranks on one card
unless the caller names the device), else from the rank, world size and
``init_method`` given. ``spawn`` runs a function in W fresh processes over
a ``file://`` store in a temporary directory (no port, no network) and
joins them with a timeout. Backends: NCCL on CUDA and gloo on the CPU by
default; gloo also carries CUDA tensors, which is how several ranks share
one card. Collective errors are not caught.
"""

from __future__ import annotations

import multiprocessing
import os
import pickle
import queue as queue_mod
import tempfile
import time
import traceback
from typing import Callable, NamedTuple

import torch
import torch.distributed as dist


class Mesh(NamedTuple):
    data: int  # ranks along the batch axis
    comp: int  # ranks along the mixture-component axis
    data_idx: int  # this rank's place on each axis
    comp_idx: int
    data_group: object | None  # ranks sharing comp_idx; None when data == 1
    comp_group: object | None  # ranks sharing data_idx; None when comp == 1


def init_distributed(device: str | torch.device, backend: str | None = None,
                     init_method: str | None = None, rank: int | None = None,
                     world_size: int | None = None) -> torch.device:
    """Join the default process group (once per process); returns this
    rank's device.

    ``device`` "cuda" places rank r on ``cuda:LOCAL_RANK`` (raises if the
    host has fewer cards); a device with an index ("cuda:0") is used as
    given, for every rank; "cpu" is the CPU. ``backend`` defaults to "nccl"
    on CUDA and "gloo" on the CPU. Without ``init_method`` the rank and
    world size come from ``torchrun``'s environment (``env://``)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        local = int(os.environ.get("LOCAL_RANK", "0"))
        count = torch.cuda.device_count()
        if local >= count:
            raise RuntimeError(f"LOCAL_RANK {local}: this host has {count} CUDA device(s); "
                               "name the device (and backend='gloo') to place several "
                               "ranks on one card")
        device = torch.device("cuda", local)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        backend = backend or ("nccl" if device.type == "cuda" else "gloo")
        if init_method is None:
            dist.init_process_group(backend, init_method="env://")
        else:
            dist.init_process_group(backend, init_method=init_method, rank=rank,
                                    world_size=world_size)
    return device


def make_data_comp_mesh(data: int, comp: int) -> Mesh:
    """The (data, comp) mesh over every rank of the default group
    (data · comp must be the world size). Every rank makes every subgroup,
    in one order, as ``dist.new_group`` requires."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if data * comp != world:
        raise ValueError(f"a {data}x{comp} mesh needs {data * comp} ranks, not {world}")
    data_idx, comp_idx = divmod(rank, comp)
    data_group = comp_group = None
    if data > 1:  # one group per comp column
        for c in range(comp):
            group = dist.new_group([d * comp + c for d in range(data)])
            if c == comp_idx:
                data_group = group
    if comp > 1:  # one group per data row
        for d in range(data):
            group = dist.new_group([d * comp + c for c in range(comp)])
            if d == data_idx:
                comp_group = group
    return Mesh(data, comp, data_idx, comp_idx, data_group, comp_group)


def make_data_mesh() -> Mesh:
    """Every rank along the batch axis."""
    return make_data_comp_mesh(dist.get_world_size(), 1)


def size(group) -> int:
    """Ranks in ``group`` (1 for None)."""
    return 1 if group is None else dist.get_world_size(group)


def index(group) -> int:
    """This rank's place in ``group`` (0 for None)."""
    return 0 if group is None else dist.get_rank(group)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.detach().clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def psum(t: torch.Tensor, group) -> torch.Tensor:
    """Differentiable SUM all-reduce over ``group`` (identity for None):
    forward and backward both sum across the group's ranks."""
    return t if group is None else _Psum.apply(t, group)


def pmax_const(t: torch.Tensor, group) -> torch.Tensor:
    """MAX all-reduce of ``t`` detached (``t`` itself for None, detached)."""
    out = t.detach().clone(memory_format=torch.contiguous_format)
    if group is not None:
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


def psum_tensors(tensors: list[torch.Tensor], group) -> list[torch.Tensor]:
    """SUM all-reduce of several tensors of one dtype and device in one
    collective, without autograd (the tensors themselves for None)."""
    if group is None:
        return list(tensors)
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    return [part.view_as(t) for part, t in
            zip(flat.split([t.numel() for t in tensors]), tensors)]


def all_gather_rows(tensors: list[torch.Tensor], group) -> list[torch.Tensor]:
    """Each rank's equal leading-axis slices, concatenated in group order:
    (K_l, ...) → (K_l · size, ...), by one SUM all-reduce of zero-padded
    copies (adding zeros is exact)."""
    if group is None:
        return list(tensors)
    n, i = size(group), index(group)
    full = []
    for t in tensors:
        pad = t.new_zeros((n * t.shape[0],) + tuple(t.shape[1:]))
        pad[i * t.shape[0]:(i + 1) * t.shape[0]] = t.detach()
        full.append(pad)
    return psum_tensors(full, group)


_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def fold_seed(seed: int, data_idx: int = 0, comp_idx: int = 0) -> int:
    """A seed for the rank at (data_idx, comp_idx) from the shared ``seed``
    (the reference folds its key with each axis index: ``fold_in``), in
    [0, 2⁶³)."""
    x = _splitmix64(seed & _MASK64)
    x = _splitmix64(x ^ data_idx)
    return _splitmix64(x ^ (comp_idx << 32)) >> 1


def _spawned(fn, rank, world, device, backend, init_method, args, results):
    torch.set_num_threads(1)
    os.environ["LOCAL_RANK"] = str(rank)  # one host: device "cuda" puts rank r on cuda:r
    try:
        dev = init_distributed(device, backend, init_method, rank, world)
        # Pickled here, by value: the queue's own pickler would share tensors'
        # memory with this process, which exits next.
        out = pickle.dumps(fn(rank, world, dev, *args))
        # No rank closes its connections before every rank has joined: gloo's
        # rendezvous ends on one rank when its own side of each pair is
        # connected, and a rank that tears down then (a ``fn`` without
        # collectives) closes a pair whose peer is still reading the
        # handshake ("Connection closed by peer" there).
        dist.barrier()
        dist.destroy_process_group()
        results.put((rank, True, out))
    except Exception:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


def spawn(fn: Callable, world: int, device: str = "cpu", backend: str | None = None,
          args: tuple = (), timeout: float = 120.0) -> list:
    """Run ``fn(rank, world, device, *args)`` in ``world`` new processes
    joined into one group, and return their results in rank order.

    ``fn`` must be importable by name (a module-level function) and return
    something picklable (numpy arrays, CPU tensors). Each process sets one
    intra-op thread and ``LOCAL_RANK`` to its rank, so ``device`` "cuda"
    places rank r on ``cuda:r`` as ``init_distributed`` does under
    ``torchrun``. If a rank raises, or the group has not finished within
    ``timeout`` seconds, every process is killed and this raises."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "store")
        procs = [ctx.Process(target=_spawned, daemon=True,
                             args=(fn, r, world, device, backend, init, args, results))
                 for r in range(world)]
        for p in procs:
            p.start()
        out: dict[int, object] = {}
        deadline = time.monotonic() + timeout
        try:
            while len(out) < world:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"spawn: {world} ranks did not finish in {timeout} s")
                try:
                    rank, ok, payload = results.get(timeout=min(left, 1.0))
                except queue_mod.Empty:
                    dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(f"spawn: a rank exited with code {dead[0]}")
                    continue
                if not ok:
                    raise RuntimeError(f"spawn: rank {rank} failed:\n{payload}")
                out[rank] = pickle.loads(payload)
            for p in procs:
                p.join(max(deadline - time.monotonic(), 1.0))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
    return [out[r] for r in range(world)]
