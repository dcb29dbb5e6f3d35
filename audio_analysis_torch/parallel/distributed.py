"""Scale-out over torch.distributed (the JAX package's
parallel/distributed.py).

The JAX package runs ONE SPMD program over every chip on every host: each
process feeds its own recordings into global arrays, XLA shards the window
grid along 'data' and inserts the collectives, and the results are
all-gathered so that process 0 can write them (the reference CLI's
single-writer contract, analyse.py:454-468). The port runs one process per
device instead, joined into one process group:

- ``initialize()`` joins this process to the group (torchrun's environment,
  or explicit arguments) and selects its device;
- ``global_mesh()`` builds the ('data', 'model') mesh over every rank;
- each rank runs the single-device path on its own recordings, and the
  ranks exchange host values only: ``allgather_host_values`` (the
  per-rank batch checks) and ``allgather_results`` (the global result list,
  in rank order, on every rank);
- training all-reduces the gradients and BatchNorm's sums over 'data'
  (the sums through ``torch.distributed.nn.functional.all_reduce``, which
  autograd flows through) and sums the head's partial logits over 'model'
  (``copy_to_group`` / ``reduce_from_group``).

The backend is NCCL for CUDA ranks and gloo for CPU ranks unless the caller
names one: two ranks on one card need gloo, because NCCL refuses two ranks
on one GPU. Nothing picks another backend or device on its own. Gloo
reduces CUDA tensors but gathers none, so host values travel as objects.

``make_global_batch``, ``local_slice``, ``local_offset``, ``replicated_np``
and ``replicate`` build or read global jax.Arrays; a process-per-device
program has none (a rank's tensors are its own rows), so they have no
counterpart here.
"""

import datetime
import logging
import multiprocessing
import os
import pickle
import tempfile
import time
from pathlib import Path

import torch
import torch.distributed as dist

from audio_analysis_torch.device import resolve_device
from audio_analysis_torch.parallel.mesh import make_mesh

TIMEOUT_S = 120  # a collective that waits longer fails instead of hanging


def initialize(coordinator_address=None, num_processes=None, process_id=None,
               local_device_ids=None, backend=None, timeout=TIMEOUT_S, device=None):
    """Join this process to the process group and return its device.

    The arguments default from torchrun's environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``); with
    none of it, a world of one. `coordinator_address`: ``host:port``, or an
    init method URL (``tcp://...``, ``file://...``). `local_device_ids`:
    this process's GPU (one); by default ``LOCAL_RANK``, or the rank modulo
    the visible GPUs. `device`: None means ``cuda``; ``cpu`` for CPU ranks.
    `backend`: None means ``nccl`` on CUDA and ``gloo`` on the CPU.
    `timeout`: seconds a collective may wait before it fails."""
    dev = resolve_device(device)
    rank = int(process_id if process_id is not None else os.environ.get("RANK", 0))
    world = int(num_processes if num_processes is not None else os.environ.get("WORLD_SIZE", 1))
    if dev.type == "cuda":
        if local_device_ids is not None:
            index = int(list(local_device_ids)[0])
        else:
            index = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(index)
        dev = torch.device("cuda", index)
    kwargs = dict(backend=backend or ("nccl" if dev.type == "cuda" else "gloo"),
                  rank=rank, world_size=world,
                  timeout=datetime.timedelta(seconds=timeout))
    if coordinator_address is not None:
        addr = str(coordinator_address)
        kwargs["init_method"] = addr if "://" in addr else f"tcp://{addr}"
    elif "MASTER_ADDR" in os.environ:
        kwargs["init_method"] = "env://"
    elif world == 1:
        kwargs["store"] = dist.HashStore()
    else:
        raise ValueError(f"a world of {world} ranks needs a coordinator_address or "
                         "torchrun's MASTER_ADDR/MASTER_PORT")
    dist.init_process_group(**kwargs)
    logging.info("distributed: rank %d/%d on %s (%s)", rank, world, dev, kwargs["backend"])
    return dev


def shutdown():
    """Leave the process group (no-op when none was joined)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def is_multihost() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def global_mesh(model_parallel=1, device_type=None):
    """('data', 'model') mesh over every rank."""
    return make_mesh(model_parallel=model_parallel, device_type=device_type)


def allgather_host_values(value, group=None):
    """All-gather a small per-rank int: a list indexed by rank in `group`
    (default: every rank)."""
    if not dist.is_initialized():
        return [int(value)]
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, int(value), group=group)
    return out


def allgather_results(results_local, group=None):
    """All-gather a per-rank list of JSON-able objects: the concatenated
    list, in rank order, on every rank of `group` (default: every rank)."""
    if not dist.is_initialized():
        return list(results_local)
    parts = [None] * dist.get_world_size(group)
    dist.all_gather_object(parts, list(results_local), group=group)
    return [r for part in parts for r in part]


class _CopyToGroup(torch.autograd.Function):
    """Identity forward; the gradient summed over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromGroup(torch.autograd.Function):
    """Sum over the group forward; the gradient passed through unchanged."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_group(x, group):
    """`x`, the same on every rank of `group`, fed to a layer split over
    the group: each rank's slice contributes a part of x's gradient, and
    the backward sums the parts."""
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x, group):
    """The sum of per-rank partial results over `group`, where every rank
    then computes the same loss from it: the backward hands each rank the
    gradient unchanged (an all-reduce there would count it once a rank)."""
    return _ReduceFromGroup.apply(x, group)


def all_reduce_tensors(tensors, group):
    """Sum a list of tensors over `group` in place, in one collective."""
    tensors = list(tensors)
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(part.view_as(t))


# -- ranks in fresh processes ---------------------------------------------------


def _rank_main(fn, args, rank, nprocs, init_file, device, backend, out):
    torch.set_num_threads(1)
    initialize(f"file://{init_file}", nprocs, rank, backend=backend, device=device)
    try:
        result = fn(*args)
    finally:
        shutdown()
    with open(out, "wb") as f:
        pickle.dump(result, f)


def spawn(fn, nprocs, args=(), device=None, backend=None, deadline=600):
    """Run ``fn(*args)`` in `nprocs` fresh processes (the spawn start
    method: a forked child of a process that has used CUDA is undefined),
    joined as ranks 0..nprocs-1 of one process group through a file in a
    temporary directory, each with one intra-op thread; `device` and
    `backend` as ``initialize`` takes them (CUDA ranks round-robin over the
    visible GPUs). `fn` must be importable by its module path. Returns each
    rank's return value, in rank order.

    Raises RuntimeError when a rank fails or exits without a result, or
    when the ranks are not all done after `deadline` seconds; every rank
    still running is killed first."""
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="aat_ranks_") as tmp:
        tmp = Path(tmp)
        outs = [tmp / f"rank{r}.pkl" for r in range(nprocs)]
        procs = [ctx.Process(target=_rank_main, args=(
            fn, tuple(args), r, nprocs, str(tmp / "init"), device, backend, str(outs[r])))
            for r in range(nprocs)]
        for p in procs:
            p.start()
        end = time.monotonic() + deadline
        try:
            while any(p.is_alive() for p in procs):
                failed = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
                if failed:
                    raise RuntimeError(f"rank(s) {failed} failed: exit codes "
                                       f"{[p.exitcode for p in procs]}")
                if time.monotonic() > end:
                    raise RuntimeError(f"ranks not done after {deadline} s: exit codes "
                                       f"{[p.exitcode for p in procs]}")
                time.sleep(0.05)
            codes = [p.exitcode for p in procs]
            if any(codes) or not all(o.exists() for o in outs):
                raise RuntimeError(f"ranks failed: exit codes {codes}")
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join(10)
        results = []
        for o in outs:
            with open(o, "rb") as f:
                results.append(pickle.load(f))
        return results
