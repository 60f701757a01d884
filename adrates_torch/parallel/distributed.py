"""Process groups, the book mesh and the collectives of the sharded paths.

Port of ``adrates_tpu/parallel/distributed.py`` onto ``torch.distributed``.
The design is the JAX package's: the book's trades are the only large
axis, so they shard over every rank; the quotes, the curve graph and the
aggregate are replicated, and the only collectives are the book's
[S] total-PV, [S, N] delta and [S, N, N] gamma reductions (and, for the
tests and reports, gathers of per-trade shards). Each rank runs its own
trades' PVs and ladders on K1 and its own trades' gammas on K3.

Usage, one process per GPU (``torchrun --nproc-per-node=<gpus>
script.py``, which sets ``MASTER_ADDR`` / ``MASTER_PORT``, ``WORLD_SIZE``,
``RANK``, ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE``)::

    from adrates_torch.parallel import distributed as dist
    dist.init_distributed()              # from torchrun's environment
    mesh = dist.book_mesh()              # ("book",) or ("dcn", "book")
    axis = mesh.mesh_dim_names           # every axis: the whole mesh
    fn = make_sharded_multibook_fn(mb, mesh, axis=axis)

or at world 1 on one card (the group is made; the call returns False, as
one process is not a multi-process runtime)::

    dist.init_distributed(address="127.0.0.1:29500", world_size=1, rank=0)

``run_ranks`` spawns a world of gloo ranks on this host over a file store,
with a timeout on every rank (the CPU tests run the sharded paths so, and
the smoke script a world sharing one card).
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import queue
import tempfile
import time
import traceback
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import resolve_device
from ..utils.error import LibError

# Seconds a collective may wait for the other ranks before it fails, so a
# rank that dies cannot hang the others forever.
DEFAULT_TIMEOUT_S = 300.0


def _init_method(address: str) -> str:
    return address if "://" in address else f"tcp://{address}"


def init_distributed(address: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     backend: Optional[str] = None, device=None,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Initialize the default process group; returns True when a group
    of more than one rank is active after the call, as the JAX function
    returns ``jax.process_count() > 1``.

    Explicit arguments come first: ``address`` is ``host:port`` (a TCP
    store) or an init-method URL (``tcp://...``, ``file://...``), with
    ``world_size`` and ``rank``. Otherwise torchrun's environment
    (``MASTER_ADDR`` / ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``). With
    neither it is a no-op and returns False, as the JAX function is
    single-process. An explicit world of 1 still makes its group (as
    ``jax.distributed.initialize(num_processes=1)`` does) and returns
    False; with a group already active it changes nothing and returns
    whether that group has more than one rank. ``backend`` defaults to
    "nccl" for a CUDA ``device`` (None: the card, ``utils/device.py``)
    and "gloo" for the CPU; on NCCL each rank takes the card
    ``LOCAL_RANK`` (else ``rank`` modulo the cards visible). Every
    collective of the group fails after ``timeout_s`` seconds."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = os.environ
    if address is None:
        if not (env.get("MASTER_ADDR") and env.get("WORLD_SIZE")):
            return False
        init_method = "env://"
        world_size = int(env["WORLD_SIZE"]) if world_size is None \
            else world_size
        rank = int(env.get("RANK", "0")) if rank is None else rank
    else:
        if world_size is None or rank is None:
            raise LibError("init_distributed: an explicit address needs "
                           "world_size and rank")
        init_method = _init_method(address)
    if backend is None:
        backend = "nccl" if resolve_device(device).type == "cuda" \
            else "gloo"
    if backend == "nccl":
        local = env.get("LOCAL_RANK")
        torch.cuda.set_device(int(local) if local is not None
                              else rank % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=init_method, world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    return dist.get_world_size() > 1


def book_mesh(book_axis: str = "book", dcn_axis: str = "dcn"):
    """A ``DeviceMesh`` over every rank of the default group, for
    trade-sharded books: 1-D ``(book,)`` on one host, 2-D ``(dcn, book)``
    when the world spans hosts (``LOCAL_WORLD_SIZE`` < ``WORLD_SIZE``),
    ``book`` over the ranks of a host and ``dcn`` over the hosts, so a
    ``book`` shard never straddles hosts (``adrates_tpu``
    ``distributed.py:68-99``). The mesh's device type follows the
    group's backend (NCCL: "cuda"; gloo: "cpu")."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise LibError("book_mesh: no process group (init_distributed)")
    world = dist.get_world_size()
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    if local < world:
        if world % local:
            raise LibError(f"book_mesh: {world} ranks are not whole hosts "
                           f"of {local}")
        return init_device_mesh(kind, (world // local, local),
                                mesh_dim_names=(dcn_axis, book_axis))
    return init_device_mesh(kind, (world,), mesh_dim_names=(book_axis,))


class ShardAxis:
    """A mesh axis (or every axis of it) the book's trades shard over:
    ``n`` shards, this rank's ``index`` among them, and the process
    ``group`` that reduces over them. ``axis`` is one mesh axis name, or
    a tuple of every axis name of the mesh (the whole mesh, shards in
    row-major order of the given axes)."""

    def __init__(self, mesh, axis="book"):
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        names = tuple(mesh.mesh_dim_names or ())
        if any(a not in names for a in axes):
            raise LibError(f"axis {axes} is not of the mesh {names}")
        coord = mesh.get_coordinate()
        if coord is None:
            raise LibError("this rank is not in the mesh")
        if len(axes) == 1:
            self.group = mesh.get_group(axes[0])
        elif sorted(axes) == sorted(names):
            ranks = sorted(mesh.mesh.flatten().tolist())
            self.group = dist.group.WORLD \
                if ranks == list(range(dist.get_world_size())) \
                else dist.new_group(ranks)
        else:
            raise LibError("a tuple of mesh axes must name every axis of "
                           "the mesh")
        dims = [names.index(a) for a in axes]
        sizes = [mesh.size(d) for d in dims]
        self.n = int(np.prod(sizes))
        self.index = int(np.ravel_multi_index([coord[d] for d in dims],
                                              sizes))


def all_reduce(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``t`` over ``group``'s ranks (``t`` itself, summed in
    place, when it is contiguous). A group on NCCL reduces the tensor
    where it lies (the card); a gloo group reduces a host copy and
    writes it back (the transport the caller chose by the backend, not a
    fallback: the computation stays where the tensors live)."""
    t = t.contiguous()
    if dist.get_backend(group) == "nccl" or t.device.type == "cpu":
        dist.all_reduce(t, group=group)
        return t
    host = t.cpu()
    dist.all_reduce(host, group=group)
    t.copy_(host)
    return t


def all_gather(t: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """The ranks' ``t`` of ``group`` concatenated along ``dim`` in rank
    order (their sizes along ``dim`` may differ; the other dims must
    agree), on ``t``'s device; host copies on a gloo group, as
    :func:`all_reduce`."""
    host = dist.get_backend(group) != "nccl" and t.device.type != "cpu"
    x = (t.cpu() if host else t).movedim(dim, 0).contiguous()
    n = dist.get_world_size(group)
    size = torch.tensor([x.shape[0]], dtype=torch.int64, device=x.device)
    sizes = [torch.empty_like(size) for _ in range(n)]
    dist.all_gather(sizes, size, group=group)
    sizes = [int(s) for s in sizes]
    pad = x.new_zeros((max(sizes),) + tuple(x.shape[1:]))
    pad[:x.shape[0]] = x
    parts = [torch.empty_like(pad) for _ in range(n)]
    dist.all_gather(parts, pad, group=group)
    out = torch.cat([p[:k] for p, k in zip(parts, sizes)]).movedim(0, dim)
    return out.to(t.device) if host else out


# ---------------------------------------------------------------------------
# spawning a world of ranks on one host
# ---------------------------------------------------------------------------


def _rank_entry(rank: int, world: int, store: str, timeout_s: float,
                threads: Optional[int], target, args, results):
    """One spawned rank: the gloo group over the file store, ``target(rank,
    world, *args)``, its result or its traceback on ``results``.

    A rank leaves ``init_distributed`` once its own side of each
    connection is made, while a peer can still be making its side; a
    rank that then closed its group (the target's destroy, or this
    function's on exit) would break the peer's connect ("Connection
    closed by peer"). So the ranks meet in a barrier on the new group
    before the target runs, and again on the group active after it (the
    target may make a new one) before any rank reports and exits."""
    try:
        if threads:
            torch.set_num_threads(threads)
        init_distributed(address=store, world_size=world, rank=rank,
                         backend="gloo", timeout_s=timeout_s)
        dist.barrier()
        out = target(rank, world, *args)
        if dist.is_initialized():
            dist.barrier()
        results.put((rank, True, out))
    except BaseException:                  # reported to the parent
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(world: int, target, args: Sequence = (),
              timeout_s: float = 600.0, threads: Optional[int] = 1) -> list:
    """Run ``target(rank, world, *args)`` in ``world`` spawned processes
    on this host, each in one gloo process group over a file store (in a
    temporary directory), and return their results in rank order. The
    target picks its own device (gloo moves host copies of card tensors,
    :func:`all_reduce`). ``target`` and its results must pickle (a
    function of an importable module; numpy or CPU tensors). Each rank
    uses ``threads`` intra-op threads (None: torch's default).

    Guarded: every collective fails after ``timeout_s``; when a rank
    raises or dies, or the world does not finish within ``timeout_s``,
    the survivors are terminated (then killed) and this raises
    ``RuntimeError`` with the failing rank's traceback."""
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        results = ctx.Queue()
        procs = [ctx.Process(
            target=_rank_entry,
            args=(r, world, f"file://{tmp}/store", timeout_s, threads,
                  target, tuple(args), results),
            daemon=True) for r in range(world)]
        for p in procs:
            p.start()
        done, failure = {}, None
        deadline = time.monotonic() + timeout_s
        try:
            while len(done) < world and failure is None:
                left = deadline - time.monotonic()
                if left <= 0:
                    failure = (f"timed out after {timeout_s:g} s with ranks "
                               f"{sorted(set(range(world)) - set(done))} "
                               f"unfinished")
                    break
                try:
                    rank, ok, out = results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in done and p.exitcode is not None]
                    if dead:
                        failure = (f"ranks {dead} exited with codes "
                                   f"{[procs[r].exitcode for r in dead]} "
                                   f"and no result")
                    continue
                if ok:
                    done[rank] = out
                else:
                    failure = f"rank {rank} failed:\n{out}"
        finally:
            for p in procs:
                p.join(timeout=5.0 if failure is None else 0.1)
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=5.0)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=5.0)
            results.close()
        if failure is not None:
            raise RuntimeError(f"run_ranks(world={world}): {failure}")
    return [done[r] for r in range(world)]
