"""Device mesh and sharding helpers over `torch.distributed`.

Counterpart of `gaussctrl_tpu/core/mesh.py`. The parallel axis is the views:
rendering, VAE encoding, inversion and the edit are data parallel over it.
The gaussian-sharded re-optimisation step uses the same one-dimensional
mesh over the gaussians. Where XLA inserted collectives from a
`NamedSharding`, the port gathers explicitly:

  gather_rows     an equal-sized `all_gather` concatenated in rank order;
  AllGatherRows   the same as an autograd function whose backward hands each
                  rank its own rows of the incoming gradient;
  shard_with_refs the view-sharded cross-view batch: each rank runs the
                  reference views plus its share of the others in one batch,
                  so the cross-view attention finds its references without
                  a collective, and the shares are gathered.

Process groups are joined with an explicit timeout, so that a mismatched
collective fails instead of hanging: NCCL where the port's device is the
card (`cuda:{local rank}`), gloo on the CPU. `make_mesh` creates a group of
one itself when none exists. `spawn_ranks` runs a function in n processes
that join one group through a rendezvous file (`torch.multiprocessing`).

`enable_persistent_cache` has no counterpart: it turns on XLA's compile
cache. The port's kernels are built once per hash of their sources into
`gaussctrl_tpu_torch/_build/` (`ops/_lib.py`), which is their cache.
"""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile
import time
from typing import TYPE_CHECKING

import torch
import torch.distributed as dist

from gaussctrl_tpu_torch.device import resolve_device

if TYPE_CHECKING:
    from torch.distributed.device_mesh import DeviceMesh

VIEW_AXIS = "view"


def init_group(rank: int, world_size: int, init_method: str | None = None,
               device=None, backend: str | None = None,
               timeout_s: float = 600.0, store=None) -> torch.device:
    """Join the default process group as `rank` of `world_size` and return
    this rank's device: `cuda:{rank % cards}` (set as the current card) or
    the CPU. The backend is NCCL on the card and gloo on the CPU unless
    `backend` names one. A collective that waits longer than `timeout_s`
    raises."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(
        backend, init_method=init_method, store=store, rank=rank,
        world_size=world_size, timeout=datetime.timedelta(seconds=timeout_s),
        device_id=dev if backend == "nccl" else None)
    return dev


def make_mesh(device_type=None, axis_name: str = VIEW_AXIS) -> DeviceMesh:
    """A 1-D mesh over the ranks of the current process group; the card
    unless `device_type` is "cpu". Without a group, a group of one is
    created (in memory: no file, no port), where every gather is a copy."""
    from torch.distributed.device_mesh import init_device_mesh
    dev = resolve_device(device_type)
    if not dist.is_initialized():
        init_group(0, 1, device=dev, store=dist.HashStore())
    return init_device_mesh(dev.type, (dist.get_world_size(),),
                            mesh_dim_names=(axis_name,))


def _require_1d(mesh: DeviceMesh) -> None:
    if mesh.ndim != 1:
        raise ValueError(f"the port's meshes are 1-D, not {mesh.ndim}-D")


def shard_views(mesh: DeviceMesh) -> list:
    """The placements that split the leading (view or gaussian) dimension
    over the 1-D mesh, what `NamedSharding(mesh, P("view"))` says."""
    from torch.distributed.tensor import Shard
    _require_1d(mesh)
    return [Shard(0)]


def replicate(mesh: DeviceMesh) -> list:
    """Full replication over the 1-D mesh (weights, reference views)."""
    from torch.distributed.tensor import Replicate
    _require_1d(mesh)
    return [Replicate()]


def pad_to_multiple(n: int, m: int) -> int:
    """Round `n` up to a multiple of `m`."""
    return ((n + m - 1) // m) * m


def rows_of_rank(n: int, mesh: DeviceMesh) -> slice:
    """This rank's contiguous share of `n` rows, which must divide evenly."""
    w = mesh.size()
    if n % w:
        raise ValueError(f"{n} rows do not split over {w} ranks; pad them to "
                         f"{pad_to_multiple(n, w)}")
    per = n // w
    r = mesh.get_local_rank()
    return slice(r * per, (r + 1) * per)


def gather_rows(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """Every rank's `x` (one shape on all ranks) concatenated along the
    first dimension in rank order."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size())]
    dist.all_gather(parts, x, group=mesh.get_group())
    return torch.cat(parts)


class AllGatherRows(torch.autograd.Function):
    """`gather_rows` with a backward that returns this rank's rows of the
    incoming gradient. What follows the gather must be computed alike on
    every rank (replicated), so that each holds the whole, equal gradient
    and keeps its own rows: no reduction is needed."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.rows = rows_of_rank(x.shape[0] * mesh.size(), mesh)
        return gather_rows(x, mesh)

    @staticmethod
    def backward(ctx, grad):
        return grad[ctx.rows].contiguous(), None


def share_of(items: list, mesh: DeviceMesh | None) -> list:
    """This rank's contiguous share of `items`, the list padded by repeating
    its last item up to a multiple of the mesh size; all of it without a
    mesh."""
    if mesh is None or not items:
        return list(items)
    padded = items + [items[-1]] * (pad_to_multiple(len(items), mesh.size())
                                    - len(items))
    return padded[rows_of_rank(len(padded), mesh)]


def gather_share(x: torch.Tensor, n: int, mesh: DeviceMesh | None) -> torch.Tensor:
    """The rows of every rank's share (`share_of` of n items) in order, the
    padding dropped; `x` itself without a mesh."""
    return x if mesh is None else gather_rows(x, mesh)[:n]


def shard_with_refs(fn, refs: list, others: list, mesh: DeviceMesh | None,
                    *xs: torch.Tensor):
    """`fn` over a cross-view batch whose first len(refs) views are the
    references, sharded over the views: each rank calls `fn(*(x[batch] for
    x in xs))` once with batch = refs + its share of `others`, and the
    outputs of the shares are gathered. This computes the same function as
    one batch of all views, because a reference row's output depends on
    reference rows only (self and reference attention over the refs,
    per-sample norms and convolutions); only the rounding of batched
    operations may differ. Returns (the refs' outputs, the others' outputs
    in the order of `others`)."""
    batch = refs + share_of(others, mesh)
    out = fn(*(x[batch] for x in xs))
    r = len(refs)
    return out[:r], gather_share(out[r:], len(others), mesh)


def _rank_main(rank, fn, world_size, init_method, device, backend,
               group_timeout_s, args, out_dir):
    init_group(rank, world_size, init_method, device, backend, group_timeout_s)
    try:
        out = fn(*args)
    finally:
        dist.destroy_process_group()
    # pickled to a file, by value: a tensor sent through a queue as it is
    # would be shared by a file descriptor that dies with this process
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def spawn_ranks(fn, world_size: int, args: tuple = (), device=None,
                backend: str | None = None, timeout_s: float = 300.0,
                group_timeout_s: float = 60.0) -> list:
    """Run `fn(*args)` in `world_size` spawned processes that have joined one
    process group (`init_group` on `device`, the card unless it is "cpu",
    through a rendezvous file in a temporary directory) and return their
    results in rank order. `fn` must be importable and its result
    picklable. A rank that raises or dies fails the call with its
    traceback, as does a call that outlasts `timeout_s`; every rank is
    stopped."""
    import torch.multiprocessing as mp
    dev = str(resolve_device(device))
    with tempfile.TemporaryDirectory(prefix="gaussctrl_ranks_") as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        ctx = mp.start_processes(
            _rank_main, nprocs=world_size, join=False, daemon=True,
            args=(fn, world_size, init, dev, backend, group_timeout_s, args,
                  tmp))
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(max(0.0, deadline - time.monotonic()),
                               grace_period=5.0):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"{world_size} ranks did not finish in "
                                       f"{timeout_s:.0f} s")
        except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
            raise RuntimeError(f"rank {e.error_index} of {world_size} failed:"
                               f"\n{e}") from None
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        out = []
        for r in range(world_size):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    return out
