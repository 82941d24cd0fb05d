"""Data parallelism over torch.distributed (counterpart of funcodec_tpu/parallel/mesh.py).

The JAX package shards the batch over a 1-D "data" mesh, keeps the state
replicated, and lets GSPMD insert the collectives. Here each rank is one
process with a replica of the state and a contiguous block of the global
batch: rank r of N holds rows [r * B / N, (r + 1) * B / N), the layout of
``PartitionSpec("data")``, so a global row index (what a draw picks) names
one rank's local row. A ``DataGroup`` goes wherever the JAX package passes a
mesh; None means one process, and every helper here is then the identity.

What GSPMD makes global is made global explicitly, and every collective is
an ``all_reduce`` (sum) or a ``broadcast``:

- gradients: ``all_reduce_mean`` over one flat buffer an optimizer turn
  (statistics: ``sum_over_ranks`` of one stacked buffer);
- loss terms: ``global_sum`` / ``global_mean``, differentiable: the forward
  is the all-reduced value, the backward scales the gradient so that the
  mean of the ranks' gradients is the gradient of the global loss;
- random draws: at the global batch's shape from a generator that every
  rank seeds alike, each rank keeping its rows (``draw_rows``), so a draw
  is the draw one process makes;
- rows picked by global index (k-means seeds, expiry rows):
  ``gather_rows``, an all_reduce of a zero-filled buffer into which each
  rank writes the rows it owns.

The backend follows the device: NCCL on CUDA, gloo on the CPU; a failed
NCCL initialisation raises. ``init_process_group(backend="gloo")`` over CUDA
tensors is what runs two ranks on one card, which NCCL refuses.

Training runs one process per rank: ``init_process_group`` takes torchrun's
environment or explicit arguments, and ``spawn_ranks`` starts the processes
on one host. Serving needs no collective: cli/codec_inference's
Speech2Token drives one replica per card from one process.
"""

from __future__ import annotations

import dataclasses
import datetime
import multiprocessing
import os
import time
import uuid
from pathlib import Path
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

Device = Union[str, torch.device]


@dataclasses.dataclass(frozen=True)
class DataGroup:
    """This process's place in the data-parallel group: its rank, the world
    size, the device its replica lives on and the backend's name. The
    collectives run on the default process group."""

    rank: int
    world: int
    device: torch.device
    backend: str


def rank_of(group: Optional[DataGroup]) -> int:
    return 0 if group is None else group.rank


def world_of(group: Optional[DataGroup]) -> int:
    return 1 if group is None else group.world


def is_writer(group: Optional[DataGroup]) -> bool:
    """Whether this process writes the files of a run (rank 0, or no group)."""
    return rank_of(group) == 0


def backend_for(device: Device) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_process_group(
    device: Optional[Device] = None,
    *,
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    backend: Optional[str] = None,
    timeout_s: float = 1800.0,
) -> DataGroup:
    """Join the default process group (the counterpart of
    ``initialize_multihost``, mesh.py:29-40) and return this rank's group.

    Without `world_size` and `rank` it reads torchrun's environment (RANK,
    WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT); the device is then
    cuda:LOCAL_RANK. `backend` defaults to ``backend_for(device)``."""
    if world_size is None or rank is None:
        env = os.environ
        if "WORLD_SIZE" not in env or "RANK" not in env:
            raise ValueError("no world_size / rank given and no torchrun environment (WORLD_SIZE, RANK)")
        world_size, rank = int(env["WORLD_SIZE"]), int(env["RANK"])
        init_method = init_method or "env://"
        if device is None:
            device = torch.device("cuda", int(env.get("LOCAL_RANK", rank)))
    if device is None:
        raise ValueError("init_process_group needs the device of this rank's replica")
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = backend or backend_for(device)
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return DataGroup(rank=rank, world=world_size, device=device, backend=backend)


def destroy_process_group(group: Optional[DataGroup]) -> None:
    if group is not None and dist.is_initialized():
        dist.destroy_process_group()


def file_init_method(directory: Union[str, Path]) -> str:
    """A fresh ``file://`` rendezvous under `directory` (no port to pick)."""
    path = Path(directory).resolve() / f".rendezvous-{uuid.uuid4().hex}"
    return f"file://{path}"


def spawn_ranks(fn: Callable[..., Any], world: int, args: Sequence[Any] = (),
                timeout_s: Optional[float] = None) -> None:
    """Run ``fn(rank, world, *args)`` in `world` spawned processes and wait
    for them. Raises when a rank exits with an error (the others, which
    would wait in a collective, are stopped) or when `timeout_s` passes.
    `fn` must be importable by name: the processes start from a fresh
    import."""
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=fn, args=(r, world, *args), name=f"rank{r}") for r in range(world)]
    for p in procs:
        p.start()
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    try:
        while True:
            failed = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
            if failed:
                raise RuntimeError(f"rank {failed[0][0]} of {world} exited with code {failed[0][1]}")
            if all(p.exitcode == 0 for p in procs):
                return
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks did not finish within {timeout_s} s")
            next(p for p in procs if p.exitcode is None).join(0.05)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join()


def data_world_size(batch_size: Optional[int], max_devices: int) -> int:
    """The largest process count up to `max_devices` that divides the batch
    (the rule of data_mesh and cli/codec_train.make_mesh); 1 at least."""
    n = max(1, int(max_devices))
    if batch_size is not None:
        while n > 1 and batch_size % n != 0:
            n -= 1
    return n


# ---------------------------------------------------------------------------
# rows
# ---------------------------------------------------------------------------


def _block(n_global: int, group: Optional[DataGroup], uneven: bool = False) -> slice:
    """This rank's contiguous block of n_global rows."""
    world, rank = world_of(group), rank_of(group)
    if world == 1:
        return slice(0, n_global)
    if not uneven:
        if n_global % world:
            raise ValueError(f"{n_global} rows do not split over {world} ranks in equal blocks")
        b = n_global // world
        return slice(rank * b, (rank + 1) * b)
    base, extra = divmod(n_global, world)  # np.array_split's blocks
    lo = rank * base + min(rank, extra)
    return slice(lo, lo + base + (rank < extra))


def local_rows(t, group: Optional[DataGroup], uneven: bool = False):
    """This rank's block of the rows of `t` (a tensor, an array or a list of
    keys, at the global batch's length). Equal blocks unless `uneven`
    (np.array_split's)."""
    return t if group is None else t[_block(len(t), group, uneven)]


def draw_rows(draw: Callable[[int], torch.Tensor], n_local: int, group: Optional[DataGroup]) -> torch.Tensor:
    """``draw(global rows)``'s rows of this rank: a draw at the global batch's
    shape, which every rank makes alike from its alike-seeded generator."""
    return local_rows(draw(n_local * world_of(group)), group)


def to_device(a, device: Device) -> torch.Tensor:
    """An array or tensor on `device`; a host array reaches a card through
    pinned memory without blocking, so it queues behind the work issued."""
    device = torch.device(device)
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
    if t.device == device:
        return t
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def shard_rows(batch: Mapping[str, Any], group: Optional[DataGroup],
               device: Optional[Device] = None) -> Dict[str, torch.Tensor]:
    """This rank's equal block of the rows of each entry of a global batch
    (the per-rank means of the losses then average to the global ones), on
    `device` (the group's by default): the counterpart of ``put_batch``
    (mesh.py:59-101). Host arrays are cut before the upload; a tensor
    already on the device is cut there."""
    device = device if device is not None else group.device
    return {k: to_device(local_rows(v, group), device) for k, v in batch.items()}


def owned_rows(idx: torch.Tensor, n_local: int, group: Optional[DataGroup]) -> Tuple[torch.Tensor, torch.Tensor]:
    """For global row indices `idx` into blocks of n_local rows: (the local
    index, clamped into range, and whether this rank owns the row)."""
    local = idx - rank_of(group) * n_local
    mine = (local >= 0) & (local < n_local)
    return local.clamp(0, n_local - 1), mine


def gather_rows(samples: torch.Tensor, idx: torch.Tensor, group: Optional[DataGroup]) -> torch.Tensor:
    """Rows `idx` of the global (world * N, ...) array of which this rank
    holds `samples` (N, ...): each rank writes the rows it owns into a
    zero-filled buffer, and an all_reduce assembles them (sums with zeros
    are exact)."""
    if group is None:
        return samples[idx.to(samples.device)]
    local, mine = owned_rows(idx.to(samples.device), samples.shape[0], group)
    picked = samples[local]
    mine = mine.reshape(*mine.shape, *([1] * (picked.dim() - mine.dim())))
    return sum_over_ranks(torch.where(mine, picked, torch.zeros_like(picked)), group)


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------


def sum_over_ranks(t: torch.Tensor, group: Optional[DataGroup]) -> torch.Tensor:
    """`t` summed over the ranks, in place (one all_reduce); returns `t`."""
    if group is not None:
        dist.all_reduce(t)
    return t


def all_reduce_mean(tensors: Sequence[torch.Tensor], group: Optional[DataGroup]) -> List[torch.Tensor]:
    """The ranks' mean of each tensor (the gradients of an optimizer turn),
    in place, in ONE all_reduce of a flat buffer (one dtype); returns the
    list."""
    tensors = list(tensors)
    if group is None or not tensors:
        return tensors
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1:
        raise ValueError(f"one flat buffer holds one dtype, got {sorted(map(str, dtypes))}")
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat)
    flat.div_(group.world)
    parts = flat.split([t.numel() for t in tensors])
    # copied back into the callers' tensors: each keeps its own storage, so
    # what reads them next sees the layout it saw without a group
    torch._foreach_copy_(tensors, [p.view_as(t) for p, t in zip(parts, tensors)])
    return tensors


class _GlobalSum(torch.autograd.Function):
    """y = the sum of x over the ranks on every rank. Each rank's loss is
    then a function of y; the backward gives each rank world * dL/dy, so the
    mean of the ranks' gradients (the gradient all_reduce) is dL/dy * sum of
    the ranks' dx/dtheta: the gradient of the one global loss."""

    @staticmethod
    def forward(ctx, x, group: DataGroup):
        ctx.world = group.world
        y = x.detach().clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, grad):
        return grad * ctx.world, None


def global_sum(x: torch.Tensor, group: Optional[DataGroup]) -> torch.Tensor:
    """x summed over the ranks (differentiable, see _GlobalSum)."""
    return x if group is None else _GlobalSum.apply(x, group)


def global_mean(x: torch.Tensor, group: Optional[DataGroup]) -> torch.Tensor:
    """The ranks' mean of x (differentiable): a per-rank mean over an equal
    block of rows becomes the global batch's mean, with the gradient of it."""
    return x if group is None else _GlobalSum.apply(x, group) / group.world


def barrier(group: Optional[DataGroup]) -> None:
    """Wait on the host until every rank got here (an all_reduce read back)."""
    if group is not None:
        float(sum_over_ranks(torch.zeros(1, device=group.device), group))


def broadcast_value(value: float, group: Optional[DataGroup], src: int = 0) -> float:
    """Rank `src`'s value on every rank (a host decision all ranks follow)."""
    if group is None:
        return value
    t = torch.tensor([float(value)], dtype=torch.float64, device=group.device)
    dist.broadcast(t, src)
    return float(t)
