"""Data parallelism over processes, one per card.

Counterpart of ``vrvq_tpu/parallel/mesh.py``. The JAX package puts the
devices on a 1-D ``data`` mesh, shards each batch over it and lets XLA insert
the gradient sums. PyTorch's idiom is one process per card in a
``torch.distributed`` process group: each rank loads its rows of every
global batch (``local_rows``), runs the step on them, and the gradients are
averaged over the ranks (``all_reduce_mean_``) between each backward and the
optimizer step, so every rank takes the single-card update of the global
batch. NCCL on the card, gloo on the CPU (or, when asked, on CUDA tensors).

The ranks come from torchrun's environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) as it is, or from the JAX
trainer's flags, which count hosts: ``--coordinator host:port
--num_processes H --process_id h`` with C cards a host is a world of H x C
ranks, rank h x C + local rank (``layout``). ``spawn`` starts one process a
card on this host.

ZeRO (``zero_optimizer``): AdamW's state sharded over the ranks by
``torch.distributed.optim.ZeroRedundancyOptimizer``, the counterpart of
``zero_shard_opt_state``; the parameters stay replicated.
"""

from __future__ import annotations

import dataclasses
import multiprocessing
import multiprocessing.connection
import os
import socket
import time
from typing import Any, Callable, Iterable, List, Mapping, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

BUCKET_BYTES = 32 * 2 ** 20  # the flat buckets of a gradient all-reduce


@dataclasses.dataclass(frozen=True)
class Layout:
    """This process's place in the process group."""

    rank: int
    world: int
    local_rank: int
    init_method: str


def layout(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
           process_id: Optional[int] = None, local_rank: Optional[int] = None,
           cards: int = 1, env: Optional[Mapping[str, str]] = None) -> Layout:
    """The ranks of JAX's multi-host flags (``coordinator`` ``host:port``,
    ``num_processes`` hosts, this host's ``process_id``, ``cards`` processes
    a host), or else of torchrun's environment ``env`` (``os.environ`` by
    default); this process's ``local_rank`` is ``LOCAL_RANK`` (or 0) unless
    given."""
    env = os.environ if env is None else env
    if coordinator is None and (num_processes is not None or process_id is not None):
        raise ValueError("num_processes and process_id need a coordinator "
                         "(host:port of process 0)")
    if coordinator is not None:
        hosts, host = int(num_processes or 1), int(process_id or 0)
        local = int(env.get("LOCAL_RANK", 0) if local_rank is None else local_rank)
        if not (0 <= host < hosts and 0 <= local < cards):
            raise ValueError(f"process {host} of {hosts}, local rank {local} "
                             f"of {cards}")
        return Layout(host * cards + local, hosts * cards, local,
                      f"tcp://{coordinator}")
    missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
               if k not in env]
    if missing:
        raise ValueError(f"no coordinator given and no torchrun environment "
                         f"(missing {missing})")
    local = env.get("LOCAL_RANK", 0) if local_rank is None else local_rank
    return Layout(int(env["RANK"]), int(env["WORLD_SIZE"]), int(local), "env://")


def init_distributed(backend: Optional[str] = None, coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     local_rank: Optional[int] = None,
                     device=None) -> torch.device:
    """Join the process group of ``layout``'s ranks and return this rank's
    device: ``device`` if given, else card ``local rank`` where CUDA is
    available (made the current card), else the CPU. ``backend``: NCCL for a
    card, gloo for the CPU by default (gloo also takes CUDA tensors)."""
    on_cards = torch.cuda.is_available() and (
        device is None or torch.device(device).type == "cuda")
    lay = layout(coordinator, num_processes, process_id, local_rank,
                 cards=torch.cuda.device_count() if on_cards else 1)
    if device is None:
        device = (torch.device("cuda", lay.local_rank) if torch.cuda.is_available()
                  else torch.device("cpu"))
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=lay.init_method, rank=lay.rank,
                            world_size=lay.world)
    return device


def world() -> int:
    """The number of ranks (1 outside a process group)."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    """This process's rank (0 outside a process group)."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def barrier() -> None:
    if world() > 1:
        dist.barrier()


def data_world_size(batch_size: int, n_cards: int, n_proc: int = 1) -> int:
    """The ranks to train on (``_data_mesh_size`` of the JAX trainer): on one
    host the largest count up to ``n_cards`` that divides the batch; across
    hosts all ``n_cards`` cards, which the batch must divide."""
    if n_proc > 1:
        if batch_size % n_cards:
            raise ValueError(
                f"multihost training requires batch_size ({batch_size}) "
                f"divisible by the global device count ({n_cards})")
        return n_cards
    n = n_cards
    while n > 1 and batch_size % n != 0:
        n -= 1
    return n


def local_batch_size(global_batch_size: int, n_ranks: int) -> int:
    """Each rank's rows of a global batch (or micro-batch)."""
    if global_batch_size % n_ranks:
        raise ValueError(f"batch size {global_batch_size} not divisible by "
                         f"{n_ranks} ranks")
    return global_batch_size // n_ranks


def local_rows(global_rows: int, rank_: int, n_ranks: int,
               accum_steps: int = 1) -> List[int]:
    """The rows of a global batch of ``global_rows`` that rank ``rank_`` of
    ``n_ranks`` loads, in order. The step takes ``accum_steps`` micro-batches
    of consecutive global rows (JAX's ``make_accum_train_step``), and the
    rank holds its block of each: rows ``k B/K + r B/(K N)`` onwards for
    each micro-batch k. With one micro-batch that is the rank's block of the
    batch, the JAX trainer's ``local_slice``."""
    if global_rows % accum_steps:
        raise ValueError(f"batch {global_rows} is not divisible by "
                         f"grad_accum_steps={accum_steps}")
    micro = global_rows // accum_steps
    share = local_batch_size(micro, n_ranks)
    return [k * micro + rank_ * share + i
            for k in range(accum_steps) for i in range(share)]


def _buckets(tensors: Sequence[torch.Tensor], limit: int):
    """Consecutive runs of ``tensors`` of one dtype and device, each at most
    ``limit`` bytes unless a single tensor is larger."""
    bucket, size = [], 0
    for t in tensors:
        nbytes = t.numel() * t.element_size()
        if bucket and (size + nbytes > limit or (t.dtype, t.device) !=
                       (bucket[0].dtype, bucket[0].device)):
            yield bucket
            bucket, size = [], 0
        bucket.append(t)
        size += nbytes
    if bucket:
        yield bucket


def all_reduce_mean_(params: Iterable[nn.Parameter]) -> None:
    """Average the parameters' gradients over the ranks, in place, in the
    parameters' order, over flat buckets; a missing gradient counts as zeros
    (and becomes them), as the optimizer takes it. Every rank ends with the
    same bits."""
    n = world()
    if n == 1:
        return
    grads = []
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        grads.append(p.grad)
    for bucket in _buckets(grads, BUCKET_BYTES):
        flat = torch.cat([g.reshape(-1) for g in bucket])
        dist.all_reduce(flat)
        flat.div_(n)
        for g, part in zip(bucket, flat.split([g.numel() for g in bucket])):
            g.copy_(part.view_as(g))


def mean_over_ranks(values: torch.Tensor) -> torch.Tensor:
    """A tensor's mean over the ranks (every rank gets the same)."""
    if world() == 1:
        return values
    values = values.clone()
    dist.all_reduce(values)
    return values.div_(world())


def broadcast_params_(module: nn.Module, src: int = 0) -> None:
    """Every parameter and buffer of ``module`` set to rank ``src``'s."""
    if world() == 1:
        return
    with torch.no_grad():
        for t in module.state_dict().values():
            dist.broadcast(t, src)


def broadcast_object(obj: Any, src: int = 0) -> Any:
    """Rank ``src``'s ``obj`` on every rank (a picklable value)."""
    if world() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src)
    return box[0]


def zero_optimizer(params: Iterable[nn.Parameter], **adamw) -> torch.optim.Optimizer:
    """AdamW over ``params`` with its state sharded over the ranks: each rank
    updates the parameters it owns and broadcasts them (ZeRO stage 1)."""
    from torch.distributed.optim import ZeroRedundancyOptimizer

    return ZeroRedundancyOptimizer(list(params), optimizer_class=torch.optim.AdamW,
                                   **adamw)


def free_port() -> int:
    """A TCP port of this host that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_rank(fn: Callable, rank_: int, n: int, port: int, backend: Optional[str],
              devices: Optional[Sequence], args: tuple, init: dict) -> None:
    if init.get("coordinator") is None:  # a group of this host alone
        os.environ.update(RANK=str(rank_), WORLD_SIZE=str(n),
                          MASTER_ADDR="localhost", MASTER_PORT=str(port))
    device = init_distributed(backend, device=None if devices is None else devices[rank_],
                              local_rank=rank_, **init)
    try:
        fn(device, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, n: int, *args, backend: Optional[str] = None,
          devices: Optional[Sequence] = None, timeout: Optional[float] = None,
          **init) -> None:
    """Run ``fn(device, *args)`` in ``n`` new processes, local ranks 0..n-1,
    and wait for them all. They form a process group of this host on a free
    local port, or with ``init`` (JAX's ``coordinator``, ``num_processes``,
    ``process_id``) this host's part of a group across hosts; local rank r
    runs on card r, or on ``devices[r]``. ``fn`` must be importable by name.
    Raises as soon as a rank fails, or once ``timeout`` seconds pass; every
    process is ended either way."""
    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=_run_rank,
                         args=(fn, r, n, port, backend, devices, args, init))
             for r in range(n)]
    for p in procs:
        p.start()
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        running = list(procs)
        while running:
            left = None if deadline is None else max(deadline - time.monotonic(), 0.0)
            if not multiprocessing.connection.wait([p.sentinel for p in running], left):
                raise TimeoutError(f"ranks of {n} still run after {timeout} s")
            for p in [p for p in running if p.exitcode is not None]:
                running.remove(p)
                if p.exitcode != 0:
                    raise RuntimeError(f"rank {procs.index(p)} of {n} failed "
                                       f"(exit code {p.exitcode})")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
