"""Ranks for expert parallelism across processes: the counterpart of the
JAX package's ``make_ep_mesh`` / ``get_shard_map`` (``repro.sharding``).

JAX runs one program per shard of a device mesh under ``shard_map``.
Here each shard is a process, ``torch.distributed`` is the mesh and
``all_to_all_single`` the exchange (``executor.DistEPExecutor``).

``spawn(fn, num_shards, backend=...)`` starts the ranks with
``torch.multiprocessing`` (start method ``spawn``), joins them through a
file store (``file://`` in a fresh directory: no network), calls
``fn(rank, *args, **kwargs)`` in each with a ``Rank`` (its index, the
world size, its device, the backend), and returns each rank's return
value, by rank. A rank that raises makes ``spawn`` raise; the others
are ended. The call travels to the ranks in a file, not in the pipe that
starts each process, which would hold the parent until that process had
imported its modules; the host's cores are shared out among the ranks.

A rank's device is ``cuda:(rank % device_count)`` unless the caller asks
for the CPU. The backend is the caller's choice, ``"nccl"`` or
``"gloo"``, and nothing switches it: NCCL wants a card per rank and
raises with fewer; gloo exchanges CUDA tensors through host memory, so
S ranks can share one card. The kernels are built here, before the ranks
start, so the ranks only load the library and never race to run nvcc.
"""
from __future__ import annotations

import datetime
import os
import pickle
import tempfile
from typing import Any, Callable, List, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.device import DeviceLike, resolve_device

BACKENDS = ("nccl", "gloo")
TIMEOUT_S = 600.0          # a collective that waits longer raises


class Rank(NamedTuple):
    rank: int
    size: int
    device: torch.device
    backend: str


def rank_device(rank: int, device: DeviceLike = None) -> torch.device:
    """The rank's device: ``cuda:(rank % device_count)``, or ``device``
    when the caller names one without an index (the CPU, say)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def check_backend(backend: str, num_shards: int,
                  device: DeviceLike = None) -> torch.device:
    """Refuse a backend that cannot carry ``num_shards`` ranks on
    ``device``; returns the resolved device."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}; name one of {BACKENDS}")
    dev = resolve_device(device)
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError(f"NCCL runs on CUDA devices, not {dev}")
        cards = torch.cuda.device_count()
        if num_shards > cards:
            raise ValueError(
                f"NCCL needs a card per rank: {num_shards} ranks, {cards} "
                f"card(s); gloo can share a card")
    return dev


def _entry(rank: int, num_shards: int, backend: str, init_method: str,
           device, tmp: str, timeout_s: float) -> None:
    with open(os.path.join(tmp, "call.pkl"), "rb") as f:
        fn, args, kwargs = pickle.load(f)
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // num_shards))
    # the ranks of one spawn share this host: their sockets use loopback
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    dev = rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_shards, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        out = fn(Rank(rank, num_shards, dev, backend), *args, **kwargs)
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable[..., Any], num_shards: int, *, backend: str,
          init_method: Optional[str] = None, device: DeviceLike = None,
          args: Sequence = (), kwargs: Optional[dict] = None,
          timeout_s: float = TIMEOUT_S) -> List[Any]:
    """Run ``fn(rank: Rank, *args, **kwargs)`` in ``num_shards``
    processes joined into one process group over ``backend``; returns the
    ranks' return values (picklable, host-side), by rank. ``init_method``
    defaults to a ``file://`` store in a fresh directory. A rank that
    waits more than ``timeout_s`` in the rendezvous or a collective
    raises. ``fn`` must be importable by name (a module-level function),
    as the spawn start method needs."""
    dev = check_backend(backend, num_shards, device)
    if dev.type == "cuda":
        from repro_torch.kernels import build
        build.build()
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory(prefix="ep_ranks_") as tmp:
        init = init_method or f"file://{os.path.join(tmp, 'store')}"
        with open(os.path.join(tmp, "call.pkl"), "wb") as f:
            pickle.dump((fn, tuple(args), kwargs or {}), f,
                        protocol=pickle.HIGHEST_PROTOCOL)
        mp.spawn(_entry, args=(num_shards, backend, init, device, tmp,
                               timeout_s),
                 nprocs=num_shards, join=True, start_method="spawn")
        outs = []
        for r in range(num_shards):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                outs.append(pickle.load(f))
    return outs
