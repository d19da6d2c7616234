"""Rank layout and process groups on ``torch.distributed``.

The JAX package builds one ``jax.sharding.Mesh`` and lets GSPMD insert the
collectives. torch runs one process per rank, so here the mesh is a rank
layout: every rank knows its coordinates on the axes
``("dp", "pp", "ep", "sp", "tp")`` (tp innermost, as in the JAX package,
so tp peers are neighbouring ranks on one host) and holds the process
groups its forward reduces over:

- ``tp``: the ranks that differ only in their tp index (attention heads,
  MLP columns);
- ``ep``: the ranks that differ only in their ep index (experts);
- ``moe``: the ranks of one dp index that differ in ep or tp (the MoE
  combine reduces over both).

dp keeps the JAX meaning, a replicated engine: each dp index is a full copy
of the tp x ep group, fed the same directives, with no collective between
copies. Bootstrap: ``initialize_distributed`` reads the environment the
deploy renderer gives each pod (``KGCT_COORDINATOR``,
``KGCT_NUM_PROCESSES``, ``KGCT_PROCESS_ID``), explicit arguments winning.
The backend is named, never switched: ``nccl`` by default on a CUDA
device, ``gloo`` on the CPU, and ``gloo`` may be asked for CUDA tensors
(two ranks on one card, where NCCL refuses).
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from ..config.engine_config import ParallelConfig
from ..utils import get_logger

logger = get_logger("parallel.mesh")

MESH_AXES = ("dp", "pp", "ep", "sp", "tp")
DEFAULT_TIMEOUT_S = 600.0
# The timeout ``initialize_distributed`` gave the world group; ``make_mesh``
# gives its subgroups the same.
_timeout = datetime.timedelta(seconds=DEFAULT_TIMEOUT_S)


def coords_of(rank: int, sizes: dict) -> dict:
    """Rank -> {axis: index} in ``MESH_AXES`` order, tp fastest."""
    out = {}
    for axis in reversed(MESH_AXES):
        out[axis] = rank % sizes[axis]
        rank //= sizes[axis]
    return out


def _groups_over(axes: tuple, sizes: dict) -> list[list[int]]:
    """Every group of ranks that differ only on ``axes``, in rank order."""
    world = 1
    for a in MESH_AXES:
        world *= sizes[a]
    seen, out = set(), []
    for r in range(world):
        if r in seen:
            continue
        c = coords_of(r, sizes)
        members = [r2 for r2 in range(world)
                   if all(coords_of(r2, sizes)[a] == c[a]
                          for a in MESH_AXES if a not in axes)]
        seen.update(members)
        out.append(members)
    return out


class ParallelGroups:
    """One rank's place in the layout and the process groups it reduces
    over. Built without a process group (``make_mesh(..., rank=r)`` before
    ``torch.distributed`` is up) it is a layout only: sharding reads its
    coordinates, and a collective over more than one rank raises."""

    def __init__(self, sizes: dict, rank: int, backend: Optional[str] = None,
                 groups: Optional[dict] = None):
        self.sizes = dict(sizes)
        self.rank = rank
        self.backend = backend
        self.coords = coords_of(rank, self.sizes)
        self._groups = groups or {}

    def __repr__(self) -> str:
        return (f"ParallelGroups(rank={self.rank}, {self.sizes}, "
                f"backend={self.backend})")

    @property
    def world_size(self) -> int:
        n = 1
        for a in MESH_AXES:
            n *= self.sizes[a]
        return n

    @property
    def tp(self) -> int:
        return self.sizes["tp"]

    @property
    def ep(self) -> int:
        return self.sizes["ep"]

    @property
    def tp_rank(self) -> int:
        return self.coords["tp"]

    @property
    def ep_rank(self) -> int:
        return self.coords["ep"]

    def _group(self, name: str):
        size = {"tp": self.tp, "ep": self.ep,
                "moe": self.tp * self.ep}[name]
        if size == 1:
            return None
        if name not in self._groups:
            raise RuntimeError(f"{self!r} is a layout without process "
                               f"groups; no collective over {name}")
        return self._groups[name]

    def all_reduce(self, t: torch.Tensor, over: str = "tp") -> torch.Tensor:
        """Sum ``t`` in place over the ``over`` group ("tp", "ep" or
        "moe") and return it; no op on a group of one rank."""
        group = self._group(over)
        if group is not None:
            dist.all_reduce(t, group=group)
        return t

    def all_gather(self, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """Concatenate every tp rank's ``t`` along ``dim``, in tp order."""
        group = self._group("tp")
        if group is None:
            return t
        parts = [torch.empty_like(t) for _ in range(self.tp)]
        dist.all_gather(parts, t.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    def _scalar_device(self) -> torch.device:
        if self.backend == "nccl":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device("cpu")

    def world_min(self, value: int) -> int:
        """The least ``value`` over every rank of the world."""
        if self.world_size == 1:
            return int(value)
        t = torch.tensor([int(value)], dtype=torch.int64,
                         device=self._scalar_device())
        dist.all_reduce(t, op=dist.ReduceOp.MIN)
        return int(t.item())

    def world_agree(self, value: int) -> bool:
        """True when every rank of the world holds the same ``value`` (an
        int63 hash): min and max over the world are equal."""
        if self.world_size == 1:
            return True
        t = torch.tensor([int(value), -int(value)], dtype=torch.int64,
                         device=self._scalar_device())
        dist.all_reduce(t, op=dist.ReduceOp.MIN)
        return int(t[0]) == -int(t[1])


def make_mesh(tp: int = 1, pp: int = 1, dp: int = 1, ep: int = 1,
              sp: int = 1, rank: Optional[int] = None) -> ParallelGroups:
    """The rank layout for ``dp*pp*ep*sp*tp`` ranks. With
    ``torch.distributed`` initialized (and ``rank`` None or this rank) the
    world size must equal the product and the tp, ep and moe groups are
    created, every rank creating every group in the same order, as
    ``new_group`` requires. Otherwise ``rank`` names the layout position
    to describe (a layout without groups)."""
    sizes = dict(dp=dp, pp=pp, ep=ep, sp=sp, tp=tp)
    for a, n in sizes.items():
        if n < 1:
            raise ValueError(f"{a}={n}: every axis needs at least 1 rank")
    world = dp * pp * ep * sp * tp
    if not dist.is_initialized() or (rank is not None
                                     and rank != dist.get_rank()):
        if rank is None or not 0 <= rank < world:
            raise ValueError(f"rank {rank} outside the {world}-rank layout "
                             "(torch.distributed is not initialized)")
        return ParallelGroups(sizes, rank)
    if dist.get_world_size() != world:
        raise ValueError(
            f"need {world} ranks for dp={dp} pp={pp} ep={ep} sp={sp} "
            f"tp={tp}, the process group has {dist.get_world_size()}")
    me = dist.get_rank()
    backend = dist.get_backend()
    groups = {}
    for name, axes in (("tp", ("tp",)), ("ep", ("ep",)),
                       ("moe", ("ep", "tp"))):
        if len(_groups_over(axes, sizes)[0]) == 1:
            continue
        for members in _groups_over(axes, sizes):
            g = dist.new_group(members, timeout=_timeout)
            if me in members:
                groups[name] = g
    return ParallelGroups(sizes, me, backend=backend, groups=groups)


def mesh_from_config(cfg: ParallelConfig) -> Optional[ParallelGroups]:
    """The layout of an ``EngineConfig.parallel``; None at world size 1
    (the engine then runs no collective)."""
    if cfg.world_size == 1:
        return None
    return make_mesh(tp=cfg.tp, pp=cfg.pp, dp=cfg.dp, ep=cfg.ep, sp=cfg.sp)


def default_backend(device: torch.device | str) -> str:
    """``nccl`` for a CUDA device, ``gloo`` for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None,
                           device: torch.device | str = "cuda",
                           timeout_s: Optional[float] = None) -> bool:
    """Join the process group: ``torch.distributed.init_process_group``
    over ``tcp://<coordinator>`` with a timeout that bounds the rendezvous
    and every later collective, ``make_mesh``'s groups' too. Reads, where an argument is None:

    - ``KGCT_COORDINATOR``: ``host:port`` of rank 0;
    - ``KGCT_NUM_PROCESSES``: the number of ranks;
    - ``KGCT_PROCESS_ID``: this rank.

    ``backend`` defaults to ``default_backend(device)``. Returns False (a
    single-process run) when no coordinator is configured, True once the
    group is up or was already."""
    if dist.is_initialized():
        return True
    coordinator_address = (coordinator_address
                           or os.environ.get("KGCT_COORDINATOR"))
    if coordinator_address is None:
        logger.info("no coordinator configured; single-process run")
        return False
    if num_processes is None:
        num_processes = int(os.environ.get("KGCT_NUM_PROCESSES", "1"))
    if process_id is None:
        process_id = int(os.environ.get("KGCT_PROCESS_ID", "0"))
    backend = backend or default_backend(device)
    global _timeout
    _timeout = datetime.timedelta(seconds=timeout_s or DEFAULT_TIMEOUT_S)
    logger.info("torch.distributed init (%s, %s, world %d, rank %d)",
                backend, coordinator_address, num_processes, process_id)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id,
                            timeout=_timeout)
    return True
