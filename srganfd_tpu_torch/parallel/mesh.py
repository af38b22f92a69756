"""Process group, mesh axes and the cluster-wide flag of the port
(counterpart of ``srganfd_tpu/parallel/mesh.py``).

The JAX package lays its devices out in a mesh whose named axes shard the
work: ``data`` shards each batch (the gradient psum inserted by XLA),
``pipe`` stages the RRDB trunk's depth (``parallel/pipeline.py``) and
``model`` splits the convs' output channels (``parallel/tensor.py``). The
port runs one process per rank on ``torch.distributed``: :func:`make_mesh`
gives rank ``r`` the coordinates of device ``r`` in JAX's row-major
device grid and one process group per axis line, over which the
collectives are written out (``parallel/comm.py``). Every rank holds the
whole state, and its ``data`` row's shard of each batch (the global batch,
which no rank holds whole, is the rows' batches in row order, as
``jax.make_array_from_process_local_data`` assembles it); the ranks of
one row along the other axes hold the same shard. A world of one, without
a group, is what ``make_mesh()`` over one device gives in JAX: nothing is
sharded and no collective runs.

The multi-slice hybrid mesh (``dcn_mesh_shape``) raises, naming ROADMAP.md
A11.
"""
from __future__ import annotations

import datetime
import math
import os
from typing import Any

import torch
import torch.distributed as dist

from srganfd_tpu_torch.parallel import comm

__all__ = [
    "maybe_init_distributed", "Mesh", "make_mesh", "make_hybrid_mesh", "FlagConsensus", "INIT_TIMEOUT_S",
]

# a rank whose peer never comes fails after this long instead of hanging
INIT_TIMEOUT_S = 300


def _env_group() -> tuple[str, int, int, int] | None:
    """(init method, rank, world size, local rank) from torchrun's
    ``RANK``/``WORLD_SIZE``/``MASTER_ADDR``/``MASTER_PORT``/``LOCAL_RANK`` or
    the JAX package's ``JAX_COORDINATOR_ADDRESS``/``JAX_PROCESS_ID``/
    ``JAX_NUM_PROCESSES``; None when neither asks for a group."""
    env = os.environ
    if "RANK" in env and "WORLD_SIZE" in env:
        rank = int(env["RANK"])
        return "env://", rank, int(env["WORLD_SIZE"]), int(env.get("LOCAL_RANK", rank))
    addr = env.get("JAX_COORDINATOR_ADDRESS", "")
    if addr:
        rank = int(env.get("JAX_PROCESS_ID", "0"))
        world = int(env.get("JAX_NUM_PROCESSES", "1"))
        if "LOCAL_RANK" in env:
            local = int(env["LOCAL_RANK"])
        else:  # one process per card of the host, in process order
            local = rank % max(1, torch.cuda.device_count()) if torch.cuda.is_available() else 0
        return f"tcp://{addr}", rank, world, local
    return None


def maybe_init_distributed(device: torch.device | str = "cuda", timeout_s: float = INIT_TIMEOUT_S) -> bool:
    """Join the process group the environment asks for; returns whether a
    group is up.

    A group that the caller initialised already is taken as it is (the JAX
    function swallows "already initialized" the same way). Otherwise the
    group comes from torchrun's variables or the JAX package's coordinator
    triple (see :func:`_env_group`); without either there is no group and
    the run is a world of one. The backend follows ``device``: NCCL for
    ``cuda``, gloo for ``cpu``; a failed NCCL initialisation raises. On
    ``cuda`` the rank's card, ``LOCAL_RANK``, becomes the current device
    first, before any kernel builds or launches. ``timeout_s`` bounds the
    wait for the other ranks, at initialisation and in every collective."""
    device = torch.device(device)
    spec = _env_group()
    if device.type == "cuda" and spec is not None:
        torch.cuda.set_device(spec[3])
    if dist.is_available() and dist.is_initialized():
        return True
    if spec is None:
        return False
    method, rank, world, _ = spec
    dist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo", init_method=method, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    return True


class Mesh:
    """This rank's place in a mesh of named axes: for each axis its size,
    this rank's index along it and the process group of the ranks that
    differ from this one only along it (``comm.SELF`` for an axis of one
    rank, the default group for an axis that spans the world). ``world``
    is the number of ranks the mesh covers."""

    def __init__(self, axes: tuple[str, ...], shape: tuple[int, ...], coords: tuple[int, ...],
                 groups: tuple[comm.Group, ...]) -> None:
        self.axes = axes
        self.shape = dict(zip(axes, shape))
        self.world = math.prod(shape)
        self._coords = dict(zip(axes, coords))
        self._groups = dict(zip(axes, groups))

    def size(self, axis: str) -> int:
        """The axis's length; 1 for an axis the mesh does not have."""
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        """This rank's index along the axis; 0 for an axis the mesh does not have."""
        return self._coords.get(axis, 0)

    def group(self, axis: str) -> comm.Group:
        """The process group of this rank's line along the axis."""
        return self._groups.get(axis, comm.SELF)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank at {self._coords})"


def make_mesh(shape: tuple[int, ...] = (-1,), axes: tuple[str, ...] = ("data",)) -> Mesh:
    """The mesh of a config's ``mesh_shape`` and ``mesh_axes`` over every
    rank (the JAX ``make_mesh``; its default is the ``data`` axis over all
    of them); a single ``-1`` absorbs the ranks as in JAX, and a shape
    that does not cover the world raises. Rank ``r`` takes the coordinates
    of device ``r`` in JAX's row-major reshape of the devices: on ``(2, 4)``
    ``("data", "pipe")``, ``data = r // 4`` and ``pipe = r % 4``. It is a
    collective: every rank must call it, with the same arguments, at the
    same point, since each creates every axis line's group in one order.
    The ``data`` coordinates become the process's data shard
    (``comm.data_rank``, ``comm.data_world``)."""
    axes, shape = tuple(axes), list(shape)
    if len(set(axes)) != len(axes) or len(axes) != len(shape):
        raise ValueError(f"mesh axes {axes} for shape {tuple(shape)}: one distinct name per dimension")
    n = comm.world()
    if -1 in shape:
        known = math.prod(s for s in shape if s != -1)
        shape[shape.index(-1)] = n // known if known and n % known == 0 else -1
    if math.prod(shape) != n or min(shape) < 1:
        raise ValueError(f"mesh shape {tuple(shape)} != {n} ranks")
    grid = torch.arange(n).reshape(shape)
    r = comm.rank()
    coords = tuple(int(c) for c in (grid == r).nonzero()[0])
    groups = []
    for d, size in enumerate(shape):
        if size == 1:
            groups.append(comm.SELF)
        elif size == n:
            groups.append(None)
        else:
            mine = None
            # every rank creates every line's group, in the grid's order
            for line in grid.movedim(d, -1).reshape(-1, size).tolist():
                g = dist.new_group(line)
                if r in line:
                    mine = g
            groups.append(mine)
    mesh = Mesh(axes, tuple(shape), coords, tuple(groups))
    comm.set_data_axis(mesh.index("data"), mesh.size("data"))
    return mesh


def make_hybrid_mesh(*args: Any, **kwargs: Any) -> None:
    """The JAX multi-slice mesh (``dcn_mesh_shape``) has no single-node
    counterpart here."""
    raise NotImplementedError(
        "dcn_mesh_shape (the multi-slice hybrid mesh of TPU pods) is not ported to "
        "srganfd_tpu_torch: see ROADMAP.md A11"
    )


class FlagConsensus:
    """Cluster-wide max of a per-rank int flag, polled without stalling the
    step loop (the JAX class of the same name).

    A SIGTERM may reach only some ranks, and the train step is a
    collective: a rank that exits alone leaves its peers waiting in the
    next one. ``poll(flag)`` is a symmetric collective every rank calls at
    the same loop points: it starts one ``all_reduce(MAX)`` with
    ``async_op=True`` and returns the result of the *previous* poll (0 on
    the first), so the loop never waits on a fresh collective. The tensor
    lies on the card under NCCL and on the host under gloo."""

    def __init__(self) -> None:
        on_card = comm.backend() == "nccl"
        self._device = torch.device("cuda", torch.cuda.current_device()) if on_card else torch.device("cpu")
        self._pending: tuple[Any, torch.Tensor] | None = None

    def poll(self, flag: int) -> int:
        """Contribute ``flag``; return the max over the ranks of the
        previous round's flags. Every rank must call it at the same points."""
        prev = self._pending
        t = torch.tensor([int(flag)], dtype=torch.int32, device=self._device)
        work = dist.all_reduce(t, op=dist.ReduceOp.MAX, async_op=True) if comm.world() > 1 else None
        self._pending = (work, t)
        if prev is None:
            return 0
        if prev[0] is not None:
            prev[0].wait()
        return int(prev[1].item())

    def barrier(self) -> None:
        """Every rank waits for the others (before a preemption exit: a peer
        must not leave while rank 0 still writes its snapshot)."""
        comm.barrier()
