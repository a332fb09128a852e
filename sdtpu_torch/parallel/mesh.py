"""The (data, model) mesh over torch.distributed ranks, the counterpart of
``sdtpu/parallel/mesh.py``.

Every rank of the world builds the mesh (``make_mesh``), in the same order
of calls: ``dist.new_group`` is collective over the world, so each rank
creates every subgroup, those it is not in too. Rank ``i`` of the mesh has
the coordinates ``(i // model, i % model)``: its data group holds the ranks
of its model column, its model group those of its data row, so the
(usually communication-heavy) model axis takes adjacent ranks, as the
reference keeps it on neighbouring chips.

With no process group initialised the world is one rank, as
``jax.devices()`` is one device on one card: ``(1, 1)`` serves with no
collective (``single_device_mesh``).

The mesh a call runs on is the current one (``use``, ``current``): a
context variable, so a thread or a test that runs another Context does not
see it.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
from typing import Optional

import torch
import torch.distributed as dist

class Mesh:
    """A ``(data, model)`` grid of ranks: ``shape`` is ``{"data": d,
    "model": m}``; ``coords`` this rank's ``(data, model)`` coordinates, or
    None for a rank of the world past the grid's d * m; ``groups`` the
    rank's ``{"data": group, "model": group}``, or None without a process
    group."""

    def __init__(self, data: int, model: int, index: Optional[int],
                 groups: Optional[dict] = None):
        self.shape = {"data": int(data), "model": int(model)}
        self.coords = (None if index is None
                       else (index // model, index % model))
        self.groups = groups

    @property
    def member(self) -> bool:
        return self.coords is not None

    def group(self, axis: str):
        if self.groups is None:
            raise RuntimeError(f"mesh {self.shape} has no process group: "
                               f"no collective runs over its {axis} axis")
        return self.groups[axis]

    def backend(self, axis: str) -> str:
        return dist.get_backend(self.group(axis))

    def barrier(self) -> None:
        """Return once every rank of the mesh has called it: a barrier over
        the model group, then over the data group (a rank's data group
        holds one rank of every model group). Nothing on one rank."""
        if self.groups is None:
            return
        for axis in ("model", "data"):
            if self.shape[axis] > 1:
                dist.barrier(group=self.groups[axis])

    def __repr__(self) -> str:
        return (f"Mesh(data={self.shape['data']}, "
                f"model={self.shape['model']}, coords={self.coords})")


def _world(group):
    """(ranks of ``group``, this process's rank) or ([0], 0) without a
    process group."""
    if not (dist.is_available() and dist.is_initialized()):
        return [0], 0
    if group is None:
        return list(range(dist.get_world_size())), dist.get_rank()
    return list(dist.get_process_group_ranks(group)), dist.get_rank()


def make_mesh(data: int = 1, model: Optional[int] = None,
              group=None) -> Mesh:
    """Build a (data, model) mesh over the ranks of ``group`` (the world by
    default); ``model=None`` takes all remaining ranks. Raises the
    reference's ``ValueError``s (``sdtpu/parallel/mesh.py:32-52``) for a
    world that ``data`` does not divide and a mesh larger than the world.
    Every rank of the world calls it."""
    ranks, me = _world(group)
    n = len(ranks)
    if model is None:
        if n % data:
            raise ValueError(f"{n} devices not divisible by data={data}")
        model = n // data
    if data * model > n:
        raise ValueError(f"mesh {data}x{model} exceeds {n} devices")
    if not (dist.is_available() and dist.is_initialized()):
        return Mesh(data, model, 0)
    grid = ranks[: data * model]
    index = grid.index(me) if me in grid else None
    groups = {}
    # every rank creates every subgroup, in one order: the data groups (one
    # a model column), then the model groups (one a data row)
    for j in range(model):
        g = dist.new_group([grid[i * model + j] for i in range(data)])
        if index is not None and index % model == j:
            groups["data"] = g
    for i in range(data):
        g = dist.new_group([grid[i * model + j] for j in range(model)])
        if index is not None and index // model == i:
            groups["model"] = g
    return Mesh(data, model, index, groups if index is not None else None)


def single_device_mesh() -> Mesh:
    """The 1x1 mesh of one rank with no process group."""
    return Mesh(1, 1, 0)


def rank_device() -> torch.device:
    """This rank's card: ``cuda:{LOCAL_RANK % device_count()}``
    (``LOCAL_RANK`` as ``torchrun`` sets it, else the global rank)."""
    if "LOCAL_RANK" in os.environ:
        local = int(os.environ["LOCAL_RANK"])
    elif dist.is_available() and dist.is_initialized():
        local = dist.get_rank()
    else:
        local = 0
    return torch.device("cuda", local % max(torch.cuda.device_count(), 1))


_CURRENT: contextvars.ContextVar = contextvars.ContextVar(
    "sdtpu_torch_mesh", default=None)


def current() -> Optional[Mesh]:
    """The mesh of the running call, or None."""
    return _CURRENT.get()


@contextlib.contextmanager
def use(mesh: Optional[Mesh]):
    """Run the body on ``mesh`` (None: on no mesh)."""
    token = _CURRENT.set(mesh)
    try:
        yield mesh
    finally:
        _CURRENT.reset(token)
