"""One HTTP front end for a mesh: rank 0 leads, the other ranks follow.

Every rank of a mesh makes every call of a ``Context(mesh=...)``, so that
their collectives pair up, but one process serves HTTP. The leader (rank 0)
broadcasts each call it makes on a mirrored object (the Context, the
stream pool, a batch's ``finish``) before it makes it: the object's name,
the method and the arguments, one ``broadcast_object_list`` on a gloo
group. A follower receives the calls in the same order and makes each on
its own objects (``follow``). One lock orders the leader's calls across
its threads (the micro-batcher's worker, the pool's worker, the request
handlers), so every rank sees one sequence. A call that raises on the
leader raises on the followers too; they log it and go on. ``Leader.stop``
broadcasts the end, and the followers return.

The ranks come from ``torchrun``'s environment where it is set
(``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``); otherwise ``start`` starts the
d * m - 1 followers itself, fresh interpreters with the leader's command
line, on a ``file://`` store. NCCL carries the mesh's collectives where
each rank has a card of its own, gloo where ranks share one (NCCL refuses
two ranks of one communicator on one device) or on the CPU.
"""

from __future__ import annotations

import datetime
import os
import signal
import subprocess
import sys
import tempfile
import threading

import torch
import torch.distributed as dist

#: the environment a self-started follower reads: the file store's URL
STORE_ENV = "SDTPU_TORCH_MESH_STORE"
#: how long a follower waits for the leader's next call: gloo's timeout,
#: which it keeps in 32-bit milliseconds
IDLE = datetime.timedelta(days=24)


def _backend(world: int, device: str) -> str:
    if device == "cuda" and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def start(world: int, device: str, argv) -> tuple:
    """Join (or make) the process group of ``world`` ranks; returns
    ``(rank, group, followers)``: ``group`` the gloo group the calls go
    over, ``followers`` the processes this rank started (rank 0 without
    ``torchrun`` starts ranks 1 .. world - 1 running ``argv``, the
    command's arguments after the interpreter's)."""
    followers = []
    if "WORLD_SIZE" in os.environ and STORE_ENV not in os.environ:
        rank = int(os.environ["RANK"])
        if int(os.environ["WORLD_SIZE"]) != world:
            raise ValueError(f"torchrun started {os.environ['WORLD_SIZE']} "
                             f"ranks for a mesh of {world}")
        init = "env://"
    elif STORE_ENV in os.environ:
        rank = int(os.environ["RANK"])
        init = os.environ[STORE_ENV]
    else:
        rank = 0
        init = f"file://{tempfile.mkdtemp(prefix='sdtpu-mesh-')}/store"
        for r in range(1, world):
            env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r),
                       WORLD_SIZE=str(world), **{STORE_ENV: init})
            followers.append(subprocess.Popen([sys.executable, *argv],
                                              env=env))
    dist.init_process_group(_backend(world, device), init_method=init,
                            rank=rank, world_size=world)
    group = dist.new_group(backend="gloo", timeout=IDLE)
    if rank and STORE_ENV in os.environ:
        _watch_parent()
    return rank, group, followers


def _watch_parent() -> None:
    """A self-started follower ends when its leader's process does, even
    if the leader could not say so."""
    parent = os.getppid()

    def watch():
        while True:
            threading.Event().wait(2.0)
            if os.getppid() != parent:
                os._exit(1)

    threading.Thread(target=watch, daemon=True, name="sdtpu-leader").start()


def _broadcast(group, msg=None):
    box = [msg]
    dist.broadcast_object_list(box, src=0, group=group)
    return box[0]


class Mirror:
    """An object of the leader whose public methods are made on every rank:
    ``Leader.call`` broadcasts each, then makes it here. Attributes and
    private methods are the leader's own."""

    def __init__(self, leader: "Leader", name: str, obj):
        self._leader, self._name, self._obj = leader, name, obj

    def __getattr__(self, attr):
        value = getattr(self._obj, attr)
        if attr.startswith("_") or not callable(value):
            return value
        return lambda *a, **kw: self._leader.call(self._name, attr, a, kw)


class Leader:
    """Rank 0's side: ``mirror(name, obj)`` wraps one of its objects, whose
    counterpart each follower holds under the same name; ``new`` makes a
    stream pool on every rank; ``stop`` ends the followers."""

    def __init__(self, group, ctx):
        self.group = group
        self._objects = {"ctx": ctx}
        self._lock = threading.Lock()
        self._asyncs = 0

    def mirror(self, name: str = "ctx") -> Mirror:
        return Mirror(self, name, self._objects[name])

    def call(self, name: str, method: str, args=(), kwargs=None):
        kwargs = kwargs or {}
        with self._lock:
            _broadcast(self.group, (name, method, args, kwargs))
            key = None
            if method.endswith("_async"):
                # a batch's finish(): mirrored under the name every rank
                # gives the n-th async call's result
                key = f"async{self._asyncs}"
                self._asyncs += 1
            out = _make(self._objects, name, method, args, kwargs)
            if key is None:
                return out
            self._objects[key] = out
            return lambda: self.call(key, "__call__")

    def new(self, name: str, slots: int, **kwargs) -> Mirror:
        """A ``StreamScheduler`` over the Context on every rank."""
        self.call(name, "__new__", (slots,), kwargs)
        return self.mirror(name)

    def stop(self) -> None:
        with self._lock:
            _broadcast(self.group, None)


def _make(objects: dict, name: str, method: str, args, kwargs):
    if method == "__new__":
        from sdtpu_torch.engine.stream import StreamScheduler

        objects[name] = StreamScheduler(objects["ctx"], *args, **kwargs)
        return objects[name]
    if method == "__call__":
        return objects.pop(name)()
    return getattr(objects[name], method)(*args, **kwargs)


def follow(ctx, group) -> int:
    """A follower's loop: make each call the leader broadcasts on this
    rank's objects, until ``Leader.stop``; returns the calls made. An
    interrupt is the leader's to take (a terminal's reaches the whole
    process group): the loop ignores it."""
    signal.signal(signal.SIGINT, signal.SIG_IGN)
    objects = {"ctx": ctx}
    made = asyncs = 0
    while True:
        msg = _broadcast(group)
        if msg is None:
            return made
        name, method, args, kwargs = msg
        key = None
        if method.endswith("_async"):
            key = f"async{asyncs}"
            asyncs += 1
        try:
            out = _make(objects, name, method, args, kwargs)
            if key is not None:
                objects[key] = out
        except Exception as e:  # noqa: BLE001 - the leader's call raised too
            ctx.logger.debug(f"follower: {name}.{method} raised {e}")
        made += 1
