"""The port's collectives, counted: the counterpart of
``sdtpu/parallel/hlo.py``, which counts what GSPMD emitted in the compiled
HLO. Here every collective of the mesh path goes through this module, so
the counts are the communication a rank issued, and tests and the card's
smoke pin them against the plan (``sharding``).

Transport, a static rule by the group's backend: an NCCL group keeps the
tensors on the card; gloo is a CPU transport, so a CUDA tensor crosses the
host (copied out, reduced or gathered, copied back) on a gloo group. A
row-parallel partial is summed in the dtype it was computed in (bf16 on
the card's serving path), as the reference's psum of a bf16 product is.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from sdtpu_torch.parallel.mesh import current

#: the collective names the reference counts (``sdtpu/parallel/hlo.py:17-18``)
COLLECTIVES = ("all-reduce", "all-gather", "collective-permute",
               "reduce-scatter", "all-to-all")

_COUNTS = dict.fromkeys(COLLECTIVES, 0)


def collective_counts() -> dict:
    """This process's collectives since the last ``reset_counts``, by name;
    an op never issued counts 0."""
    return dict(_COUNTS)


def reset_counts() -> None:
    for k in _COUNTS:
        _COUNTS[k] = 0


def _group(axis: str):
    mesh = current()
    if mesh is None:
        raise RuntimeError(
            f"a {axis}-parallel collective outside a mesh: run sharded "
            f"parameters under parallel.mesh.use(mesh)")
    return mesh.group(axis)


def _host(x, group) -> bool:
    return x.device.type != "cpu" and dist.get_backend(group) == "gloo"


def all_reduce_sum(x, axis: str = "model"):
    """The sum of ``x`` over the ``axis`` group of the current mesh, in
    ``x``'s dtype. Sums in place where ``x`` is contiguous and on the
    group's transport."""
    g = _group(axis)
    host = _host(x, g)
    t = x.cpu() if host else x.contiguous()
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=g)
    _COUNTS["all-reduce"] += 1
    return t.to(x.device) if host else t


def all_gather(x, axis: str, dim: int = 0):
    """The ``axis`` group's ``x``, concatenated along ``dim`` in the
    group's rank order."""
    g = _group(axis)
    host = _host(x, g)
    t = (x.cpu() if host else x).contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(g))]
    dist.all_gather(parts, t, group=g)
    _COUNTS["all-gather"] += 1
    out = torch.cat(parts, dim=dim)
    return out.to(x.device) if host else out
