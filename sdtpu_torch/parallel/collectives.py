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

Under autograd (training) the model axis's collectives are Megatron's
pairs, ``torch.autograd.Function``s: ``reduce_from_model`` (a row-parallel
site's partial sum: all-reduce forward, identity backward),
``copy_to_model`` (a column-parallel site's input: identity forward,
all-reduce of the input's gradient backward) and ``gather_from_model`` (a
lone column site's output: all-gather forward, this rank's columns of the
gradient backward). A backward's all-reduce is counted as the forward's
are. Off autograd they are the plain collectives, with no Function on the
path. ``halo`` is the spatial partition's collective-permute
(``spatial``); ``all_reduce_mean`` the data axis's bucketed gradient
all-reduce.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from sdtpu_torch.parallel.mesh import current, use

#: the collective names the reference counts (``sdtpu/parallel/hlo.py:17-18``)
COLLECTIVES = ("all-reduce", "all-gather", "collective-permute",
               "reduce-scatter", "all-to-all")
#: a data-axis gradient bucket's most float32 bytes (SD1.5's 860 M
#: gradients in four buckets)
BUCKET_BYTES = 1 << 30

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


def all_gather_parts(x, axis: str) -> list:
    """Every rank's ``x`` of the ``axis`` group, in the group's rank
    order, on ``x``'s device."""
    g = _group(axis)
    host = _host(x, g)
    t = (x.cpu() if host else x).contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(g))]
    dist.all_gather(parts, t, group=g)
    _COUNTS["all-gather"] += 1
    return [p.to(x.device) for p in parts] if host else parts


def all_gather(x, axis: str, dim: int = 0):
    """The ``axis`` group's ``x``, concatenated along ``dim`` in the
    group's rank order."""
    return torch.cat(all_gather_parts(x, axis), dim=dim)


def _recording(x) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return all_reduce_sum(x, "model")

    @staticmethod
    def backward(ctx, g):
        return g


# A backward runs in autograd's device thread, which does not see the
# call's mesh (a context variable): the forward keeps it for the backward.

class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.mesh = current()
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        with use(ctx.mesh):
            return all_reduce_sum(g, "model")


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim, ctx.width = dim, x.shape[dim]
        ctx.rank = current().coords[1]
        return all_gather(x, "model", dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.width,
                        ctx.width).contiguous(), None


def reduce_from_model(x):
    """A row-parallel site's partial sum over the model group (Megatron's
    g): its gradient passes through unchanged."""
    if _recording(x):
        return _ReduceFromModel.apply(x)
    return all_reduce_sum(x, "model")


def copy_to_model(x):
    """A column-parallel site's replicated input (Megatron's f): the
    identity, whose backward sums the input's gradient over the model
    group (each rank's columns give their share of it)."""
    return _CopyToModel.apply(x) if _recording(x) else x


def gather_from_model(x, dim: int = -1):
    """A lone column-parallel site's output gathered over the model group
    along ``dim``; backward keeps this rank's slice of the gradient."""
    dim = dim % x.dim()
    if _recording(x):
        return _GatherFromModel.apply(x, dim)
    return all_gather(x, "model", dim)


def halo(x, dim: int = 2):
    """The spatial partition's halo exchange over the model group: each
    rank sends its first column along ``dim`` to the rank on its left and
    its last to the one on its right, and receives theirs. Returns (left,
    right): the neighbours' columns, None at the plane's outer edges. Two
    collective-permutes, one a direction, each a pair of point-to-point
    transfers per rank boundary."""
    mesh = current()
    g = mesh.group("model")
    m, r = mesh.shape["model"], mesh.coords[1]
    ranks = dist.get_process_group_ranks(g)
    host = _host(x, g)
    first = x.narrow(dim, 0, 1)
    last = x.narrow(dim, x.shape[dim] - 1, 1)
    if host:
        first, last = first.cpu(), last.cpu()
    first, last = first.contiguous(), last.contiguous()
    left = torch.empty_like(first) if r > 0 else None
    right = torch.empty_like(last) if r < m - 1 else None
    ops = []
    if r > 0:
        ops += [dist.P2POp(dist.isend, first, ranks[r - 1], g),
                dist.P2POp(dist.irecv, left, ranks[r - 1], g)]
    if r < m - 1:
        ops += [dist.P2POp(dist.isend, last, ranks[r + 1], g),
                dist.P2POp(dist.irecv, right, ranks[r + 1], g)]
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    _COUNTS["collective-permute"] += 2
    if host:
        left = None if left is None else left.to(x.device)
        right = None if right is None else right.to(x.device)
    return left, right


def buckets(sizes, cap: int = BUCKET_BYTES // 4) -> list:
    """The data axis's gradient buckets: consecutive runs of tensor
    indices whose element counts sum to at most ``cap`` (a larger tensor
    alone), in order."""
    out, run, n = [], [], 0
    for i, s in enumerate(sizes):
        if run and n + s > cap:
            out.append(run)
            run, n = [], 0
        run.append(i)
        n += s
    if run:
        out.append(run)
    return out


@torch.no_grad()
def all_reduce_mean(tensors, axis: str = "data") -> None:
    """Replace each tensor by its mean over the ``axis`` group, in place:
    the tensors flattened into float32 buckets (``buckets``), one
    all-reduce a bucket, divided by the group's size. A gloo group stages
    each bucket through the host."""
    size = current().shape[axis]
    for run in buckets([t.numel() for t in tensors]):
        flat = torch.cat([tensors[i].reshape(-1).float() for i in run])
        flat = all_reduce_sum(flat, axis)
        flat.div_(size)
        off = 0
        for i in run:
            t = tensors[i]
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()
