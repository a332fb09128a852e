"""The spatial (W-axis) partition of the UNet's conv stack over the mesh's
model axis, the counterpart of ``sdtpu/parallel/spatial.py``.

The tensor-parallel plan (``sharding``) replicates the convolutions on the
model axis. With the spatial spec on (``use``, set around a call by
``sharding.generate_sharded(..., spatial=True)``), each rank of the model
axis holds a W-slice of the conv stack's [B, H, W, C] activations instead,
by the reference's ``constrain`` rule (``tiles``): a plane is split where
``W % m == 0`` and ``W // m >= 2``, else it stays whole. The reference
constrains ``conv_in``, each ResBlock, ``down`` and ``up``
(``sdtpu/models/unet.py:486-549``) and lets GSPMD partition the rest; the
port writes the partition out (``sdtpu_torch.models.unet``):

* a 3x3 conv takes one column from each neighbour (``padded``: the
  collective-permute ``collectives.halo``), zeros only at the plane's outer
  edges, and runs with no W padding; the stride-2 ``down`` conv so too,
  where the slice's width is even (its offsets stay even), else on the
  gathered plane;
* a fused conv (K3, ``cuda_conv``) takes the raw halo and applies its
  GroupNorm prologue to it: it runs on the slice with the neighbours'
  columns only (``halo_slice``), with its own zero padding, and the
  output columns of the halo, computed against that padding, are dropped
  (``crop``): the plane's outer edges are then the kernel's own padding,
  zero after the prologue, and its contract is unchanged;
* a GroupNorm's statistics are combined over the model group (``stats``:
  each rank's (mean, M2) of its slice, one all-gather, Chan's rule), for the
  plain chain, for K2 and for K2's statistics mode;
* 1x1 convs, nearest upsampling, the skip concatenations and elementwise
  work run on slices as they are;
* a spatial transformer gathers the plane first (an all-gather) and each
  rank takes its slice after: its heads are the plan's.

The spec is a context variable, so a thread or a test that runs another
call does not see it.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

from sdtpu_torch.parallel import collectives

_SPEC: contextvars.ContextVar = contextvars.ContextVar(
    "sdtpu_torch_spatial_spec", default=None)


@contextlib.contextmanager
def use(mesh):
    """Run the body with the conv stack split over ``mesh``'s model axis
    (None: not split)."""
    token = _SPEC.set(mesh)
    try:
        yield mesh
    finally:
        _SPEC.reset(token)


def parts() -> int:
    """The ways a plane is split: the model axis's size with the spec on,
    else 1."""
    mesh = _SPEC.get()
    return 1 if mesh is None else mesh.shape["model"]


def tiles(w: int) -> bool:
    """The reference's ``constrain`` rule: a plane ``w`` wide is split
    where the model axis tiles it with at least 2 columns a rank."""
    m = parts()
    return m > 1 and w % m == 0 and w // m >= 2


def _rank() -> tuple:
    mesh = _SPEC.get()
    return mesh.shape["model"], mesh.coords[1]


def split(x):
    """This rank's W-slice of a whole [B, H, W, C] plane."""
    m, r = _rank()
    k = x.shape[2] // m
    return x.narrow(2, r * k, k).contiguous()


def gather(x):
    """The whole plane from every rank's W-slice (an all-gather)."""
    return collectives.all_gather(x, "model", dim=2)


def fit(x, is_split: bool, w: int):
    """``(x, split)``: x, a plane ``w`` wide held whole or as this rank's
    slice (``is_split``), in the layout ``tiles(w)`` gives it."""
    want = tiles(w)
    if want == is_split:
        return x, is_split
    return (split(x) if want else gather(x)), want


def halo_slice(x):
    """``(x with its neighbours' columns, left, right)``: the slice widened
    by the column of each neighbour (a collective-permute), none at the
    plane's outer edges; ``left`` and ``right`` say which were added."""
    left, right = collectives.halo(x)
    cols = [c for c in (left, x, right) if c is not None]
    return torch.cat(cols, dim=2), left is not None, right is not None


def padded(x):
    """The slice widened by one column a side: the neighbours' (a
    collective-permute), zeros at the plane's outer edges. A 3x3 conv on it
    with no W padding is the rank's slice of the conv of the whole plane."""
    left, right = collectives.halo(x)
    zero = x.new_zeros(x.shape[:2] + (1, x.shape[3]))
    return torch.cat([zero if left is None else left, x,
                      zero if right is None else right], dim=2)


def crop(y, left: bool, right: bool):
    """A conv's output on ``halo_slice``'s input, its halo columns dropped,
    contiguous (the next kernel's contract)."""
    if not (left or right):
        return y
    return y.narrow(2, int(left),
                    y.shape[2] - int(left) - int(right)).contiguous()


def combine(parts_, count: int, eps: float):
    """(mean, rstd) [N, G, 2] of the whole plane from the ranks' partial
    (mean, M2) [m, N, G, 2], each over ``count`` elements a group: Chan's
    rule for equal counts, in float32."""
    mean = parts_[..., 0].mean(dim=0)
    m2 = parts_[..., 1].sum(dim=0) + count * (
        parts_[..., 0] - mean).square().sum(dim=0)
    var = m2 / (count * parts_.shape[0])
    return torch.stack([mean, torch.rsqrt(var + eps)], dim=-1)


def stats(x, groups: int, eps: float, kernel: bool = False):
    """A GroupNorm's statistics over the whole plane of which x [N, H,
    W / m, C] is this rank's slice: float32 [N, G, 2] of each (sample,
    group)'s mean and rstd. The partials are K2's (``kernel``: its
    statistics of a slice, ``ops.groupnorm.group_norm_partial``) or the
    plain ``layers.group_norm_moments``; one all-gather over the model
    group, then ``combine``."""
    from sdtpu_torch.models.layers import group_norm_moments
    from sdtpu_torch.ops import groupnorm as G

    part = (G.group_norm_partial(x, groups) if kernel
            else group_norm_moments(x, groups))
    count = x.numel() // (x.shape[0] * groups)
    return combine(collectives.all_gather(part[None], "model", 0), count,
                   eps)
