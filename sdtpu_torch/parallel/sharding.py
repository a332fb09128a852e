"""The tensor-parallel plan and the data-axis rows, the counterpart of
``sdtpu/parallel/sharding.py``.

The reference annotates each leaf by its field, its parent's name and
divisibility (``param_pspecs``, ``:41-69``) and lets GSPMD reshard whatever
the annotations leave inconsistent. The port runs the sums itself, so it
decides per *site*: a transformer attention (its q/k/v or fused qkv/kv
columns and its ``out`` rows), an MLP pair (``ff1``/``ff2``, ``fc1``/``fc2``)
or a lone column (the time MLP's ``fc1``) is split as a whole or
replicated as a whole. It is split where the model axis m > 1 and

* every product of the site is a plain ``w`` or a W8A8 ``w_q`` 2-D weight
  (a weight-only-int8 ``w8`` site replicates: the reference's rule knows
  only ``w`` and ``w_q`` and shards such a site's bias alone);
* m divides each column section's width and the row site's input width;
* an attention's head count is a multiple of m, so each rank holds whole
  heads (the reference splits any divisible width and GSPMD reshards a
  split head).

Column slices follow the product's sections: ``ff1`` feeds GEGLU, whose two
halves are each sliced (rank r holds the r-th slice of each half), and a
fused ``qkv`` (three sections) or ``kv`` (two) likewise. A spec entry
``"model"`` is a contiguous slice of a dimension, ``"model:s"`` the r-th
slice of each of its s sections; ``()`` is replicated.

A LoRA adapter rides its site: ``lora_b``'s columns at a column site,
``lora_a``'s rows at a row site (``shard_adapter``); the reference keeps
adapters replicated, the numbers are the same.
"""

from __future__ import annotations

import torch

from sdtpu_torch.parallel import collectives
from sdtpu_torch.parallel.mesh import Mesh, current
from sdtpu_torch.parallel.mesh import use as use_mesh

# carried over from sdtpu/parallel/sharding.py:25-26
COL_PARENTS = {"q", "k", "v", "qkv", "kv", "fc1", "ff1"}  # output-dim split
ROW_PARENTS = {"out", "fc2", "ff2"}                       # input-dim split

#: a column product's sections: GEGLU's two halves, the fused projections
SECTIONS = {"ff1": 2, "qkv": 3, "kv": 2}
#: the weight fields the plan splits
KERNEL_FIELDS = ("w", "w_q")


def _kernel(site):
    """A site's 2-D ``w`` or ``w_q`` weight, or None (``w8``, a conv)."""
    if not isinstance(site, dict):
        return None
    for f in KERNEL_FIELDS:
        t = site.get(f)
        if t is not None and t.dim() == 2:
            return t
    return None


def _groups(node: dict):
    """[(column names, row name or None, is an attention)] of one dict of
    the tree."""
    out = []
    cols = sorted(c for c in COL_PARENTS - {"fc1", "ff1"} if c in node)
    if "out" in node and cols:
        out.append((cols, "out", True))
    if "ff1" in node and "ff2" in node:
        out.append((["ff1"], "ff2", False))
    if "fc1" in node and "fc2" in node:
        out.append((["fc1"], "fc2", False))
    elif "fc1" in node:
        out.append((["fc1"], None, False))
    return out


def _heads_of(top: str, cfg):
    """The head count of an attention ``width`` wide in tree ``top``, or
    None where the tree holds no transformer attention."""
    if top in ("unet", "controlnet"):
        u = cfg.unet
        return lambda width: width // u.head_dim if u.head_dim else u.num_heads
    if top in ("clip", "clip2"):
        heads = getattr(cfg, top).heads
        return lambda width: heads
    return None


def site_plan(params, model_size: int, cfg) -> dict:
    """{path of a split site: ("col" | "row" | "gather", sections)} for
    the tree at model axis ``model_size``; a path is the tuple of keys
    and list indices from the root to the site's dict. Empty at m = 1."""
    plan = {}
    m = int(model_size)
    if m <= 1:
        return plan

    def split(node, cols, row, heads_of, attention):
        for c in cols:
            w = _kernel(node[c])
            if w is None or w.shape[1] % (SECTIONS.get(c, 1) * m):
                return False
        if row is not None:
            w = _kernel(node[row])
            if w is None or w.shape[0] % m:
                return False
        if attention:
            if heads_of is None:
                return False
            heads = heads_of(_kernel(node[row]).shape[1])
            if heads % m:
                return False
        return True

    def walk(node, path, heads_of):
        if isinstance(node, dict):
            for cols, row, attention in _groups(node):
                if split(node, cols, row, heads_of, attention):
                    for c in cols:
                        plan[path + (c,)] = (
                            "col" if row is not None else "gather",
                            SECTIONS.get(c, 1))
                    if row is not None:
                        plan[path + (row,)] = ("row", 1)
            for k, v in node.items():
                walk(v, path + (k,), heads_of)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + (i,), heads_of)

    for top, tree in params.items():
        walk(tree, (top,), _heads_of(top, cfg))
    return plan


def _axis(sections: int) -> str:
    return "model" if sections == 1 else f"model:{sections}"


def leaf_spec(role, field: str, ndim: int) -> tuple:
    """The spec of a leaf ``field`` of a site with ``role`` (an entry of
    ``site_plan`` or None)."""
    if role is None:
        return ()
    kind, sections = role
    ax = _axis(sections)
    if kind in ("col", "gather"):
        if field in KERNEL_FIELDS + ("lora_b",) and ndim == 2:
            return (None, ax)
        if field in ("b", "w_scale") and ndim == 1:
            return (ax,)
        return ()
    if field in KERNEL_FIELDS + ("lora_a",) and ndim == 2:
        return ("model", None)
    return ()


def _map(node, path, fn):
    if isinstance(node, dict):
        return {k: _map(v, path + (k,), fn) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_map(v, path + (i,), fn)
                          for i, v in enumerate(node))
    return fn(node, path)


def spec_at(plan, path, ndim: int) -> tuple:
    """The spec of the leaf at ``path`` (keys and list indices from the
    root of the pipeline's tree) under ``plan``."""
    return leaf_spec(plan.get(tuple(path[:-1])), path[-1], ndim)


def param_pspecs(params, model_size: int, cfg):
    """The spec tree of ``params`` (tuples, see the module docstring): the
    reference's ``param_pspecs`` decided per site (``site_plan``)."""
    plan = site_plan(params, model_size, cfg)
    return _map(params, (), lambda t, p: spec_at(plan, p, t.dim()))


def whole_shape(shape, spec, m: int) -> tuple:
    """The logical leaf's shape from a rank's slice's ``shape``."""
    return tuple(s * m if i < len(spec) and spec[i] is not None else s
                 for i, s in enumerate(shape))


def check_plan(mesh, plan) -> None:
    """Refuse a tree split over a model axis without its plan: a rank's
    slice cannot be told from a whole leaf."""
    if mesh is not None and mesh.shape["model"] > 1 and plan is None:
        raise ValueError("a tree split over the model axis needs its plan "
                         "(sharding.site_plan of the pipeline's tree)")


def take(t, spec, m: int, r: int):
    """Rank ``r``'s slice of ``t`` along each split dimension of
    ``spec``, a fresh tensor (so the whole one can be freed) in ``t``'s
    layout: a column-major int8 weight stays column-major."""
    out = t
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        sections = int(ax.split(":")[1]) if ":" in ax else 1
        sec = out.shape[dim] // sections
        chunk = sec // m
        parts = [out.narrow(dim, s * sec + r * chunk, chunk)
                 for s in range(sections)]
        out = parts[0] if sections == 1 else torch.cat(parts, dim=dim)
    if t.dim() == 2 and t.t().is_contiguous() and not t.is_contiguous():
        return out.t().clone(memory_format=torch.contiguous_format).t()
    return out.clone(memory_format=torch.contiguous_format)


def shard_params(params, mesh: Mesh, cfg, plan=None):
    """This rank's tree: every leaf of a split site sliced for the rank's
    model coordinate, every other leaf the same tensor. ``plan`` is
    ``site_plan(params, m, cfg)`` where the caller keeps it."""
    m = mesh.shape["model"]
    plan = site_plan(params, m, cfg) if plan is None else plan
    if not plan:
        return params
    r = mesh.coords[1]

    def leaf(t, path):
        spec = spec_at(plan, path, t.dim())
        return take(t, spec, m, r) if spec else t

    return _map(params, (), leaf)


def shard_adapter(adapters, mesh: Mesh, plan, prefix=("unet",)):
    """A LoRA adapter tree sliced as its sites are in ``plan``: a tree of
    the towers (``{"unet": ..., "clip": ...}``, kohya's) or of the UNet
    alone (``prefix`` its place in the pipeline tree)."""
    if not plan:
        return adapters
    m, r = mesh.shape["model"], mesh.coords[1]
    if isinstance(adapters, dict) and set(adapters) <= {"unet", "clip",
                                                        "clip2"}:
        prefix = ()

    def leaf(t, path):
        spec = spec_at(plan, prefix + path, t.dim())
        return take(t, spec, m, r) if spec else t

    return _map(adapters, (), leaf)


def data_rows(x, dim: int = 0):
    """This rank's rows of a batched tensor along ``dim`` on the current
    mesh's data axis (all of them off a mesh or at d = 1)."""
    mesh = current()
    if mesh is None or mesh.shape["data"] == 1 or x is None:
        return x
    d = mesh.shape["data"]
    n = x.shape[dim]
    if n % d:
        raise ValueError(f"batch {n} not divisible by data axis {d}")
    k = n // d
    return x.narrow(dim, mesh.coords[0] * k, k)


def gather_rows(x):
    """The whole batch from every rank's rows (``data_rows`` undone): one
    all-gather over the data group at d > 1."""
    mesh = current()
    if mesh is None or mesh.shape["data"] == 1:
        return x
    return collectives.all_gather(x, "data", 0)


def _untake(parts, spec):
    """The whole leaf from every rank's slice (``take`` undone): the
    slices concatenated along the split dimension, a section at a time."""
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        sections = int(ax.split(":")[1]) if ":" in ax else 1
        if sections == 1:
            return torch.cat(parts, dim=dim)
        chunks = [p.chunk(sections, dim=dim) for p in parts]
        return torch.cat([c[s] for s in range(sections) for c in chunks],
                         dim=dim)
    return parts[0]


def gather_leaf(t, spec, mesh: Mesh):
    """The whole leaf from every rank's slice ``t`` of it: one all-gather
    over the model group, on every rank of it."""
    with use_mesh(mesh):
        parts = collectives.all_gather_parts(t, "model")
    return _untake(parts, spec)


def gather_params(tree, mesh: Mesh, plan, prefix=()):
    """The whole tree from every rank's split one (``shard_params``
    undone): each split leaf all-gathered over the model group (one
    all-gather a leaf) and its slices put back in place; every other leaf
    the same tensor. ``tree`` is the pipeline's tree, or a subtree at
    ``prefix`` (``("unet",)`` for a train state's params, its moments or
    its gradients); ``plan`` is ``site_plan`` of the whole tree. Runs on
    every rank of the model group."""
    if not plan:
        return tree

    def leaf(t, path):
        spec = spec_at(plan, prefix + path, t.dim())
        return gather_leaf(t, spec, mesh) if spec else t

    return _map(tree, (), leaf)


def split_leaves(tree, plan, prefix=()) -> set:
    """The paths of ``tree``'s leaves that hold a rank's slice under
    ``plan`` (a subtree at ``prefix``, as ``gather_params`` takes it)."""
    out = set()

    def leaf(t, path):
        if spec_at(plan, prefix + path, t.dim()):
            out.add(path)
        return t

    _map(tree, (), leaf)
    return out


def generate_sharded(cfg, mesh: Mesh, sampler: str = "dpm", steps: int = 20,
                     use_cfg: bool = True, kernels: str = "plain",
                     spatial: bool = False):
    """The counterpart of the reference's ``jit_generate_sharded``
    (``sdtpu/parallel/sharding.py:216``), with nothing to compile: gives
    ``call(params, tokens, uncond, generator, guidance, **kw)``, the
    pipeline's ``generate`` on this rank's split tree under ``mesh``, with
    ``generate``'s keyword arguments (``noise=``, ``output=``, ...).
    ``spatial=True`` splits the UNet's conv stack over the model axis
    (``parallel.spatial``) for the call. Every rank of the mesh calls
    it."""
    from sdtpu_torch.engine import pipeline
    from sdtpu_torch.parallel import spatial as spatial_mod

    def call(params, tokens, uncond, generator, guidance, **kw):
        with (torch.inference_mode(), use_mesh(mesh),
              spatial_mod.use(mesh if spatial else None)):
            return pipeline.generate(
                params, tokens, uncond, generator, guidance, cfg=cfg,
                sampler=sampler, steps=steps, use_cfg=use_cfg,
                kernels=kernels, **kw)

    return call
