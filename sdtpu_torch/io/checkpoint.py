"""Checkpoints of the pipeline's tree, on one device or on the (data, model)
mesh: the counterpart of ``sdtpu/io/orbax_ckpt.py``.

The reference saves an orbax directory and restores it onto a mesh with
each leaf already split on its devices, no whole copy on a host. Reading
orbax's store needs orbax and tensorstore, which import JAX, so the port
keeps the reference's meaning in its own format: a checkpoint is the
logical (whole) tree as the native file, ``<dir>/model.sdtpu.safetensors``
(``io.weights.save_native``'s flattened JAX-layout tree, which the
reference's ``sdtpu.io.weights.load_native`` reads). It is saved from any
mesh and restored onto any mesh or one device. On a mesh each rank reads
only its own slices, through the file's memory map, and places them on its
card one leaf at a time: no rank holds a whole split leaf or the whole
tree there.

An orbax directory is converted where JAX runs:
``sdtpu.io.orbax_ckpt.load_checkpoint``, then
``sdtpu.io.weights.save_native``; ``io.weights.refuse_orbax`` names the
conversion.
"""

from __future__ import annotations

import contextlib
from pathlib import Path

import torch

from sdtpu_torch.io import safetensors as st
from sdtpu_torch.io.params import cast_params, init_tree, jax_layout, tree_names
from sdtpu_torch.io.weights import (NATIVE_SUFFIX, _flatten_tree,
                                    is_orbax_checkpoint, load_native,
                                    native_file)
from sdtpu_torch.parallel.sharding import (check_plan, gather_leaf,
                                           shard_params, spec_at, whole_shape)

__all__ = ["save_checkpoint", "abstract_params", "load_checkpoint",
           "is_orbax_checkpoint", "save_logical", "CHECKPOINT_FILE"]

#: the file a checkpoint directory holds
CHECKPOINT_FILE = "model" + NATIVE_SUFFIX


def _key_path(key: str) -> tuple:
    return tuple(int(p) if p.isdigit() else p for p in key.split("/"))


def save_logical(tensors: dict, specs: dict, mesh, path,
                 metadata: dict | None = None) -> None:
    """Write {name: tensor} as the safetensors file ``path`` of the logical
    tensors. ``specs``: {name: spec} of the tensors that are this rank's
    slice of a leaf split over ``mesh``'s model axis (``sharding``). The
    header comes from the logical shapes first; then each slice is
    gathered over the model group (``sharding.gather_leaf``) in the file's
    order on every rank of the mesh's first data row, one at a time, and
    the mesh's first rank writes it before the next is gathered, so no rank
    holds more than one whole leaf. That rank alone writes the temporary
    file and renames it; the other data rows gather nothing. Then every
    rank passes a barrier. Every rank of the mesh calls this."""
    m = 1 if mesh is None else mesh.shape["model"]
    shapes = {k: (t.dtype, whole_shape(t.shape, specs.get(k, ()), m))
              for k, t in tensors.items()}
    path = Path(path)
    if mesh is None or mesh.coords[0] == 0:
        writes = mesh is None or mesh.coords[1] == 0
        tmp = path.with_name(path.name + ".tmp")
        if writes:
            path.parent.mkdir(parents=True, exist_ok=True)
        with (st.StreamWriter(tmp, shapes, metadata) if writes
              else contextlib.nullcontext()) as writer, torch.no_grad():
            for k in st.file_order(shapes):
                t = tensors[k]
                if k in specs:
                    t = gather_leaf(t, specs[k], mesh)
                if writer is not None:
                    writer.write(k, t)
                del t
        if writes:
            tmp.replace(path)
    if mesh is not None:
        mesh.barrier()


def save_checkpoint(params, path, mesh=None, plan=None) -> None:
    """Write the port's tree as ``path/model.sdtpu.safetensors``, the native
    file of the logical tree (quantized trees as they are, as
    ``save_native`` writes them). ``mesh`` and ``plan``: ``params`` is this
    rank's tree of the mesh, split by ``plan`` (``site_plan`` of the whole
    tree); every rank of the mesh calls this, and the mesh's first rank
    alone writes (``save_logical``)."""
    check_plan(mesh, plan)
    flat = _flatten_tree(jax_layout(params))
    specs = {}
    for k, t in flat.items():
        spec = spec_at(plan, _key_path(k), t.dim()) if plan else ()
        if spec:
            specs[k] = spec
    save_logical(flat, specs, mesh, Path(path) / CHECKPOINT_FILE)


def abstract_params(cfg, dtype=None, mesh=None):
    """The restore template: the configuration's tree in the port's layout
    on the meta device (nothing is built on a real device), every floating
    leaf in ``dtype`` (kept float32 when None). With ``mesh``, each leaf
    has this rank's shape by the plan (``site_plan`` at the mesh's model
    axis)."""
    meta = torch.device("meta")
    tree = {name: init_tree(name, cfg, None, meta) for name in tree_names(cfg)}
    if dtype is not None:
        tree = cast_params(tree, dtype)
    if mesh is not None:
        tree = shard_params(tree, mesh, cfg)
    return tree


def load_checkpoint(path, cfg, dtype=None, mesh=None, device=None,
                    plan=None):
    """Restore the pipeline's tree from a native file, or a directory
    holding one: ``io.weights.load_native``, which reads the file through
    its memory map, checks it against the configuration, and takes this
    rank's slice of each split leaf one leaf at a time (the plan is
    ``site_plan`` of the file's tree at the mesh's model axis), cast to
    ``dtype`` (kept when None) and copied to ``device``. The result is
    ``shard_params(load_native(...))`` leaf by leaf, without the whole
    tree on ``device``. No collective runs. ``plan``: where given, a dict
    the plan is written into (the Context keeps it to split adapters)."""
    file = native_file(path)
    if file is None:
        raise FileNotFoundError(f"no *{NATIVE_SUFFIX} checkpoint at {path}")
    return load_native(file, cfg, dtype, device, mesh, plan)
