"""LoRA adapters, the counterpart of ``sdtpu/train/lora.py``: training
(``inject_lora``, ``lora_mask``, ``make_lora_optimizer``) and serving.

An adapter lives inside the parameter tree: a dense site gains ``lora_a``
[in, r], ``lora_b`` [r, out] and ``lora_s`` (alpha / r, 0-d), and
``layers.dense`` adds ``(x A) B s`` on every base path, the quantized ones
too; a conv site's ``lora_a`` is a down conv, OIHW [r, in, kh, kw] here as
conv weights are (``layers.conv2d``). An adapter tree holds only those
leaves, tree-shaped (``extract_lora``), and ``apply_lora`` overlays it on a
base tree, sharing every base tensor; ``merge_lora`` folds it into the
weights. The ``.npz`` file (``save_lora_npz``, ``load_lora_npz``) is the
JAX package's: '/'-joined tree paths, a conv site's ``lora_a`` in HWIO.

Training reuses ``train.step``: ``inject_lora`` adds fresh adapters to
the float32 masters (B zero, so the injected model is the base), and
``make_lora_optimizer`` moves their A and B alone, every other leaf's
update exactly zero; the step still takes every leaf's gradient, so its
``grad_norm`` is the reference's ``optax.global_norm`` over the whole tree.
"""

from __future__ import annotations

import math

import numpy as np
import torch

#: a LoRA site's leaves
ADAPTER_KEYS = ("lora_a", "lora_b", "lora_s")
#: dense-site names that receive adapters: the attention projections and
#: the feed-forward products (``sdtpu/train/lora.py:32``)
LORA_TARGETS = frozenset({"q", "k", "v", "out", "ff1", "ff2"})


def _walk(node, fn, path=()):
    if isinstance(node, dict):
        return {k: _walk(v, fn, path + (k,)) for k, v in node.items()}
    if isinstance(node, list):
        return [_walk(v, fn, path + (i,)) for i, v in enumerate(node)]
    return fn(path, node)


def _site_dicts(node, path=(), targets=LORA_TARGETS):
    """(path, site dict) of every dense site with a 2-D weight whose name
    is in ``targets``."""
    if isinstance(node, dict):
        w = node.get("w")
        if (w is not None and getattr(w, "ndim", 0) == 2 and path
                and path[-1] in targets):
            yield path, node
        for k, v in node.items():
            yield from _site_dicts(v, path + (k,), targets)
    elif isinstance(node, list):
        for i, v in enumerate(node):
            yield from _site_dicts(v, path + (i,), targets)


def inject_lora(params, rank: int, generator, alpha: float | None = None,
                targets=LORA_TARGETS, dtype=torch.float32, a=None):
    """A copy of ``params`` (sharing every base tensor) with an adapter at
    each target dense site: ``lora_a`` [in, rank] drawn from ``generator``
    in site order, N(0, 1) / sqrt(in) (Kaiming), ``lora_b`` [rank, out]
    zero, ``lora_s`` = alpha / rank (alpha defaults to rank). The injected
    model equals the base until training moves B. ``a``: {site path:
    [in, rank] array} hands in A (the tests pass the reference's)."""
    alpha = float(rank) if alpha is None else float(alpha)
    lora_at = {}
    for path, node in _site_dicts(params, targets=frozenset(targets)):
        w = node["w"]
        d_in, d_out = w.shape
        if a is not None and path in a:
            # a copy: the injected leaf trains in place
            la = torch.tensor(np.array(a[path], dtype=np.float32),
                              dtype=dtype, device=w.device)
        else:
            la = torch.randn((d_in, rank), generator=generator,
                             dtype=torch.float32, device=w.device
                             ).div_(math.sqrt(d_in)).to(dtype)
        lora_at[path] = {
            "lora_a": la,
            "lora_b": torch.zeros((rank, d_out), dtype=dtype,
                                  device=w.device),
            "lora_s": torch.tensor(alpha / rank, dtype=dtype,
                                   device=w.device)}

    def patch(node, path=()):
        if isinstance(node, dict):
            out = {k: patch(v, path + (k,)) for k, v in node.items()}
            if path in lora_at:
                out.update(lora_at[path])
            return out
        if isinstance(node, list):
            return [patch(v, path + (i,)) for i, v in enumerate(node)]
        return node

    return patch(params)


def is_adapter(path) -> bool:
    """Is the leaf at ``path`` an adapter's A or B (what LoRA trains)?"""
    return bool(path) and path[-1] in ("lora_a", "lora_b")


def lora_mask(params):
    """A tree of bools: True exactly on the adapter leaves A and B."""
    return _walk(params, lambda path, leaf: is_adapter(path))


def make_lora_optimizer(lr: float = 1e-4, weight_decay: float = 0.0,
                        grad_clip: float = 1.0):
    """AdamW over the adapter leaves only (``sdtpu/train/lora.py:96-112``):
    moments for A and B alone, their gradients clipped by their own global
    norm, and every other leaf's update exactly zero."""
    from sdtpu_torch.train.step import AdamW

    return AdamW(lr=lr, weight_decay=weight_decay, grad_clip=grad_clip,
                 trainable=is_adapter)


def merge_lora(params):
    """``W += A B s`` at every adapted site, the adapter leaves dropped, in
    float32 and back to the weight's dtype (a conv site folds each tap:
    ``W[o, i, h, w] += sum_r B[r, o] A[r, i, h, w] s``)."""
    def patch(node):
        if isinstance(node, dict):
            out = {k: patch(v) for k, v in node.items()
                   if k not in ADAPTER_KEYS}
            if "lora_a" in node:
                w = node["w"]
                a = node["lora_a"].float()
                b = node["lora_b"].float()
                s = node["lora_s"].float()
                if a.dim() == 4:
                    delta = torch.einsum("rihw,ro->oihw", a, b) * s
                else:
                    delta = a @ b * s
                out["w"] = (w.float() + delta).to(w.dtype).contiguous(
                    memory_format=(torch.channels_last if w.dim() == 4
                                   else torch.contiguous_format))
            return out
        if isinstance(node, list):
            return [patch(v) for v in node]
        return node

    return patch(params)


def extract_lora(params):
    """The adapter leaves alone, tree-shaped: a list keeps a slot (``{}``)
    where a sibling has an adapter, a branch without one is dropped."""
    def patch(node):
        if isinstance(node, dict):
            out = {}
            for k, v in node.items():
                if k in ADAPTER_KEYS:
                    out[k] = v
                else:
                    sub = patch(v)
                    if sub not in ({}, []):
                        out[k] = sub
            return out
        if isinstance(node, list):
            subs = [patch(v) for v in node]
            return subs if any(s not in ({}, []) for s in subs) else []
        return None

    return patch(params)


def _npz_layout(t, key, to_file: bool):
    """A leaf between the port's layout and the file's (the JAX package's):
    a conv site's ``lora_a`` is OIHW here (in channels_last memory, as
    the port keeps conv weights), HWIO there."""
    if key == "lora_a" and t.dim() == 4:
        return t.permute(2, 3, 1, 0) if to_file else t.permute(
            3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    return t


def save_lora_npz(adapters, path) -> None:
    """Write an adapter tree as one ``.npz``: keys are the '/'-joined tree
    paths (list indices as numbers), leaves in the JAX package's layout."""
    flat = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (str(k),))
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, path + (str(i),))
        elif node is not None:
            t = _npz_layout(torch.as_tensor(node), path[-1], True)
            flat["/".join(path)] = t.detach().cpu().contiguous().numpy()

    walk(adapters, ())
    np.savez(path, **flat)


def load_lora_npz(path):
    """The adapter tree of a ``save_lora_npz`` file (either package's), on
    the host, in the port's layout. Numeric path parts become list indices;
    a list's missing slots (adapter-free sites flatten away) are empty
    overlays."""
    root: dict = {}
    with np.load(path) as flat:
        for key in flat.files:
            node = root
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = _npz_layout(
                torch.from_numpy(np.array(flat[key])), parts[-1], False)

    def listify(node):
        if isinstance(node, dict):
            if node and all(k.isdigit() for k in node):
                n = max(int(k) for k in node) + 1
                return [listify(node.get(str(i), {})) for i in range(n)]
            return {k: listify(v) for k, v in node.items()}
        return node

    return listify(root)


def apply_lora(params, adapters):
    """``params`` with the adapter tree overlaid: each adapter's leaves join
    its site's dict, every other tensor is the base's. A site the base tree
    does not have (a q, k or v projection fused into ``qkv`` or ``kv``) is
    skipped, as the reference skips it."""
    def patch(node, ad):
        if isinstance(node, dict):
            out = dict(node)
            for k, v in (ad or {}).items():
                if k in ADAPTER_KEYS:
                    out[k] = v
                elif k in out:
                    out[k] = patch(out[k], v)
            return out
        if isinstance(node, list):
            ad = ad or []
            return [patch(v, ad[i] if i < len(ad) else None)
                    for i, v in enumerate(node)]
        return node

    return patch(params, adapters)
