"""Parameter trees: random init, dtype casting, and the bridge from the JAX
package's tree.

A tree is nested dicts and lists of tensors with the JAX package's keys
(``sdtpu/io/params.py``): dense ``{"w": (in, out), "b"}``, conv ``{"w":
OIHW, "b"}`` (channels_last memory), norms ``{"scale", "bias"}``. The port
carries the four trees of the txt2img path: ``clip``, ``temb``, ``unet`` and
``vae`` (the decoder).
"""

from __future__ import annotations

import numpy as np
import torch

from sdtpu_torch.config import PipelineConfig
from sdtpu_torch.models import clip, temb, unet, vae

PORTED = ("clip", "temb", "unet", "vae")


def init_pipeline_params(cfg: PipelineConfig, generator, device,
                         demo: bool = True):
    """Random float32 parameters built on ``device`` from ``generator``
    (demo and test mode), with the JAX package's init bounds. With
    ``demo=True`` the UNet's zero-initialized output convs get random
    weights, so a fresh UNet does not predict eps == 0. The numbers differ
    from the JAX package's (torch.Generator, not threefry); the shapes do
    not."""
    return {
        "clip": clip.init(cfg.clip, generator, device),
        "temb": temb.init(cfg.unet, generator, device),
        "unet": unet.init(cfg.unet, generator, device,
                          zero_init_outs=not demo),
        "vae": vae.init(cfg.vae, generator, device),
    }


def _map(fn, node):
    if isinstance(node, dict):
        return {k: _map(fn, v) for k, v in node.items()}
    if isinstance(node, list):
        return [_map(fn, v) for v in node]
    return fn(node)


def cast_params(params, dtype):
    """Cast every floating leaf once, at load time."""
    return _map(lambda a: a.to(dtype) if a.is_floating_point() else a,
                params)


def _convert(node, key=None):
    if isinstance(node, dict):
        return {k: _convert(v, k) for k, v in node.items()}
    if isinstance(node, list):
        return [_convert(v) for v in node]
    t = torch.from_numpy(np.array(node, copy=True))
    if key == "w" and t.dim() == 4:   # conv: HWIO -> OIHW
        t = t.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    return t


def _check_shapes(got, want, path="params"):
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            raise ValueError(f"{path}: keys {sorted(got)} != {sorted(want)}")
        for k in want:
            _check_shapes(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        if not isinstance(got, list) or len(got) != len(want):
            raise ValueError(f"{path}: list length mismatch")
        for i, (g, w) in enumerate(zip(got, want)):
            _check_shapes(g, w, f"{path}[{i}]")
    elif tuple(got.shape) != tuple(want.shape):
        raise ValueError(f"{path}: shape {tuple(got.shape)} != "
                         f"{tuple(want.shape)}")


def from_jax_tree(tree, cfg: PipelineConfig):
    """The JAX package's parameter tree (nested dicts and lists of numpy
    arrays, as from ``sdtpu.io.params.init_pipeline_params``) -> the port's
    float32 CPU tree. Conv weights go from HWIO to OIHW; dense weights stay
    ``(in, out)``; every other path maps 1:1. Subtrees the port does not run
    (the VAE encoder) are dropped. Raises if a shape differs from the
    port's own tree for ``cfg``."""
    out = {name: _convert(tree[name]) for name in PORTED}
    _check_shapes(out, init_pipeline_params(cfg, None, torch.device("meta")))
    return out
