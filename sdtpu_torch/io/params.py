"""Parameter trees: random init, dtype casting, and the bridge from and to
the JAX package's tree.

A tree is nested dicts and lists of tensors with the JAX package's keys
(``sdtpu/io/params.py``): dense ``{"w": (in, out), "b"}``, conv ``{"w":
OIHW, "b"}`` (channels_last memory), norms ``{"scale", "bias"}``; a
quantized site carries ``w8`` + ``w8_scale`` or ``w_q`` + ``w_scale`` (+
``x_scale``) in place of ``w`` (``sdtpu_torch.quant.ptq``). The port
carries the trees of the txt2img path, ``clip``, ``temb``, ``unet`` and
``vae`` (the decoder); for SDXL ``clip2`` (the second text tower, with its
``text_proj``) and ``add_mlp`` (the additive conditioning); and
``vae_enc``, the VAE encoder's parameters (the image paths' encode),
which every SD checkpoint carries. The SDXL refiner has no ``clip`` tree
(``sdtpu/io/params.py:25-40``); LCM's ``temb`` carries ``cond_proj`` and
the x4 upscaler's ``unet`` its ``label_emb`` table.

Per-request adapters: a ``controlnet`` tree (``models.controlnet``),
converted where a tree holds one but never built with the pipeline's
(``ADAPTER_TREES``); and LoRA leaves at a dense or conv site (``lora_a``,
``lora_b``, ``lora_s``, ``train.lora``). A conv site's ``lora_a`` is, like
its weight, OIHW here ([r, in, kh, kw]) and HWIO in the JAX package's
layout ([kh, kw, in, r]); a dense site's ``lora_a`` [in, r], ``lora_b`` [r,
out] and the 0-d ``lora_s`` map 1:1.
"""

from __future__ import annotations

import numpy as np
import torch

from sdtpu_torch.config import PipelineConfig
from sdtpu_torch.models import clip, controlnet, temb, unet, vae
from sdtpu_torch.ops.matmul import column_major
from sdtpu_torch.train.lora import ADAPTER_KEYS

PORTED = ("clip", "clip2", "temb", "unet", "add_mlp", "vae", "vae_enc")
#: the trees of a per-request adapter: converted where a tree holds them,
#: never part of a pipeline's own
ADAPTER_TREES = ("controlnet",)


def init_pipeline_params(cfg: PipelineConfig, generator, device,
                         demo: bool = True):
    """Random float32 parameters built on ``device`` from ``generator``
    (demo and test mode), with the JAX package's init bounds. With
    ``demo=True`` the UNet's zero-initialized output convs get random
    weights, so a fresh UNet does not predict eps == 0. The numbers differ
    from the JAX package's (torch.Generator, not threefry); the shapes do
    not. The trees are drawn in ``PORTED`` order; ``init_tree`` builds one
    at a time from the same generator, with the same numbers."""
    return {name: build(cfg, generator, device, demo)
            for name, build in _builders(cfg).items()}


def _builders(cfg: PipelineConfig, adapters: bool = False) -> dict:
    """name -> builder of each tree the configuration has, in ``PORTED``
    order; with ``adapters`` also of ``ADAPTER_TREES``."""
    out = {
        "clip": lambda c, g, d, demo: clip.init(c.clip, g, d),
        "clip2": lambda c, g, d, demo: clip.init(c.clip2, g, d),
        "temb": lambda c, g, d, demo: temb.init(c.unet, g, d),
        "unet": lambda c, g, d, demo: unet.init(c.unet, g, d,
                                                zero_init_outs=not demo),
        "add_mlp": lambda c, g, d, demo: temb.init_add(c.unet, g, d),
        "vae": lambda c, g, d, demo: vae.init(c.vae, g, d),
        "vae_enc": lambda c, g, d, demo: vae.init_encoder(c.vae, g, d),
    }
    if cfg.clip2 is None:
        del out["clip2"], out["add_mlp"]
    if cfg.refiner:
        # tower 2 alone conditions the refiner
        del out["clip"]
    if adapters:
        out["controlnet"] = lambda c, g, d, demo: controlnet.init(
            c.unet, g, d, zero_init_outs=not demo)
    return out


def tree_names(cfg: PipelineConfig) -> tuple:
    """The trees of ``PORTED`` the configuration has."""
    return tuple(_builders(cfg))


def init_tree(name: str, cfg: PipelineConfig, generator, device,
              demo: bool = True):
    """The tree ``name`` of ``init_pipeline_params``. Called in
    ``tree_names`` order on one generator, it gives that function's numbers
    while only one float32 tree exists at a time."""
    return _builders(cfg)[name](cfg, generator, device, demo)


#: quantization scales stay float32 whatever the compute dtype
#: (``sdtpu/io/params.py:cast_params``)
KEEP_FLOAT32 = ("w8_scale", "w_scale", "x_scale")


def cast_params(params, dtype):
    """Cast every floating leaf once, at load time, except the quantization
    scales (``KEEP_FLOAT32``); int8 leaves are not floating and stay."""
    def cast(node, key=None):
        if isinstance(node, dict):
            return {k: cast(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [cast(v) for v in node]
        if key in KEEP_FLOAT32 or not node.is_floating_point():
            return node
        return node.to(dtype)

    return cast(params)


#: the leaves that hold a conv weight when 4-D: HWIO in the JAX package,
#: OIHW in the port (the CLIP vision tower's ``patch_embedding`` too)
CONV_KEYS = ("w", "w8", "lora_a", "patch_embedding")


def _convert(node, key=None, dtype=None, device=None):
    if isinstance(node, dict):
        return {k: _convert(v, k, dtype, device) for k, v in node.items()}
    if isinstance(node, list):
        return [_convert(v, None, dtype, device) for v in node]
    t = (node if torch.is_tensor(node)
         else torch.from_numpy(np.array(node, copy=True)))
    if device is not None:
        t = t.to(device)
    if (dtype is not None and key not in KEEP_FLOAT32
            and t.is_floating_point()):
        t = t.float().to(dtype)
    if key in CONV_KEYS and t.dim() == 4:   # conv: HWIO -> OIHW
        t = t.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    elif key in ("w8", "w_q") and t.dim() == 2:
        t = column_major(t)   # (in, out) stays; the int8 kernels' memory
    else:
        t = t.contiguous()
    return t


def _quantized_like(want, got):
    """The port's own leaf dict ``want`` (``{"w", "b"}``) quantized the way
    ``got`` was: ``w8`` + ``w8_scale`` (weight-only) or ``w_q`` + ``w_scale``
    (+ ``x_scale`` once calibrated), with the scales' shapes."""
    w = want["w"]
    out = w.shape[0] if w.dim() == 4 else w.shape[1]
    rest = {k: v for k, v in want.items() if k != "w"}
    vec = torch.empty((out,), device="meta")
    if "w8" in got:
        return {"w8": w, "w8_scale": vec, **rest}
    q = {"w_q": w, "w_scale": vec, **rest}
    if "x_scale" in got:
        q["x_scale"] = torch.empty((), device="meta")
    return q


def _check_shapes(got, want, path="params"):
    """``got``'s keys and shapes are ``want``'s; a site's LoRA leaves are
    the adapter's own and not compared."""
    if isinstance(want, dict):
        if isinstance(got, dict):
            got = {k: v for k, v in got.items() if k not in ADAPTER_KEYS}
        if (isinstance(got, dict) and "w" in want and "w" not in got
                and ("w8" in got or "w_q" in got)):
            want = _quantized_like(want, got)
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


def from_jax_tree(tree, cfg: PipelineConfig, dtype=None, device=None):
    """The JAX package's parameter tree (nested dicts and lists of numpy
    arrays or tensors, as from ``sdtpu.io.params.init_pipeline_params``) ->
    the port's tree. Conv weights (``w``, int8 ``w8``, a conv site's
    ``lora_a``) go from HWIO to OIHW; dense weights stay ``(in, out)``, the
    int8 ones (``w8``, ``w_q``) in column-major memory; every other path
    maps 1:1, so a tree that the JAX package quantized or calibrated carries
    its int8 leaves and scales over as they are, and an overlaid one its
    LoRA leaves. Raises if a shape differs from the port's own tree for
    ``cfg`` quantized the same way.

    The trees converted: the configuration's (``tree_names``), and a
    ``controlnet`` tree where ``tree`` has one; ``{"controlnet": ...}``
    alone converts that tree alone. The JAX package's ControlNet for a
    guidance-embedded configuration carries its time MLP's ``cond_proj``,
    which no ControlNet eval reads and no LDM ``control_model.*`` file
    holds; the port's tree (``models.controlnet.init``) leaves it out, so
    a tree from either source has the same keys.

    Leaf by leaf, each is moved to ``device`` (the host when None) and,
    with ``dtype``, every floating leaf but the quantization scales is cast
    to ``dtype`` through float32; without it dtypes are kept. So a tree on
    the host in another dtype never has a second whole copy beside it."""
    names = tree_names(cfg) if set(tree) - set(ADAPTER_TREES) else ()
    names += tuple(n for n in ADAPTER_TREES if n in tree)
    tree = dict(tree)
    if "controlnet" in tree:
        cn = tree["controlnet"]
        tree["controlnet"] = {**cn, "temb": {
            k: v for k, v in cn["temb"].items() if k != "cond_proj"}}
    out = {name: _convert(tree[name], None, dtype, device) for name in names}
    meta = torch.device("meta")
    _check_shapes(out, {name: build(cfg, None, meta, True)
                        for name, build in _builders(cfg, True).items()
                        if name in names})
    return out


def vision_from_jax_tree(tree, vcfg, dtype=None, device=None):
    """The JAX package's CLIP vision tree (``sdtpu.models.clip.init_vision``
    or ``sdtpu.quant.clip_score.vision_params_from_hf``) -> the port's:
    ``patch_embedding`` from HWIO to OIHW in channels_last memory, every
    other leaf 1:1, moved and cast as ``from_jax_tree`` does. Raises if a
    shape differs from ``models.clip.init_vision(vcfg)``'s."""
    out = _convert(tree, None, dtype, device)
    _check_shapes(out, clip.init_vision(vcfg, None, torch.device("meta")),
                  "vision")
    return out


def _map_leaves(fn, node, key=None):
    if isinstance(node, dict):
        return {k: _map_leaves(fn, v, k) for k, v in node.items()}
    if isinstance(node, list):
        return [_map_leaves(fn, v) for v in node]
    return fn(node, key)


def jax_layout(params):
    """The port's tree in the JAX package's layout, on its device, each leaf
    a view where one will do: conv weights (``w``, int8 ``w8``) go from OIHW
    to HWIO; every other leaf keeps its shape. The JAX package's native
    file (``io.weights.save_native``) holds this tree."""
    def leaf(t, key):
        if key in CONV_KEYS and t.dim() == 4:   # OIHW -> HWIO
            return t.permute(2, 3, 1, 0)
        return t

    return _map_leaves(leaf, params)


def to_jax_tree(params):
    """The port's float32 (or int8) tree -> the JAX package's layout, as
    numpy arrays on the host: the inverse of ``from_jax_tree``."""
    return _map_leaves(
        lambda t, _: t.detach().cpu().contiguous().numpy().copy(),
        jax_layout(params))


def fuse_attention_projections(params):
    """Each transformer block's self-attention q, k, v projections as one
    ``qkv`` product and its cross-attention k, v as one ``kv`` product
    (``sdtpu/io/params.py:64-104``): the weights concatenate along the
    output axis. A cross-only attn1 (the x4 upscaler), whose k and v take
    the context's width, fuses them into ``kv`` as attn2 does; the
    reference tells it by k's input width. Applied after load and the
    cast, to an unquantized tree; checkpoints and the quantizers keep the
    unfused layout."""
    def kv(a):
        return {"q": a["q"], "kv": {"w": torch.cat(
            [a["k"]["w"], a["v"]["w"]], dim=1)}, "out": a["out"]}

    def walk(node):
        if isinstance(node, dict):
            if ("attn1" in node and "attn2" in node
                    and "w" in node["attn1"].get("q", {})):
                a1 = node["attn1"]
                if a1["k"]["w"].shape[0] == a1["q"]["w"].shape[0]:
                    a1 = {"qkv": {"w": torch.cat(
                        [a1["q"]["w"], a1["k"]["w"], a1["v"]["w"]],
                        dim=1)}, "out": a1["out"]}
                else:
                    a1 = kv(a1)
                return {**node, "attn1": a1, "attn2": kv(node["attn2"])}
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node

    return walk(params)


def _adam_state(node):
    """The ``ScaleByAdamState`` (``count``, ``mu``, ``nu``) inside an optax
    state: a chain's tuple, a ``multi_transform``'s dict of inner states, a
    masked state's ``inner_state``; found by its fields, without optax."""
    if all(hasattr(node, f) for f in ("count", "mu", "nu")):
        return node
    if isinstance(node, dict):
        children = list(node.values())
    elif isinstance(node, (tuple, list)):
        children = list(node)
    else:
        return None
    for child in children:
        found = _adam_state(child)
        if found is not None:
            return found
    return None


def opt_state_from_jax(opt_state, device=None) -> dict:
    """optax's AdamW state (``sdtpu.train.make_optimizer`` or
    ``make_lora_optimizer``: ``ScaleByAdamState`` beside the clip's empty
    state, inside a ``multi_transform`` for LoRA) -> the port's optimizer
    state (``train.step.AdamW.init``'s layout): ``count`` a host int64,
    ``mu`` and ``nu`` {flat key: float32 tensor} of every leaf that has
    moments, in the port's layout (a conv weight's HWIO -> OIHW); a masked
    leaf (optax's ``MaskedNode``, an empty tuple) has none."""
    adam = _adam_state(opt_state)
    if adam is None:
        raise ValueError("no ScaleByAdamState (count, mu, nu) in the state")

    def flat(tree):
        out = {}

        def walk(node, path, key):
            if isinstance(node, dict):
                for k, v in node.items():
                    walk(v, path + (k,), k)
            elif isinstance(node, (list, tuple)):
                for i, v in enumerate(node):
                    walk(v, path + (i,), None)
            elif node is not None and hasattr(node, "shape"):
                out["/".join(map(str, path))] = _convert(
                    node, key, torch.float32, device)

        walk(tree, (), None)
        return out

    return {"count": torch.tensor(int(np.asarray(adam.count)),
                                  dtype=torch.int64),
            "mu": flat(adam.mu), "nu": flat(adam.nu)}
