"""Checkpoint loading: Stable Diffusion v1.x, v2.x and XL weights (and the
staged configurations': LCM, the x4 upscaler, the SDXL refiner) -> the
port's tree.

Carried over from ``sdtpu/io/weights.py`` (the JAX package), cut to the
txt2img families the port serves: the rule tables that map the
CompVis/LDM key names (``model.diffusion_model.*``,
``cond_stage_model.transformer.*``, ``first_stage_model.*``) onto the JAX
package's tree; SD 2.x's OpenCLIP tower (``cond_stage_model.model.*``, one
fused ``in_proj`` a block) and SDXL's two (``conditioner.embedders.0``
HF-CLIP, ``.1`` OpenCLIP bigG with its ``text_projection``; the refiner's
one bigG under ``conditioner.embedders.0.model``); LCM's
``time_embed.cond_proj`` and the x4 upscaler's ``label_emb`` table; the
inverse
(``params_to_ldm``); and the native file (``*.sdtpu.safetensors``: the
flattened JAX-layout tree, the JAX package's format, so a file written by
either package loads in both). The rules are generated from the same loops
that build the trees, so block indices cannot drift from the architecture.

Conventions: torch Linear kernels are [out, in] and conv kernels OIHW in a
checkpoint; the rules build the JAX package's layout (dense ``(in, out)``,
conv HWIO) as views, and ``io.params.from_jax_tree`` makes the port's tree
of it, one leaf at a time: one layout rule, not two.

ControlNet checkpoints (``control_model.*``) map onto the
``models.controlnet`` tree by ``controlnet_rules``, which reuse the UNet's
ResBlock and transformer rules (``load_controlnet_state_dict``,
``controlnet_to_ldm``); they are adapters, loaded by
``Context.load_controlnet``, not a base model for ``model_dir``.

Files are read and written by ``io.safetensors``; the ``safetensors``
package is not needed. The native file is the port's checkpoint, on one
device or a mesh (``io.checkpoint``). An orbax directory cannot be read
without JAX: ``UnsupportedCheckpoint`` names the conversion where JAX runs
(``refuse_orbax``); it also names a ControlNet handed to ``model_dir``.
"""

from __future__ import annotations

from pathlib import Path
from typing import NamedTuple

import torch

from sdtpu_torch.config import PipelineConfig
from sdtpu_torch.io import safetensors as st
from sdtpu_torch.io.params import (ADAPTER_TREES, PORTED, _convert,
                                   from_jax_tree, jax_layout, tree_names)
from sdtpu_torch.parallel.sharding import site_plan, spec_at, take


class UnsupportedCheckpoint(ValueError):
    """A checkpoint of a family or format the port does not load yet."""


class Rule(NamedTuple):
    ldm: str            # LDM key prefix (without .weight/.bias suffix)
    path: tuple         # path into the tree (without final w/b/scale/bias)
    kind: str           # 'linear' | 'conv' | 'norm' | 'embed'


# ---------------------------------------------------------------------------
# rule generation (mirrors models/*.init loops)
# ---------------------------------------------------------------------------

def _st_rules(ldm_prefix: str, path: tuple, depth: int = 1) -> list[Rule]:
    """A spatial transformer of ``depth`` basic blocks: flat in the tree at
    depth 1, nested under ``blocks`` deeper (``models/unet.py``)."""
    rules = [
        Rule(ldm_prefix + "norm", path + ("norm",), "norm"),
        Rule(ldm_prefix + "proj_in", path + ("proj_in",), "conv"),
    ]
    for d in range(depth):
        tb = ldm_prefix + f"transformer_blocks.{d}."
        bp = path if depth == 1 else path + ("blocks", d)
        rules += [
            Rule(tb + "norm1", bp + ("ln1",), "norm"),
            Rule(tb + "attn1.to_q", bp + ("attn1", "q"), "linear"),
            Rule(tb + "attn1.to_k", bp + ("attn1", "k"), "linear"),
            Rule(tb + "attn1.to_v", bp + ("attn1", "v"), "linear"),
            Rule(tb + "attn1.to_out.0", bp + ("attn1", "out"), "linear"),
            Rule(tb + "norm2", bp + ("ln2",), "norm"),
            Rule(tb + "attn2.to_q", bp + ("attn2", "q"), "linear"),
            Rule(tb + "attn2.to_k", bp + ("attn2", "k"), "linear"),
            Rule(tb + "attn2.to_v", bp + ("attn2", "v"), "linear"),
            Rule(tb + "attn2.to_out.0", bp + ("attn2", "out"), "linear"),
            Rule(tb + "norm3", bp + ("ln3",), "norm"),
            Rule(tb + "ff.net.0.proj", bp + ("ff1",), "linear"),
            Rule(tb + "ff.net.2", bp + ("ff2",), "linear"),
        ]
    rules.append(Rule(ldm_prefix + "proj_out", path + ("proj_out",), "conv"))
    return rules


def _res_rules(ldm_prefix: str, path: tuple, has_skip: bool) -> list[Rule]:
    rules = [
        Rule(ldm_prefix + "in_layers.0", path + ("norm1",), "norm"),
        Rule(ldm_prefix + "in_layers.2", path + ("conv1",), "conv"),
        Rule(ldm_prefix + "emb_layers.1", path + ("emb",), "linear"),
        Rule(ldm_prefix + "out_layers.0", path + ("norm2",), "norm"),
        Rule(ldm_prefix + "out_layers.3", path + ("conv2",), "conv"),
    ]
    if has_skip:
        rules.append(Rule(ldm_prefix + "skip_connection", path + ("skip",),
                          "conv"))
    return rules


def unet_rules(cfg: PipelineConfig) -> list[Rule]:
    u = cfg.unet
    pre = "model.diffusion_model."
    rules = [
        Rule(pre + "time_embed.0", ("temb", "fc0"), "linear"),
        Rule(pre + "time_embed.2", ("temb", "fc1"), "linear"),
        Rule(pre + "input_blocks.0.0", ("unet", "conv_in"), "conv"),
    ]
    if u.time_cond_proj_dim:
        # LCM's bias-free guidance projection: LDM has no such layer, so
        # the name is the JAX package's (diffusers: time_embedding.cond_proj)
        rules.append(Rule(pre + "time_embed.cond_proj", ("temb", "cond_proj"),
                          "linear"))
    if u.num_class_embeds:
        # the x4 upscaler's noise-level table (an nn.Embedding)
        rules.append(Rule(pre + "label_emb", ("unet", "label_emb"), "embed"))
    ch = u.model_channels
    cur = ch
    idx = 1
    skip_chs = [ch]
    for lvl, mult in enumerate(u.channel_mult):
        out_ch = ch * mult
        for b in range(u.num_res_blocks):
            p = ("unet", "down", lvl, "blocks", b)
            rules += _res_rules(f"{pre}input_blocks.{idx}.0.", p + ("res",),
                                has_skip=cur != out_ch)
            cur = out_ch
            if lvl in u.attn_levels:
                rules += _st_rules(f"{pre}input_blocks.{idx}.1.", p + ("st",),
                                   u.depth_at(lvl))
            skip_chs.append(cur)
            idx += 1
        if lvl != len(u.channel_mult) - 1:
            rules.append(Rule(f"{pre}input_blocks.{idx}.0.op",
                              ("unet", "down", lvl, "down"), "conv"))
            skip_chs.append(cur)
            idx += 1

    rules += _res_rules(pre + "middle_block.0.", ("unet", "mid", "res1"),
                        False)
    rules += _st_rules(pre + "middle_block.1.", ("unet", "mid", "st"),
                       u.mid_depth())
    rules += _res_rules(pre + "middle_block.2.", ("unet", "mid", "res2"),
                        False)

    idx = 0
    for k, lvl in enumerate(reversed(range(len(u.channel_mult)))):
        out_ch = ch * u.channel_mult[lvl]
        for b in range(u.num_res_blocks + 1):
            skip = skip_chs.pop()
            p = ("unet", "up", k, "blocks", b)
            rules += _res_rules(f"{pre}output_blocks.{idx}.0.", p + ("res",),
                                has_skip=cur + skip != out_ch)
            cur = out_ch
            comp = 1
            if lvl in u.attn_levels:
                rules += _st_rules(f"{pre}output_blocks.{idx}.{comp}.",
                                   p + ("st",), u.depth_at(lvl))
                comp += 1
            if b == u.num_res_blocks and lvl != 0:
                rules.append(Rule(
                    f"{pre}output_blocks.{idx}.{comp}.conv",
                    ("unet", "up", k, "up"), "conv",
                ))
            idx += 1

    rules += [
        Rule(pre + "out.0", ("unet", "out_norm"), "norm"),
        Rule(pre + "out.2", ("unet", "conv_out"), "conv"),
    ]
    if u.adm_in_channels:
        # SDXL's pooled/micro-conditioning MLP (sgm names it label_emb)
        rules += [
            Rule(pre + "label_emb.0.0", ("add_mlp", "fc0"), "linear"),
            Rule(pre + "label_emb.0.2", ("add_mlp", "fc1"), "linear"),
        ]
    return rules


def clip_rules(cfg: PipelineConfig,
               pre: str = "cond_stage_model.transformer.text_model.",
               ) -> list[Rule]:
    rules = [
        Rule(pre + "embeddings.token_embedding", ("clip", "token_embedding"),
             "embed"),
        Rule(pre + "embeddings.position_embedding",
             ("clip", "position_embedding"), "embed"),
        Rule(pre + "final_layer_norm", ("clip", "final_ln"), "norm"),
    ]
    for i in range(cfg.clip.layers):
        b = f"{pre}encoder.layers.{i}."
        p = ("clip", "blocks", i)
        rules += [
            Rule(b + "layer_norm1", p + ("ln1",), "norm"),
            Rule(b + "self_attn.q_proj", p + ("q",), "linear"),
            Rule(b + "self_attn.k_proj", p + ("k",), "linear"),
            Rule(b + "self_attn.v_proj", p + ("v",), "linear"),
            Rule(b + "self_attn.out_proj", p + ("out",), "linear"),
            Rule(b + "layer_norm2", p + ("ln2",), "norm"),
            Rule(b + "mlp.fc1", p + ("fc1",), "linear"),
            Rule(b + "mlp.fc2", p + ("fc2",), "linear"),
        ]
    return rules


def vae_rules(cfg: PipelineConfig) -> list[Rule]:
    v = cfg.vae
    pre = "first_stage_model."
    dec = pre + "decoder."
    rules = [
        Rule(pre + "post_quant_conv", ("vae", "post_quant"), "conv"),
        Rule(dec + "conv_in", ("vae", "conv_in"), "conv"),
    ]

    def res(ldm, path, c_in, c_out):
        out = [
            Rule(ldm + "norm1", path + ("norm1",), "norm"),
            Rule(ldm + "conv1", path + ("conv1",), "conv"),
            Rule(ldm + "norm2", path + ("norm2",), "norm"),
            Rule(ldm + "conv2", path + ("conv2",), "conv"),
        ]
        if c_in != c_out:
            out.append(Rule(ldm + "nin_shortcut", path + ("nin",), "conv"))
        return out

    def attn(ldm, path):
        return [
            Rule(ldm + "norm", path + ("norm",), "norm"),
            Rule(ldm + "q", path + ("q",), "conv"),
            Rule(ldm + "k", path + ("k",), "conv"),
            Rule(ldm + "v", path + ("v",), "conv"),
            Rule(ldm + "proj_out", path + ("proj",), "conv"),
        ]

    widest = v.base_channels * v.channel_mult[-1]
    rules += res(dec + "mid.block_1.", ("vae", "mid", "res1"), widest, widest)
    rules += attn(dec + "mid.attn_1.", ("vae", "mid", "attn"))
    rules += res(dec + "mid.block_2.", ("vae", "mid", "res2"), widest, widest)

    # LDM stores decoder levels as up[i_level] (0 = finest); processing order
    # is reversed, and the tree's "up" list is in processing order.
    cur = widest
    n_lvl = len(v.channel_mult)
    for k, lvl in enumerate(reversed(range(n_lvl))):
        out_ch = v.base_channels * v.channel_mult[lvl]
        for b in range(v.num_res_blocks + 1):
            rules += res(
                f"{dec}up.{lvl}.block.{b}.",
                ("vae", "up", k, "blocks", b), cur, out_ch,
            )
            cur = out_ch
        if lvl != 0:
            rules.append(Rule(f"{dec}up.{lvl}.upsample.conv",
                              ("vae", "up", k, "up"), "conv"))
    rules += [
        Rule(dec + "norm_out", ("vae", "norm_out"), "norm"),
        Rule(dec + "conv_out", ("vae", "conv_out"), "conv"),
    ]

    # encoder (img2img; every SD checkpoint carries it)
    enc = pre + "encoder."
    rules += [
        Rule(enc + "conv_in", ("vae_enc", "conv_in"), "conv"),
        Rule(pre + "quant_conv", ("vae_enc", "quant"), "conv"),
    ]
    cur = v.base_channels
    for lvl, mult in enumerate(v.channel_mult):
        out_ch = v.base_channels * mult
        for b in range(v.num_res_blocks):
            rules += res(
                f"{enc}down.{lvl}.block.{b}.",
                ("vae_enc", "down", lvl, "blocks", b), cur, out_ch,
            )
            cur = out_ch
        if lvl != n_lvl - 1:
            rules.append(Rule(f"{enc}down.{lvl}.downsample.conv",
                              ("vae_enc", "down", lvl, "down"), "conv"))
    rules += res(enc + "mid.block_1.", ("vae_enc", "mid", "res1"), cur, cur)
    rules += attn(enc + "mid.attn_1.", ("vae_enc", "mid", "attn"))
    rules += res(enc + "mid.block_2.", ("vae_enc", "mid", "res2"), cur, cur)
    rules += [
        Rule(enc + "norm_out", ("vae_enc", "norm_out"), "norm"),
        Rule(enc + "conv_out", ("vae_enc", "conv_out"), "conv"),
    ]
    return rules


def all_rules(cfg: PipelineConfig, include_clip: bool = True) -> list[Rule]:
    rules = unet_rules(cfg) + vae_rules(cfg)
    if include_clip:
        rules += clip_rules(cfg)
    return rules


def controlnet_rules(cfg: PipelineConfig,
                     pre: str = "control_model.") -> list[Rule]:
    """LDM ControlNet keys (``control_model.*``) -> the ``models.controlnet``
    tree, paths relative to its root (``sdtpu/io/weights.py:279-323``): the
    encoder mirrors ``unet_rules``' input and middle loops; on top, the
    ``input_hint_block`` convs (even submodule indices; the odd ones are
    SiLUs), ``zero_convs.N.0`` (one a skip, in push order) and
    ``middle_block_out.0``."""
    u = cfg.unet
    rules = [
        Rule(pre + "time_embed.0", ("temb", "fc0"), "linear"),
        Rule(pre + "time_embed.2", ("temb", "fc1"), "linear"),
        Rule(pre + "input_blocks.0.0", ("conv_in",), "conv"),
    ]
    for k in range(8):  # 7 body convs + the projection
        rules.append(Rule(f"{pre}input_hint_block.{2 * k}", ("hint", k),
                          "conv"))
    z = 0

    def zero():
        nonlocal z
        rules.append(Rule(f"{pre}zero_convs.{z}.0", ("zero", z), "conv"))
        z += 1

    zero()
    ch = u.model_channels
    cur = ch
    idx = 1
    for lvl, mult in enumerate(u.channel_mult):
        out_ch = ch * mult
        for b in range(u.num_res_blocks):
            p = ("down", lvl, "blocks", b)
            rules += _res_rules(f"{pre}input_blocks.{idx}.0.", p + ("res",),
                                has_skip=cur != out_ch)
            cur = out_ch
            if lvl in u.attn_levels:
                rules += _st_rules(f"{pre}input_blocks.{idx}.1.", p + ("st",),
                                   u.depth_at(lvl))
            zero()
            idx += 1
        if lvl != len(u.channel_mult) - 1:
            rules.append(Rule(f"{pre}input_blocks.{idx}.0.op",
                              ("down", lvl, "down"), "conv"))
            zero()
            idx += 1
    rules += _res_rules(pre + "middle_block.0.", ("mid", "res1"), False)
    rules += _st_rules(pre + "middle_block.1.", ("mid", "st"), u.mid_depth())
    rules += _res_rules(pre + "middle_block.2.", ("mid", "res2"), False)
    rules.append(Rule(pre + "middle_block_out.0", ("zero_mid",), "conv"))
    return rules


def load_controlnet_state_dict(tensors: dict, cfg: PipelineConfig,
                               strict: bool = True, dtype=torch.float32,
                               device=None):
    """LDM-named ControlNet {key: tensor} -> the port's ``controlnet`` tree,
    each leaf through float32 to ``dtype`` on ``device`` (the host by
    default). With ``strict`` a missing key raises the reference's
    ``KeyError``; without it the keys there are converted (the partial
    tree of the reference's non-strict load)."""
    tree: dict = {}
    missing = []
    for rule in controlnet_rules(cfg):
        for ldm_suffix, ours in _SUFFIX[rule.kind]:
            key = f"{rule.ldm}.{ldm_suffix}"
            if key not in tensors:
                if ldm_suffix == "bias":
                    continue
                missing.append(key)
                continue
            t = tensors[key]
            val = _from_ldm(rule.kind, ours, t) if ours else t
            _tree_set(tree, rule.path + ((ours,) if ours else ()), val)
    if missing:
        if strict:
            raise KeyError(f"{len(missing)} ControlNet keys missing, first: "
                           f"{missing[:5]}")
        # a partial tree: converted leaf by leaf, no shape check
        return _convert(tree, None, dtype or torch.float32, device)
    return from_jax_tree({"controlnet": tree}, cfg, dtype=dtype or
                         torch.float32, device=device)["controlnet"]


def controlnet_to_ldm(params, cfg: PipelineConfig, pre: str = "control_model.",
                      dtype=torch.float32) -> dict:
    """The port's ``controlnet`` tree -> LDM-named {key: contiguous tensor}
    on the host, each leaf cast to ``dtype`` (export and round trips)."""
    tree = jax_layout(params)
    out = {}
    for rule in controlnet_rules(cfg, pre):
        node = _tree_get(tree, rule.path)
        for ldm_suffix, ours in _SUFFIX[rule.kind]:
            if ours is not None and ours not in node:
                continue
            t = _to_ldm(rule.kind, ours or "w", node[ours] if ours else node)
            out[f"{rule.ldm}.{ldm_suffix}"] = t.detach().to(
                "cpu", dtype).contiguous()
    return out


# ---------------------------------------------------------------------------
# OpenCLIP text towers (SD 2.x: cond_stage_model.model.*; SDXL's bigG)
# ---------------------------------------------------------------------------

OPENCLIP_PREFIX = "cond_stage_model.model."
#: SDXL's tower prefixes (the sgm conditioner layout)
XL_CLIP_PREFIX = "conditioner.embedders.0.transformer.text_model."
XL_CLIP2_PREFIX = "conditioner.embedders.1.model."
#: the refiner's bigG is its first and only embedder
XL_REFINER_CLIP2_PREFIX = "conditioner.embedders.0.model."


def openclip_text_to_tree(tensors: dict, ccfg, pre: str = OPENCLIP_PREFIX):
    """OpenCLIP-named keys -> a text tower's tree in the JAX layout (views):
    each block's fused ``in_proj_weight`` [3d, d] / ``in_proj_bias`` [3d]
    split into q, k and v; ``text_projection`` ([d, proj], used as ``x @
    W``) taken as it is where the tower has a projection. ``ccfg.layers``
    blocks are read: SD2's checkpoint holds 24, its pre-cut config reads 23
    and ignores the last (``sdtpu/io/weights.py:379-423``)."""
    d = ccfg.hidden

    def t(name):
        return tensors[pre + name]

    tree = {
        "token_embedding": t("token_embedding.weight"),
        "position_embedding": t("positional_embedding"),
        "final_ln": {"scale": t("ln_final.weight"),
                     "bias": t("ln_final.bias")},
        "blocks": [],
    }
    if ccfg.projection and pre + "text_projection" in tensors:
        tree["text_proj"] = t("text_projection")
    for i in range(ccfg.layers):
        b = f"transformer.resblocks.{i}."
        in_w, in_b = t(b + "attn.in_proj_weight"), t(b + "attn.in_proj_bias")
        tree["blocks"].append({
            "ln1": {"scale": t(b + "ln_1.weight"), "bias": t(b + "ln_1.bias")},
            **{n: {"w": in_w[j * d:(j + 1) * d].t(),
                   "b": in_b[j * d:(j + 1) * d]}
               for j, n in enumerate("qkv")},
            "out": {"w": t(b + "attn.out_proj.weight").t(),
                    "b": t(b + "attn.out_proj.bias")},
            "ln2": {"scale": t(b + "ln_2.weight"), "bias": t(b + "ln_2.bias")},
            "fc1": {"w": t(b + "mlp.c_fc.weight").t(),
                    "b": t(b + "mlp.c_fc.bias")},
            "fc2": {"w": t(b + "mlp.c_proj.weight").t(),
                    "b": t(b + "mlp.c_proj.bias")},
        })
    return tree


def tree_to_openclip_text(tree, pre: str = OPENCLIP_PREFIX) -> dict:
    """The inverse of ``openclip_text_to_tree`` on a tower's JAX-layout
    tree: OpenCLIP-named {key: tensor} (views; the caller makes them
    contiguous)."""
    out = {
        pre + "token_embedding.weight": tree["token_embedding"],
        pre + "positional_embedding": tree["position_embedding"],
        pre + "ln_final.weight": tree["final_ln"]["scale"],
        pre + "ln_final.bias": tree["final_ln"]["bias"],
    }
    if "text_proj" in tree:
        out[pre + "text_projection"] = tree["text_proj"]
    for i, blk in enumerate(tree["blocks"]):
        b = f"{pre}transformer.resblocks.{i}."
        out[b + "attn.in_proj_weight"] = torch.cat(
            [blk[n]["w"].t() for n in "qkv"], dim=0)
        out[b + "attn.in_proj_bias"] = torch.cat(
            [blk[n]["b"] for n in "qkv"], dim=0)
        out[b + "attn.out_proj.weight"] = blk["out"]["w"].t()
        out[b + "attn.out_proj.bias"] = blk["out"]["b"]
        out[b + "ln_1.weight"] = blk["ln1"]["scale"]
        out[b + "ln_1.bias"] = blk["ln1"]["bias"]
        out[b + "ln_2.weight"] = blk["ln2"]["scale"]
        out[b + "ln_2.bias"] = blk["ln2"]["bias"]
        out[b + "mlp.c_fc.weight"] = blk["fc1"]["w"].t()
        out[b + "mlp.c_fc.bias"] = blk["fc1"]["b"]
        out[b + "mlp.c_proj.weight"] = blk["fc2"]["w"].t()
        out[b + "mlp.c_proj.bias"] = blk["fc2"]["b"]
    return out


# ---------------------------------------------------------------------------
# tensor transforms (views; from_jax_tree and the writer make them dense)
# ---------------------------------------------------------------------------

def _from_ldm(kind: str, name: str, t):
    if kind == "linear" and name == "w":
        return t.t()
    if kind == "conv" and name == "w":
        if t.dim() == 2:  # some checkpoints store 1x1 convs as [O, I]
            t = t[:, :, None, None]
        return t.permute(2, 3, 1, 0)  # OIHW -> HWIO
    return t


def _to_ldm(kind: str, name: str, t):
    if kind == "linear" and name == "w":
        return t.t()
    if kind == "conv" and name == "w":
        return t.permute(3, 2, 0, 1)  # HWIO -> OIHW
    return t


_SUFFIX = {
    "linear": [("weight", "w"), ("bias", "b")],
    "conv": [("weight", "w"), ("bias", "b")],
    "norm": [("weight", "scale"), ("bias", "bias")],
    "embed": [("weight", None)],
}


def _tree_set(tree, path, value):
    node = tree
    for i, k in enumerate(path[:-1]):
        nxt = path[i + 1]
        empty = [] if isinstance(nxt, int) else {}
        if isinstance(k, int):
            while len(node) <= k:
                node.append(None)
            if node[k] is None:
                node[k] = empty
            node = node[k]
        else:
            if k not in node:
                node[k] = empty
            node = node[k]
    node[path[-1]] = value


def _tree_get(tree, path):
    node = tree
    for k in path:
        node = node[k]
    return node


# ---------------------------------------------------------------------------
# families that are not this configuration's base model
# ---------------------------------------------------------------------------

def refuse_families(keys, cfg: PipelineConfig) -> None:
    """Raise ``UnsupportedCheckpoint`` when the LDM ``keys`` are not a base
    model of ``cfg``'s family: a ControlNet (an adapter:
    ``Context.load_controlnet`` takes it), SDXL keys on a single-tower
    configuration, an OpenCLIP tower on a quick-GELU one, SD1.x/2.x text
    keys on SDXL, the refiner's one tower on the base or the base's towers
    on the refiner; before any weight is converted."""
    keys = list(keys)
    if any(k.startswith("control_model.") for k in keys):
        raise UnsupportedCheckpoint(
            "a ControlNet checkpoint (control_model.* keys) is an adapter, "
            "not a base model: load it with Context.load_controlnet(name, "
            "path); SD1.x, SD2.x and SDXL LDM checkpoints and native files "
            "are what model_dir takes")
    if cfg.clip2 is None:
        marks = (("conditioner.embedders.", "an SDXL checkpoint",
                  "config='sdxl' or 'sdxl_refiner'"),)
        if cfg.clip.act == "quick_gelu":
            marks += ((OPENCLIP_PREFIX, "an SD 2.x checkpoint (OpenCLIP "
                       "text tower)", "config='sd21' or 'sd21base'"),)
    else:
        marks = (("cond_stage_model.", "an SD1.x/2.x checkpoint",
                  "config='sd15', 'sd21' or 'sd21base'"),)
        if cfg.refiner:
            marks += ((XL_CLIP2_PREFIX, "an SDXL base checkpoint (two "
                       "towers)", "config='sdxl'"),
                      (XL_CLIP_PREFIX, "an SDXL base checkpoint (two "
                       "towers)", "config='sdxl'"))
        else:
            marks += ((XL_REFINER_CLIP2_PREFIX, "an SDXL refiner checkpoint "
                       "(its one bigG tower)", "config='sdxl_refiner'"),)
    for prefix, what, fits in marks:
        if any(k.startswith(prefix) for k in keys):
            raise UnsupportedCheckpoint(
                f"{what} ({prefix}* keys) does not fit this configuration; "
                f"serve it with {fits}")


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def _layout_rules(tensors, cfg: PipelineConfig):
    """(rules, {tree name: (OpenCLIP prefix, tower config)}) of a
    checkpoint's layout: the refiner reads its one bigG tower by the
    OpenCLIP rules under ``conditioner.embedders.0.model``; SDXL
    (cfg.clip2) reads tower 1 by the HF-CLIP rules under its sgm prefix and
    bigG by the OpenCLIP ones; a single-tower configuration reads an
    OpenCLIP tower where the keys have one (SD 2.x), else the HF-CLIP
    rules (``sdtpu/io/weights.py:523-575``)."""
    if cfg.refiner:
        return (unet_rules(cfg) + vae_rules(cfg),
                {"clip2": (XL_REFINER_CLIP2_PREFIX, cfg.clip2)})
    if cfg.clip2 is not None:
        return (unet_rules(cfg) + vae_rules(cfg)
                + clip_rules(cfg, pre=XL_CLIP_PREFIX),
                {"clip2": (XL_CLIP2_PREFIX, cfg.clip2)})
    if tensors is not None and any(k.startswith(OPENCLIP_PREFIX)
                                   for k in tensors):
        return (all_rules(cfg, include_clip=False),
                {"clip": (OPENCLIP_PREFIX, cfg.clip)})
    return all_rules(cfg), {}


def load_ldm_state_dict(tensors: dict, cfg: PipelineConfig,
                        strict: bool = True, dtype=torch.float32,
                        device=None):
    """LDM-named {key: tensor} (an SD1.x checkpoint with its HF-CLIP text
    tower, SD 2.x with its OpenCLIP one, or SDXL in the sgm naming) -> the
    port's tree. Every leaf goes through float32, as the JAX package loads
    it, then to ``dtype`` (float32 by default), on ``device`` (the host by
    default), one leaf at a time. Keys no rule names (``model_ema.*``,
    ``position_ids``, SD2's 24th text block) are ignored; with ``strict`` a
    missing one raises ``KeyError``."""
    refuse_families(tensors, cfg)
    rules, openclip = _layout_rules(tensors, cfg)
    tree: dict = {}
    missing = []
    for name, (pre, ccfg) in openclip.items():
        try:
            tree[name] = openclip_text_to_tree(tensors, ccfg, pre)
        except KeyError as e:
            missing.append(str(e))
    for rule in rules:
        for ldm_suffix, ours in _SUFFIX[rule.kind]:
            key = f"{rule.ldm}.{ldm_suffix}"
            if key not in tensors:
                # bias-less linears (SD attention q/k/v) simply absent
                if ldm_suffix == "bias":
                    continue
                missing.append(key)
                continue
            t = tensors[key]
            val = _from_ldm(rule.kind, ours, t) if ours else t
            _tree_set(tree, rule.path + ((ours,) if ours else ()), val)
    if strict and missing:
        raise KeyError(
            f"{len(missing)} checkpoint keys missing, first: {missing[:5]}"
        )
    return from_jax_tree(tree, cfg, dtype=dtype or torch.float32,
                         device=device)


def params_to_ldm(params, cfg: PipelineConfig, dtype=torch.float32) -> dict:
    """The port's tree -> LDM-named {key: contiguous tensor} on the host
    (export and round trips), each leaf cast to ``dtype`` (float32, as the JAX
    package's inverse gives; ``None`` keeps each leaf's dtype). A quantized
    site has no ``w`` and gives no weight, as in the JAX package. As there,
    SDXL's towers and the refiner's take the sgm naming (bigG through
    ``tree_to_openclip_text``) and a single tower the HF-CLIP one; an SD
    2.x file in OpenCLIP naming is ``tree_to_openclip_text`` of the
    ``clip`` tree in place of the ``cond_stage_model.transformer`` keys."""
    tree = jax_layout(params)
    rules, openclip = _layout_rules(None, cfg)
    raw = {}
    for name, (pre, _) in openclip.items():
        raw.update(tree_to_openclip_text(tree[name], pre))
    out = {}
    for rule in rules:
        node = _tree_get(tree, rule.path)
        for ldm_suffix, ours in _SUFFIX[rule.kind]:
            if ours is not None and ours not in node:
                continue
            raw[f"{rule.ldm}.{ldm_suffix}"] = _to_ldm(
                rule.kind, ours or "w", node[ours] if ours else node)
    for key, t in raw.items():
        t = t.detach().to("cpu")
        if dtype is not None:
            t = t.to(dtype)
        out[key] = t.contiguous()
    return out


# ---------------------------------------------------------------------------
# native fast-load format: the flattened JAX-layout tree in one file
# ---------------------------------------------------------------------------

NATIVE_SUFFIX = ".sdtpu.safetensors"


def _flatten_tree(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten_tree(v, f"{prefix}{k}/"))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            out.update(_flatten_tree(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten_tree(flat: dict):
    tree: dict = {}
    for key, val in flat.items():
        parts = [int(p) if p.isdigit() else p for p in key.split("/")]
        _tree_set(tree, tuple(parts), val)
    return tree


def save_native(params, path) -> None:
    """Write the port's tree (any dtype, quantized or not) as the JAX
    package's native file: the flattened JAX-layout tree, the same key
    names and dtypes (``sdtpu/io/weights.py:save_native``)."""
    st.save_file(_flatten_tree(jax_layout(params)), path)


def check_native_trees(names, path, cfg: PipelineConfig) -> None:
    """Refuse a native file whose trees (``names``) are not the
    configuration's: an adapter's (a ControlNet's) or another family's."""
    extra = sorted(set(names) - set(PORTED))
    if extra:
        adapters = set(extra) & set(ADAPTER_TREES)
        raise UnsupportedCheckpoint(
            f"native file {path} carries {extra}, trees the port does not "
            f"serve from model_dir" + (" (a ControlNet is loaded with "
                                       "Context.load_controlnet)"
                                       if adapters else "")
            + f"; it loads {list(PORTED)}")
    other = sorted(set(names) - set(tree_names(cfg)))
    if other:
        raise UnsupportedCheckpoint(
            f"native file {path} carries {other}, trees this configuration "
            f"does not have (a dual-tower file is served with "
            f"config='sdxl')")


def load_native(path, cfg: PipelineConfig, dtype=None, device=None,
                mesh=None, plan=None):
    """A native file (written by either package) -> the port's tree, read
    through the file's memory map. Every tree, key and shape is checked
    against the configuration first (quantized sites as ``from_jax_tree``
    takes them), a mismatch refused naming the key. Then one leaf at a
    time: with ``mesh``, this rank's slice of a split leaf
    (``sharding.take`` by ``site_plan`` of the file's tree at the mesh's
    model axis); the leaf converted by ``from_jax_tree``'s rule, cast to
    ``dtype`` (kept when None) and copied to ``device`` (the host when
    None, where an unsplit leaf stays a view of the map). So ``device``
    never holds a whole split leaf or the whole tree, and no collective
    runs. ``plan``: where given, a dict the plan is written into."""
    views = st.load_file(path)
    meta = _unflatten_tree({k: torch.empty(v.shape, dtype=v.dtype,
                                           device="meta")
                            for k, v in views.items()})
    check_native_trees(meta, path, cfg)
    abstract = from_jax_tree(meta, cfg)
    m = 1 if mesh is None else mesh.shape["model"]
    r = 0 if mesh is None else mesh.coords[1]
    sites = site_plan(abstract, m, cfg)
    if plan is not None:
        plan.update(sites)

    def walk(node, at):
        if isinstance(node, dict):
            return {k: walk(v, at + (k,)) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, at + (i,)) for i, v in enumerate(node)]
        t = views["/".join(map(str, at))]
        spec = spec_at(sites, at, node.dim()) if sites else ()
        if spec:
            t = take(t, spec, m, r)
        return _convert(t, at[-1] if isinstance(at[-1], str) else None,
                        dtype, device)

    with torch.no_grad():
        return walk(abstract, ())


def is_orbax_checkpoint(path) -> bool:
    """An orbax checkpoint directory (``sdtpu/io/orbax_ckpt.py``)."""
    p = Path(path)
    return (p / "_CHECKPOINT_METADATA").exists() or (
        p.is_dir() and any(p.glob("**/_CHECKPOINT_METADATA")))


def refuse_orbax(path) -> None:
    """Raise ``UnsupportedCheckpoint`` on an orbax directory: reading one
    needs orbax and tensorstore, which import JAX. Where JAX runs it
    converts to the native file, which the port loads on any mesh."""
    if is_orbax_checkpoint(path):
        raise UnsupportedCheckpoint(
            f"{path} is an orbax checkpoint directory, which the port "
            f"cannot read (orbax needs JAX); convert it on a host with JAX: "
            f"sdtpu.io.orbax_ckpt.load_checkpoint, then "
            f"sdtpu.io.weights.save_native to a *{NATIVE_SUFFIX} file, "
            f"which the port loads on any mesh")


def native_file(model_dir):
    """The native file that ``load_pipeline_params`` loads from
    ``model_dir`` (the file itself, or a directory's first
    ``*.sdtpu.safetensors``), or None where it loads LDM-named files.
    Refuses an orbax directory."""
    model_dir = Path(model_dir)
    refuse_orbax(model_dir)
    if model_dir.is_file():
        return model_dir if model_dir.name.endswith(NATIVE_SUFFIX) else None
    native = sorted(model_dir.glob(f"*{NATIVE_SUFFIX}"))
    return native[0] if native else None


def load_pipeline_params(model_dir, cfg: PipelineConfig, dtype=None,
                         device=None):
    """Load from a directory holding a checkpoint of ``cfg``'s family (SD
    v1.x, v2.x, XL or one of the staged configurations), or from one
    file: the native file (``*.sdtpu.safetensors``, written by
    ``sdtpu_torch.tools.convert_weights``, ``io.checkpoint.save_checkpoint``
    or the JAX package's converter) is preferred, then LDM-named
    ``*.safetensors``. ``dtype``: the compute dtype every floating leaf is
    cast to (an LDM file's through float32). The tokenizer
    (``ctokenizer.txt``) is the Context's."""
    model_dir = Path(model_dir)
    native = native_file(model_dir)
    if native is not None:
        return load_native(native, cfg, dtype, device)
    files = ([model_dir] if model_dir.is_file()
             else sorted(model_dir.glob("*.safetensors")))
    if not files:
        raise FileNotFoundError(f"no .safetensors checkpoint under {model_dir}")
    tensors = {}
    for f in files:
        tensors.update(st.load_file(f))
    return load_ldm_state_dict(tensors, cfg, dtype=dtype, device=device)
