"""kohya-ss LoRA files, the community adapter format, read and written:
carried over from ``sdtpu/io/kohya.py``.

A kohya file is a flat safetensors file whose keys name torch modules of
the LDM UNet and of the HF CLIP text tower(s):

    lora_unet_<module path, dots -> underscores>.lora_down.weight  [r, in]
    lora_unet_<...>.lora_up.weight                                 [out, r]
    lora_unet_<...>.alpha                                          0-d
    lora_te_text_model_encoder_layers_<i>_<mod>.{lora_down,lora_up,alpha}
    (SDXL: lora_te1_* for CLIP-L, lora_te2_* for OpenCLIP bigG)

A conv site (a transformer's proj_in and proj_out, the ResBlock convs of a
"LoCon" adapter) stores lora_down as a conv kernel [r, in, kh, kw] and
lora_up as a 1x1 conv [out, r, 1, 1].

The underscored names cannot be parsed back (module names hold underscores
themselves), so, as every reader of the format does, the expected names
are generated from the architecture: the rule tables of ``io.weights``
give the map from kohya name to tree path (``site_map``).

A loaded adapter is an overlay in the port's layout (``train.lora``:
``lora_a`` [in, r] or OIHW [r, in, kh, kw], ``lora_b`` [r, out], ``lora_s``
= alpha / r), so it serves through the Context's registry as an ``.npz``
adapter does and composes with the quantized bases.
"""

from __future__ import annotations

import torch

from sdtpu_torch.config import PipelineConfig
from sdtpu_torch.io import safetensors as st
from sdtpu_torch.train.lora import ADAPTER_KEYS

# a kohya entry's suffixes
_DOWN = ".lora_down.weight"
_UP = ".lora_up.weight"
_ALPHA = ".alpha"


def _unet_sites(cfg: PipelineConfig):
    """(kohya name, tree path, kind) of every UNet site an adapter may
    take: the Linear and Conv2d modules of the down, mid and up blocks
    (the time embedding and ``label_emb`` are never adapted)."""
    from sdtpu_torch.io.weights import unet_rules

    pre = "model.diffusion_model."
    for r in unet_rules(cfg):
        if r.path[0] != "unet" or r.kind not in ("linear", "conv"):
            continue
        yield "lora_unet_" + r.ldm[len(pre):].replace(".", "_"), r.path, r.kind


_TE_MODS = {
    "q": "self_attn_q_proj",
    "k": "self_attn_k_proj",
    "v": "self_attn_v_proj",
    "out": "self_attn_out_proj",
    "fc1": "mlp_fc1",
    "fc2": "mlp_fc2",
}


def _te_sites(tower_key: str, ccfg, prefix: str):
    for i in range(ccfg.layers):
        for ours, hf in _TE_MODS.items():
            name = f"{prefix}text_model_encoder_layers_{i}_{hf}"
            yield name, (tower_key, "blocks", i, ours), "linear"


def site_map(cfg: PipelineConfig) -> dict:
    """kohya base name -> (tree path, kind) for this architecture.

    A single-tower configuration names its text tower both ``lora_te_``
    (the SD1.x/2.x convention) and ``lora_te1_`` (tools that always
    number); a dual-tower one ``lora_te1_`` and ``lora_te2_``, with
    ``lora_te_`` an alias of tower 1. The refiner's one tower is
    ``lora_te2_``."""
    m = {}
    for name, path, kind in _unet_sites(cfg):
        m[name] = (path, kind)
    te1 = [] if cfg.refiner else list(_te_sites("clip", cfg.clip, "lora_te_"))
    for name, path, kind in te1:
        m[name] = (path, kind)
        m["lora_te1_" + name[len("lora_te_"):]] = (path, kind)
    if cfg.clip2 is not None:
        for name, path, kind in _te_sites("clip2", cfg.clip2, "lora_te2_"):
            m[name] = (path, kind)
    return m


# ---------------------------------------------------------------------------
# the torch module layout <-> the port's
# ---------------------------------------------------------------------------

def _to_native(kind: str, down, up, alpha) -> dict:
    """One kohya site's tensors (float32) -> its adapter leaves: a Linear's
    ``lora_a`` [in, r] and ``lora_b`` [r, out]; a conv's ``lora_a`` the
    down kernel as it is, OIHW [r, in, kh, kw] in channels_last memory as
    the port keeps conv weights; ``lora_s`` = alpha / r
    (1 without an alpha)."""
    if kind == "linear":
        if down.dim() == 4:   # a Linear site shipped as a 1x1 conv
            down = down.reshape(down.shape[:2])
            up = up.reshape(up.shape[:2])
        rank = down.shape[0]
        a = down.t().contiguous()
        b = up.t().contiguous()
    else:
        if down.dim() == 2:   # a conv site shipped in the Linear layout
            down = down[:, :, None, None]
            up = up[:, :, None, None]
        rank = down.shape[0]
        a = down.contiguous(memory_format=torch.channels_last)
        b = up.reshape(up.shape[0], rank).t().contiguous()
    s = (float(alpha) if alpha is not None else float(rank)) / float(rank)
    return {"lora_a": a, "lora_b": b,
            "lora_s": torch.tensor(s, dtype=torch.float32)}


def _to_kohya(kind: str, site: dict):
    """An adapted site's leaves -> (lora_down, lora_up, alpha), float32 on
    the host."""
    a = site["lora_a"].detach().float().cpu()
    b = site["lora_b"].detach().float().cpu()
    rank = b.shape[0]
    alpha = float(site["lora_s"]) * rank
    if kind == "linear":
        return a.t().contiguous(), b.t().contiguous(), alpha
    if a.dim() == 2:      # an adapter trained on the flattened 1x1 site
        a = a.t()[:, :, None, None]
    return a.contiguous(), b.t().contiguous()[:, :, None, None], alpha


# ---------------------------------------------------------------------------
# the overlay (``train.lora.apply_lora``'s input: nested dicts, lists for
# indexed levels, empty dicts in a list's adapter-free slots)
# ---------------------------------------------------------------------------

def _nest(flat: dict) -> dict:
    root: dict = {}
    for path, site in flat.items():
        node = root
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = dict(site)

    def listify(node):
        if isinstance(node, dict) and not any(k in node for k in ADAPTER_KEYS):
            if node and all(isinstance(k, int) for k in node):
                return [listify(node.get(i, {})) for i in range(max(node) + 1)]
            return {k: listify(v) for k, v in node.items()}
        return node

    return listify(root)


def load_lora_kohya(source, cfg: PipelineConfig, strict: bool = True):
    """A kohya file (or a {key: tensor} dict) -> a whole-pipeline overlay,
    ``{"unet": ..., "clip": ..., "clip2": ...}`` with the towers that have
    adapters, on the host (``Context.load_lora`` applies each with
    ``train.lora.apply_lora``). With ``strict`` a key that names no site of
    this architecture raises the reference's ``ValueError``."""
    tensors = source if isinstance(source, dict) else st.load_file(source)
    groups: dict[str, dict] = {}
    unmatched = []
    for key, t in tensors.items():
        for suffix, slot in ((_DOWN, "down"), (_UP, "up"), (_ALPHA, "alpha")):
            if key.endswith(suffix):
                groups.setdefault(key[: -len(suffix)], {})[slot] = t
                break
        else:
            unmatched.append(key)
    smap = site_map(cfg)
    flat: dict[tuple, dict] = {}
    for name, parts in sorted(groups.items()):
        hit = smap.get(name)
        if hit is None:
            unmatched.append(name)
            continue
        if "down" not in parts or "up" not in parts:
            raise ValueError(f"kohya adapter {name!r} is missing "
                             f"lora_down/lora_up tensors")
        path, kind = hit
        alpha = parts.get("alpha")
        flat[path] = _to_native(
            kind, torch.as_tensor(parts["down"]).float(),
            torch.as_tensor(parts["up"]).float(),
            None if alpha is None else float(alpha))
    if unmatched and strict:
        raise ValueError(
            f"{len(unmatched)} kohya key(s) do not map onto this "
            f"architecture (config mismatch?): {sorted(unmatched)[:8]} ...")
    by_tower: dict[str, dict] = {}
    for path, site in flat.items():
        by_tower.setdefault(path[0], {})[path[1:]] = site
    return {tower: _nest(sites) for tower, sites in by_tower.items()}


def save_lora_kohya(overlay: dict, cfg: PipelineConfig, path,
                    metadata: dict | None = None) -> None:
    """Write an overlay (``load_lora_kohya``'s shape, or a bare UNet
    overlay of ``train.lora.extract_lora``) as a kohya file that A1111,
    ComfyUI and diffusers read."""
    if not set(overlay) <= {"unet", "clip", "clip2"}:
        overlay = {"unet": overlay}

    def sites(node, path=()):
        if isinstance(node, dict):
            if any(k in node for k in ADAPTER_KEYS):
                yield path, node
            else:
                for k, v in node.items():
                    yield from sites(v, path + (k,))
        elif isinstance(node, list):
            for i, v in enumerate(node):
                yield from sites(v, path + (i,))

    # path -> (the kohya name written, kind): tower 1 keeps the unnumbered
    # lora_te_ name unless a second tower exists
    name_of: dict[tuple, tuple] = {}
    for name, (p, kind) in site_map(cfg).items():
        if name.startswith("lora_te1_") and cfg.clip2 is None:
            continue
        if name.startswith("lora_te_") and cfg.clip2 is not None:
            continue
        name_of[p] = (name, kind)
    out = {}
    for tower, sub in overlay.items():
        for rel, site in sites(sub):
            full = (tower,) + rel
            if full not in name_of:
                raise ValueError(f"no kohya name for adapter site {full}")
            name, kind = name_of[full]
            down, up, alpha = _to_kohya(kind, site)
            out[name + _DOWN] = down
            out[name + _UP] = up
            out[name + _ALPHA] = torch.tensor(alpha, dtype=torch.float32)
    st.save_file(out, path, metadata=metadata or {"software": "sdtpu"})
