"""CLIP text encoders, the counterpart of ``sdtpu/models/clip.py``'s text
towers: token + learned position embeddings, pre-LN blocks with causal
self-attention and an MLP (quick-GELU for SD1.x's ViT-L/14, exact GELU for
OpenCLIP's ViT-H and bigG), final layer norm. ``apply`` is the SD1.x/2.x
tap; ``apply_xl`` is SDXL's (penultimate hidden, pooled projection).

Below them, the CLIP vision tower and the projections into the shared
embedding space (``apply_vision``, ``text_embedding``), which only the
CLIP-score harness (``sdtpu_torch.quant.clip_score``) reads."""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from sdtpu_torch.config import CLIPConfig
from sdtpu_torch.models.layers import (
    causal_sdpa,
    dense,
    sdpa,
    gelu,
    init_dense,
    init_norm,
    layer_norm,
    quick_gelu,
)


def init(cfg: CLIPConfig, generator, device):
    d = cfg.hidden

    def normal(shape, std):
        return torch.randn(shape, generator=generator, device=device) * std

    params = {
        "token_embedding": normal((cfg.vocab_size, d), 0.02),
        "position_embedding": normal((cfg.context_len, d), 0.01),
        "final_ln": init_norm(d, device),
        "blocks": [],
    }
    if cfg.projection:
        # OpenCLIP's pooled projection, [d, proj], used as x @ W
        params["text_proj"] = normal((d, cfg.projection), d ** -0.5)
    for _ in range(cfg.layers):
        params["blocks"].append({
            "ln1": init_norm(d, device),
            "q": init_dense(d, d, generator, device),
            "k": init_dense(d, d, generator, device),
            "v": init_dense(d, d, generator, device),
            "out": init_dense(d, d, generator, device),
            "ln2": init_norm(d, device),
            "fc1": init_dense(d, d * cfg.mlp_ratio, generator, device),
            "fc2": init_dense(d * cfg.mlp_ratio, d, generator, device),
        })
    return params


def _encoder_block(blk, x, heads, eps, act, causal=True):
    """A pre-LN block; ``causal`` masks the self-attention (the text
    towers), else every token sees every other (the vision tower, the plain
    ``sdpa`` as the reference's takes no kernel)."""
    h = layer_norm(blk["ln1"], x, eps)
    q, k, v = dense(blk["q"], h), dense(blk["k"], h), dense(blk["v"], h)
    a = (causal_sdpa(q, k, v, heads) if causal
         else sdpa(q, k, v, heads, kernel="plain"))
    x = x + dense(blk["out"], a)
    h = layer_norm(blk["ln2"], x, eps)
    return x + dense(blk["fc2"], act(dense(blk["fc1"], h)))


def _act(cfg: CLIPConfig):
    return quick_gelu if cfg.act == "quick_gelu" else gelu


def _embed(params, tokens, dtype):
    x = params["token_embedding"][tokens.long()].to(dtype)
    return x + params["position_embedding"][: tokens.shape[-1]].to(dtype)


def apply(params, tokens, cfg: CLIPConfig, dtype=torch.float32):
    """tokens: [B, T] integer ids -> [B, T, hidden] (post final LN).

    ``cfg.skip_last`` (A1111's "CLIP skip", ``clip_skip - 1``) or
    ``cfg.penultimate`` (one block) drops the last blocks and keeps the
    final LN (``sdtpu/models/clip.py:72-93``)."""
    act = _act(cfg)
    x = _embed(params, tokens, dtype)
    blocks = params["blocks"]
    n_skip = cfg.skip_last or (1 if cfg.penultimate else 0)
    for blk in blocks[:len(blocks) - n_skip]:
        x = _encoder_block(blk, x, cfg.heads, cfg.eps, act)
    return layer_norm(params["final_ln"], x, cfg.eps)


def apply_xl(params, tokens, cfg: CLIPConfig, eot_id: int,
             dtype=torch.float32):
    """SDXL's tap of a tower: ``(hidden, pooled)``.

    ``hidden`` is the penultimate block's output without the final LN.
    ``pooled`` runs the last block and the final LN, takes the hidden state
    at the first ``eot_id`` of each row and multiplies it by ``text_proj``
    (``x @ W``, float32 accumulation); None when the tower has no
    projection (``sdtpu/models/clip.py:96-124``)."""
    act = _act(cfg)
    x = _embed(params, tokens, dtype)
    for blk in params["blocks"][:-1]:
        x = _encoder_block(blk, x, cfg.heads, cfg.eps, act)
    hidden = x
    if "text_proj" not in params:
        return hidden, None
    x = _encoder_block(params["blocks"][-1], x, cfg.heads, cfg.eps, act)
    x = layer_norm(params["final_ln"], x, cfg.eps)
    eot = torch.argmax((tokens == eot_id).to(torch.int32), dim=-1)
    pooled = x[torch.arange(x.shape[0], device=x.device), eot]
    pooled = (pooled.float() @ params["text_proj"].to(pooled.dtype).float())
    return hidden, pooled.to(dtype)


# ---------------------------------------------------------------------------
# vision tower + projections (the CLIP-score harness; the text towers above
# are the only parts the SD pipeline itself needs), the counterpart of
# ``sdtpu/models/clip.py:128-224``
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch: int = 14
    hidden: int = 1024
    layers: int = 24
    heads: int = 16
    mlp_ratio: int = 4
    projection: int = 768    # shared text/image embedding dim (ViT-L/14)
    eps: float = 1e-5

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch) ** 2


VIT_L14 = CLIPVisionConfig()
TINY_VISION = CLIPVisionConfig(image_size=16, patch=8, hidden=32, layers=2,
                               heads=2, projection=16)


def init_vision(cfg: CLIPVisionConfig, generator, device):
    """Random vision-tower parameters with the reference's init scales:
    the patch embedding is an OIHW [hidden, 3, patch, patch] weight in
    channels_last memory, without bias."""
    d = cfg.hidden

    def normal(shape, std):
        return torch.randn(shape, generator=generator, device=device) * std

    params = {
        "class_embedding": normal((d,), 0.02),
        "patch_embedding": normal((d, 3, cfg.patch, cfg.patch), 0.02
                                  ).contiguous(
            memory_format=torch.channels_last),
        "position_embedding": normal((cfg.n_patches + 1, d), 0.01),
        "ln_pre": init_norm(d, device),
        "ln_post": init_norm(d, device),
        "proj": normal((d, cfg.projection), 0.02),
        "blocks": [],
    }
    for _ in range(cfg.layers):
        params["blocks"].append({
            "ln1": init_norm(d, device),
            "q": init_dense(d, d, generator, device),
            "k": init_dense(d, d, generator, device),
            "v": init_dense(d, d, generator, device),
            "out": init_dense(d, d, generator, device),
            "ln2": init_norm(d, device),
            "fc1": init_dense(d, d * cfg.mlp_ratio, generator, device),
            "fc2": init_dense(d * cfg.mlp_ratio, d, generator, device),
        })
    return params


def _project(x, w, dtype):
    """``x @ w`` with ``w`` rounded to ``x``'s dtype and float32
    accumulation (``jnp.dot(..., preferred_element_type=float32)``)."""
    return (x.float() @ w.to(x.dtype).float()).to(dtype)


def apply_vision(params, images, cfg: CLIPVisionConfig, dtype=torch.float32):
    """images: [B, H, W, 3] float (CLIP-normalized) -> [B, projection].

    The patch embedding is a stride-``patch`` conv without bias on the
    NCHW ``channels_last`` view of the images, run in float32 on the
    ``dtype`` values (exact widening: the reference's float32
    accumulation), then rounded to ``dtype``."""
    b = images.shape[0]
    x = images.to(dtype).permute(0, 3, 1, 2).float()
    w = params["patch_embedding"].to(dtype).float()
    patches = F.conv2d(x, w, stride=cfg.patch).to(dtype)
    x = patches.permute(0, 2, 3, 1).reshape(b, -1, cfg.hidden)
    cls = params["class_embedding"].to(dtype)[None, None].expand(
        b, 1, cfg.hidden)
    x = torch.cat([cls, x], dim=1)
    x = x + params["position_embedding"].to(dtype)[None]
    x = layer_norm(params["ln_pre"], x, cfg.eps)
    for blk in params["blocks"]:
        x = _encoder_block(blk, x, cfg.heads, cfg.eps, quick_gelu,
                           causal=False)
    pooled = layer_norm(params["ln_post"], x[:, 0], cfg.eps)
    return _project(pooled, params["proj"], dtype)


def text_embedding(params, tokens, text_proj, cfg: CLIPConfig,
                   eot_id: int, dtype=torch.float32):
    """Pooled + projected text embedding (CLIP contrastive space): the
    hidden state at the FIRST eot position, projected."""
    hidden = apply(params, tokens, cfg, dtype)
    eot = torch.argmax((tokens == eot_id).to(torch.int32), dim=-1)
    pooled = hidden[torch.arange(hidden.shape[0], device=hidden.device), eot]
    return _project(pooled, text_proj, dtype)
