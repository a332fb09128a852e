"""CLIP text encoder (ViT-L/14 text tower for SD v1.x), the counterpart of
``sdtpu/models/clip.py``: token + learned position embeddings, pre-LN blocks
with causal self-attention and a quick-GELU MLP, final layer norm."""

from __future__ import annotations

import torch

from sdtpu_torch.config import CLIPConfig
from sdtpu_torch.models.layers import (
    causal_sdpa,
    dense,
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


def _encoder_block(blk, x, heads, eps):
    h = layer_norm(blk["ln1"], x, eps)
    a = causal_sdpa(dense(blk["q"], h), dense(blk["k"], h),
                    dense(blk["v"], h), heads)
    x = x + dense(blk["out"], a)
    h = layer_norm(blk["ln2"], x, eps)
    return x + dense(blk["fc2"], quick_gelu(dense(blk["fc1"], h)))


def apply(params, tokens, cfg: CLIPConfig, dtype=torch.float32):
    """tokens: [B, T] integer ids -> [B, T, hidden] (post final LN).

    ``cfg.skip_last`` drops the last blocks and keeps the final LN (A1111's
    "CLIP skip", ``skip_last = clip_skip - 1``)."""
    x = params["token_embedding"][tokens.long()].to(dtype)
    x = x + params["position_embedding"][: tokens.shape[-1]].to(dtype)
    blocks = params["blocks"]
    for blk in blocks[:len(blocks) - cfg.skip_last]:
        x = _encoder_block(blk, x, cfg.heads, cfg.eps)
    return layer_norm(params["final_ln"], x, cfg.eps)
