"""CLIP text encoders, the counterpart of ``sdtpu/models/clip.py``'s text
towers: token + learned position embeddings, pre-LN blocks with causal
self-attention and an MLP (quick-GELU for SD1.x's ViT-L/14, exact GELU for
OpenCLIP's ViT-H and bigG), final layer norm. ``apply`` is the SD1.x/2.x
tap; ``apply_xl`` is SDXL's (penultimate hidden, pooled projection)."""

from __future__ import annotations

import torch

from sdtpu_torch.config import CLIPConfig
from sdtpu_torch.models.layers import (
    causal_sdpa,
    dense,
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


def _encoder_block(blk, x, heads, eps, act):
    h = layer_norm(blk["ln1"], x, eps)
    a = causal_sdpa(dense(blk["q"], h), dense(blk["k"], h),
                    dense(blk["v"], h), heads)
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
