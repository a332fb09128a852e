"""CLIP-score evaluation harness, the counterpart of
``sdtpu/quant/clip_score.py`` (BASELINE.md quality metric: "CLIP-score
parity with fp32 reference").

score(image, prompt) = 100 * max(0, cos(E_img(image), E_txt(prompt))), the
standard CLIPScore definition. It needs CLIP ViT weights (the image tower
is not part of SD checkpoints): load them with ``vision_params_from_hf``
from an openai/clip-vit-large-patch14 state dict, or use random-init towers
(``models.clip.init_vision``) for harness plumbing tests.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from sdtpu_torch.models import clip

#: CLIP preprocessing constants (openai), copied from the JAX package's
#: ``sdtpu/quant/clip_score.py``
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def preprocess_images(images_uint8, size: int = 224, device="cuda"):
    """uint8 [B,H,W,3] -> CLIP-normalized float32 [B,size,size,3] on
    ``device``. Resized bilinearly with antialiasing, as
    ``jax.image.resize(..., "bilinear")`` does when it shrinks (without
    it a 512 -> 224 resize is 0.52 off the reference's)."""
    x = torch.as_tensor(np.asarray(images_uint8), device=device)
    x = x.to(torch.float32) / 255.0
    if x.shape[1] != size:
        x = F.interpolate(x.permute(0, 3, 1, 2), size=(size, size),
                          mode="bilinear", align_corners=False,
                          antialias=True).permute(0, 2, 3, 1)
    mean = torch.as_tensor(CLIP_MEAN, device=device)
    std = torch.as_tensor(CLIP_STD, device=device)
    return (x - mean) / std


def clip_cosines(
    images_uint8,
    prompts: list[str],
    tokenizer,
    text_params,
    text_proj,
    vision_params,
    text_cfg,
    vision_cfg,
) -> np.ndarray:
    """Per-pair cosine of images[i] and prompts[i] in CLIP's embedding
    space, unclamped, in float32 on the vision tower's device."""
    device = vision_params["patch_embedding"].device
    tokens = torch.tensor(
        [tokenizer.tokenize(p, text_cfg.context_len) for p in prompts],
        dtype=torch.int64, device=device)
    with torch.inference_mode():
        t_emb = clip.text_embedding(text_params, tokens, text_proj,
                                    text_cfg, eot_id=tokenizer.eot)
        i_emb = clip.apply_vision(
            vision_params,
            preprocess_images(images_uint8, vision_cfg.image_size, device),
            vision_cfg)
        t = t_emb / torch.linalg.norm(t_emb, dim=-1, keepdim=True)
        i = i_emb / torch.linalg.norm(i_emb, dim=-1, keepdim=True)
        return (t * i).sum(dim=-1).cpu().numpy()


def clip_scores(
    images_uint8,
    prompts: list[str],
    tokenizer,
    text_params,
    text_proj,
    vision_params,
    text_cfg,
    vision_cfg,
) -> np.ndarray:
    """Per-pair CLIP scores for images[i] vs prompts[i]: 100 times the
    cosine, clamped at 0. The towers run in float32; float32 products on
    the card need TF32 off (``models.layers.disable_tf32``, which
    ``Context`` sets)."""
    cos = clip_cosines(images_uint8, prompts, tokenizer, text_params,
                       text_proj, vision_params, text_cfg, vision_cfg)
    return 100.0 * np.maximum(cos, 0.0)


def vision_params_from_hf(state_dict: dict, cfg, device="cuda"
                          ) -> tuple[dict, torch.Tensor]:
    """Map an HF CLIPModel (openai/clip-vit-*) state dict (numpy arrays or
    tensors) into (vision_params, text_projection) on ``device``, in the
    port's layout: dense weights (in, out), the patch embedding OIHW in
    channels_last memory (HF's own layout). Keys: vision_model.*,
    visual_projection.weight, text_projection.weight."""
    def t(name):
        v = state_dict[name]
        v = v if torch.is_tensor(v) else torch.from_numpy(np.array(v))
        return v.to(device)

    def lin(name):
        return {"w": t(name + ".weight").t().contiguous(),
                "b": t(name + ".bias")}

    def ln(name):
        return {"scale": t(name + ".weight"), "bias": t(name + ".bias")}

    pre = "vision_model."
    params = {
        "class_embedding": t(pre + "embeddings.class_embedding"),
        "patch_embedding": t(pre + "embeddings.patch_embedding.weight"
                             ).contiguous(memory_format=torch.channels_last),
        "position_embedding": t(pre + "embeddings.position_embedding.weight"),
        "ln_pre": ln(pre + "pre_layrnorm"),   # (sic: HF's key name)
        "ln_post": ln(pre + "post_layernorm"),
        "proj": t("visual_projection.weight").t().contiguous(),
        "blocks": [],
    }
    for i in range(cfg.layers):
        b = f"{pre}encoder.layers.{i}."
        params["blocks"].append({
            "ln1": ln(b + "layer_norm1"),
            "q": lin(b + "self_attn.q_proj"),
            "k": lin(b + "self_attn.k_proj"),
            "v": lin(b + "self_attn.v_proj"),
            "out": lin(b + "self_attn.out_proj"),
            "ln2": ln(b + "layer_norm2"),
            "fc1": lin(b + "mlp.fc1"),
            "fc2": lin(b + "mlp.fc2"),
        })
    text_proj = t("text_projection.weight").t().contiguous()
    return params, text_proj
