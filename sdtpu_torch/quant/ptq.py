"""Post-training int8 quantization (PTQ), the counterpart of
``sdtpu/quant/ptq.py``.

* ``quantize_unet`` (``quantize="int8"``): the transformer matmuls of the
  UNet (attention q/k/v/out, GEGLU ff1/ff2) become W8A8 sites,
  ``{"w_q": int8 (in, out), "w_scale": f32 [out], ("x_scale": f32 []),
  ("b")}``. Activations get a per-row dynamic scale, or after ``calibrate``
  a static per-tensor ``x_scale``.
* ``quantize_weights_only`` (``quantize="int8w"`` / ``"int8w_dense"``):
  conv weights, and with ``include_dense`` matmul weights, are stored int8
  with a per-output-channel scale, ``{"w8": int8, "w8_scale": f32 [out],
  ("b")}``; compute stays in the activation dtype.

``sdtpu_torch.models.layers`` dispatches on the leaf names. Layouts are the
port's: conv weights OIHW in channels_last memory (the output channel is
axis 0), dense weights ``(in, out)``, the int8 ones in column-major memory
(``ops.matmul.column_major``). ``torch.round`` rounds half to even, as
``jnp.round`` does.
"""

from __future__ import annotations

import torch

from sdtpu_torch.ops.matmul import column_major

#: param-dict key sets
QUANT_PARENTS = ("q", "k", "v", "out", "ff1", "ff2", "fc1", "fc2")


def _quantize(w, reduce_dims, scale_shape):
    """Symmetric int8 with one scale per output channel: absmax over
    ``reduce_dims``, scale ``absmax / 127`` (1 where the channel is all
    zero)."""
    w = w.float()
    absmax = w.abs().amax(dim=reduce_dims)
    scale = torch.where(absmax == 0, torch.ones_like(absmax), absmax / 127.0)
    q = torch.clamp(torch.round(w / scale.reshape(scale_shape)), -127, 127)
    return q.to(torch.int8), scale


def quantize_weight(w):
    """Per-output-channel symmetric int8: w (in, out) -> (w_q, scale[out]),
    ``w_q`` in column-major memory."""
    w_q, scale = _quantize(torch.as_tensor(w), 0, (1, -1))
    return column_major(w_q), scale


def _is_dense_leafdict(node) -> bool:
    return isinstance(node, dict) and "w" in node and node["w"].dim() == 2


def quantize_unet(params, include_clip: bool = False):
    """Quantize the transformer matmuls of the UNet (and optionally CLIP).

    Returns a new tree; unquantized leaves are shared, not copied."""
    def walk(node, path):
        if _is_dense_leafdict(node) and path and path[-1] in QUANT_PARENTS:
            in_scope = ("unet" in path) or (include_clip and "clip" in path)
            # only sites inside spatial transformers / clip blocks
            if in_scope and ("st" in path or "attn1" in path or
                             "attn2" in path or "blocks" in path):
                w_q, w_scale = quantize_weight(node["w"])
                out = {"w_q": w_q, "w_scale": w_scale}
                if "b" in node:
                    out["b"] = node["b"]
                return out
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, path + (i,)) for i, v in enumerate(node)]
        return node

    return walk(params, ())


def quantize_weights_only(params, include_dense: bool = False,
                          min_elems: int = 16 * 1024):
    """Weight-only int8: conv sites (4-D ``w``) by default,
    ``include_dense`` extends to matmuls (2-D). Sites with fewer than
    ``min_elems`` weights stay as they are. A quantized site is ``{"w8":
    int8, "w8_scale": f32 [out], ("b")}``; the fused conv kernel and the
    int8 GEMM kernel read the int8 weights and apply the scale to their
    float32 accumulator, every other route dequantizes
    (``layers._weight``)."""
    def quant(node):
        w = node["w"]
        if w.dim() == 4:      # OIHW: the scale runs along axis 0
            w8, scale = _quantize(w, (1, 2, 3), (-1, 1, 1, 1))
        else:                 # (in, out): along the last axis
            w8, scale = quantize_weight(w)
        out = {"w8": w8, "w8_scale": scale}
        if "b" in node:
            out["b"] = node["b"]
        return out

    def walk(node):
        if isinstance(node, dict):
            if "w" in node and node["w"].dim() in (2, 4):
                nd = node["w"].dim()
                big = node["w"].numel() >= min_elems
                if big and (nd == 4 or (nd == 2 and include_dense)):
                    return quant(node)
                return node
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node

    return walk(params)


def count_quantized(params) -> int:
    """The number of W8A8 sites (``w_q``) in the tree."""
    n = 0
    if isinstance(params, dict):
        n += "w_q" in params
        params = list(params.values())
    if isinstance(params, list):
        n += sum(count_quantized(v) for v in params)
    return n


# ---------------------------------------------------------------------------
# static calibration (real prompts, eager capture)
# ---------------------------------------------------------------------------

def _sites(node, path=()):
    """(path, leaf dict) of every W8A8 site in the tree."""
    if isinstance(node, dict):
        if "w_q" in node:
            yield path, node
            return
        for k, v in node.items():
            yield from _sites(v, path + (k,))
    elif isinstance(node, list):
        for i, v in enumerate(node):
            yield from _sites(v, path + (i,))


@torch.inference_mode()
def calibrate(params_q, cfg, prompts, tokenizer, steps: int = 4,
              guidance: float = 7.5, seed: int = 0, noise=None):
    """Attach a static per-tensor activation scale to every W8A8 site.

    Runs the prompts through the guided denoising loop (DPM-Solver++ 2M,
    ``steps`` steps, the CFG pair in one batch-2 eval) with a recorder
    installed in ``layers.dense``: each site reports its activations'
    absmax, the maximum over prompts x steps x both CFG halves is kept, and
    ``x_scale = max(absmax, 1e-8) / 127`` is baked into the site. PyTorch
    runs eagerly, so there is no capture program to trace: the recorder
    maps a site's ``w_q`` tensor to its path in the tree, and every absmax
    stays on the device.

    The tree's device is where ``params_q`` lies. Prompt ``i`` starts from
    float32 normal latents drawn with seed ``seed + i`` (not the JAX
    package's threefry bits), or from ``noise[i]`` ([1, h, w, C]) where
    ``noise`` is given: the seam through which tests hand both packages the
    same latents. Returns a new tree."""
    from sdtpu_torch.engine.pipeline import encode_text
    from sdtpu_torch.models import layers as L
    from sdtpu_torch.models import temb as temb_mod
    from sdtpu_torch.models import unet as unet_mod
    from sdtpu_torch.samplers import dpm
    from sdtpu_torch.samplers.schedule import NoiseSchedule

    sites = list(_sites(params_q))
    if not sites:
        return params_q
    device = sites[0][1]["w_q"].device
    path_of = {id(leaf["w_q"]): path for path, leaf in sites}
    absmax: dict[tuple, torch.Tensor] = {}

    def rec(w_q, value):
        path = path_of[id(w_q)]
        absmax[path] = (torch.maximum(absmax[path], value)
                        if path in absmax else value)

    plan = dpm.plan(NoiseSchedule.sd_v1(), steps, device=device)
    dtype = cfg.compute_dtype
    t_embs = temb_mod.apply(params_q["temb"], plan.model_t, cfg.unet,
                            dtype=dtype)
    shape = (1, cfg.latent_size, cfg.latent_size, cfg.latent_channels)

    def tokens(text):
        return torch.tensor([tokenizer.tokenize(text, cfg.clip.context_len)],
                            dtype=torch.int64, device=device)

    for i, prompt in enumerate(prompts):
        context = torch.cat([encode_text(params_q, tokens(prompt), cfg),
                             encode_text(params_q, tokens(""), cfg)], dim=0)
        if noise is not None:
            x = torch.as_tensor(noise[i], dtype=torch.float32,
                                device=device).reshape(shape)
        else:
            gen = torch.Generator(device=device).manual_seed(seed + i)
            x = torch.randn(shape, generator=gen, device=device,
                            dtype=torch.float32)
        state = dpm.init_state(x)
        for s_i in range(steps):
            te = t_embs[s_i].expand(2, -1)
            x_in = torch.cat([x, x], dim=0).to(dtype)
            prev = L.set_calibration_recorder(rec)
            try:
                eps = unet_mod.apply(params_q["unet"], x_in, te, context,
                                     cfg.unet).float()
            finally:
                L.set_calibration_recorder(prev)
            eps = guidance * eps[:1] + (1.0 - guidance) * eps[1:]
            x, state = dpm.step(plan, s_i, x, eps, state)

    def walk(node, path):
        if isinstance(node, dict):
            if "w_q" in node:
                if path in absmax:
                    node = dict(node)
                    node["x_scale"] = (torch.clamp(absmax[path], min=1e-8)
                                       .float() / 127.0)
                return node
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, path + (i,)) for i, v in enumerate(node)]
        return node

    return walk(params_q, ())
