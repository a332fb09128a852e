"""Token merging for the UNet's self-attention (ToMe-SD, Bolya & Hoffman
2023), the counterpart of ``sdtpu/ops/tome.py``.

Before attn1 of a transformer block whose plane has at least
``tome_min_tokens`` tokens, the ``ratio`` most redundant tokens merge into
their most similar neighbour, and the attention's output is unmerged after
its out projection, so the quadratic term shrinks by (1 - ratio)^2.

Everything but the selection is static: the dst/src partition is a numpy
index table (one dst, the top-left token, per 2x2 region), the merge count
is ``r = min(int(N * ratio), N_src)``. Selection: cosine similarity of the
block input in float32, each src token's best dst (``argmax``, the first of
equals), then a stable descending sort of those scores (``jnp.argsort`` is
stable); the first ``r`` merge. Aggregation is a scatter-mean in float32
by ``index_put_`` with ``accumulate``, which adds in index order on every
device (CUDA's ``index_add_`` adds atomically, in no fixed order, and the
same seed must give the same bytes); unmerge is a gather and a scatter.
Plain PyTorch on every device: the reference leaves ToMe to XLA, so it is
no kernel of the port.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=64)
def plan(hh: int, ww: int, sx: int = 2, sy: int = 2):
    """The dst/src partition of an hh x ww grid: dst = the top-left token of
    each sy x sx region, src = every other token. Returns (dst_idx [Nd],
    src_idx [Ns]), numpy int32."""
    ii, jj = np.meshgrid(np.arange(hh), np.arange(ww), indexing="ij")
    is_dst = ((ii % sy) == 0) & ((jj % sx) == 0)
    flat = (ii * ww + jj).ravel()
    dst = flat[is_dst.ravel()].astype(np.int32)
    src = flat[~is_dst.ravel()].astype(np.int32)
    return dst, src


def _rows(t, idx):
    """t [B, N, C] gathered at per-sample token indices idx [B, K]."""
    return torch.gather(t, 1, idx[..., None].expand(-1, -1, t.shape[-1]))


def build(metric, hh: int, ww: int, ratio: float, sx: int = 2, sy: int = 2):
    """The merge of one transformer block. metric: [B, N, C], the block's
    input tokens (N = hh * ww). Returns (merge, unmerge, r): merge maps [B,
    N, C] -> [B, N - r, C] (the kept src tokens, then the dst tokens),
    unmerge maps [B, N - r, C] -> [B, N, C]."""
    b, n, _ = metric.shape
    if n != hh * ww:
        raise ValueError(f"metric has {n} tokens, grid is {hh}x{ww}")
    dst_np, src_np = plan(hh, ww, sx, sy)
    nd, ns = dst_np.size, src_np.size
    r = min(int(n * ratio), ns)
    if r <= 0:
        return (lambda t: t), (lambda t: t), 0
    dev = metric.device
    dst_idx = torch.as_tensor(dst_np, dtype=torch.int64, device=dev)
    src_idx = torch.as_tensor(src_np, dtype=torch.int64, device=dev)

    m = metric.float()
    m = m / torch.clamp(torch.linalg.vector_norm(m, dim=-1, keepdim=True),
                        min=1e-6)
    scores = torch.einsum("bsc,bdc->bsd", m[:, src_idx], m[:, dst_idx])
    node_max = scores.amax(dim=-1)                       # [B, Ns]
    node_idx = scores.argmax(dim=-1)                     # [B, Ns] dst bin
    order = torch.argsort(-node_max, dim=-1, stable=True)  # most similar 1st
    merged, kept = order[:, :r], order[:, r:]            # [B, r], [B, Ns-r]
    tgt = torch.gather(node_idx, 1, merged)              # [B, r]
    # the dst bins of every sample in one flat [B * Nd] index
    flat_tgt = (tgt + torch.arange(b, device=dev)[:, None] * nd).reshape(-1)

    def merge(tokens):
        c = tokens.shape[-1]
        src = tokens[:, src_idx]
        dst = tokens[:, dst_idx].float()
        add = torch.zeros((b * nd, c), dtype=torch.float32, device=dev)
        add.index_put_((flat_tgt,), _rows(src, merged).float().reshape(-1, c),
                       accumulate=True)
        cnt = torch.zeros((b * nd,), dtype=torch.float32, device=dev)
        cnt.index_put_((flat_tgt,), torch.ones_like(flat_tgt,
                                                    dtype=torch.float32),
                       accumulate=True)
        dst = ((dst + add.reshape(b, nd, c))
               / (1.0 + cnt.reshape(b, nd))[..., None]).to(tokens.dtype)
        return torch.cat([_rows(src, kept), dst], dim=1)  # [B, Ns-r+Nd, C]

    def unmerge(y):
        c = y.shape[-1]
        kept_y, dst_y = y[:, : ns - r], y[:, ns - r:]
        out = torch.zeros((y.shape[0], n, c), dtype=y.dtype, device=y.device)
        out[:, dst_idx] = dst_y
        for pos, vals in ((src_idx[kept], kept_y),
                          (src_idx[merged], _rows(dst_y, tgt))):
            out.scatter_(1, pos[..., None].expand(-1, -1, c), vals)
        return out

    return merge, unmerge, r
