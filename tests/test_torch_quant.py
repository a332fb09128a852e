"""The port's quantized serving modes (``quantize="int8" | "int8w" |
"int8w_dense"``) against the JAX package's: the quantizers, the two int8
GEMMs, the dispatch of ``dense`` and ``conv2d`` on a site's leaf names, the
UNet under each mode, calibration, ``Context``, and the parameter bridge; at
TINY in float32 on the CPU.

On the CPU the port's kernel wrappers run their plain versions. The JAX side
runs its Pallas kernels in interpret mode, as tests/test_ops.py does, and the
comparisons assert that it really reached ``pl.pallas_call``. Inputs are
numpy arrays from a fixed seed; quantized trees are made by the JAX package
and carried over by ``from_jax_tree``, so both sides compute from the same
int8 leaves and scales. Each test states its tolerance.
"""

import collections
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from sdtpu import config as j_config
from sdtpu.engine.context import DEMO_MERGES as J_DEMO_MERGES
from sdtpu.models import layers as j_layers
from sdtpu.models import unet as j_unet
from sdtpu.ops import attention as j_attn
from sdtpu.ops import conv as j_conv
from sdtpu.ops import matmul as j_mm
from sdtpu.quant import ptq as j_ptq
from sdtpu.tokenizer import Tokenizer as JTokenizer
from sdtpu_torch import Context, ErrorCode, SdtpuError
from sdtpu_torch import config as t_config
from sdtpu_torch.io.params import (cast_params, from_jax_tree,
                                   init_pipeline_params, to_jax_tree)
from sdtpu_torch.models import layers as t_layers
from sdtpu_torch.models import unet as t_unet
from sdtpu_torch.ops import conv as t_conv
from sdtpu_torch.ops import matmul as t_mm
from sdtpu_torch.quant import ptq as t_ptq
from sdtpu_torch.quant import validate as t_validate
from sdtpu_torch.tokenizer import DEMO_MERGES, Tokenizer

TINY_J, TINY_T = j_config.TINY, t_config.TINY
PROMPTS = ["a photograph of an astronaut riding a horse", "a red cube"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and eager ops on TINY tensors lose far more to oversubscribed threads
    than they gain from them."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module", autouse=True)
def _no_tf32():
    t_layers.disable_tf32()


@pytest.fixture(scope="module")
def trees():
    """(the JAX package's tree as numpy, the port's tree) for TINY: the
    port's random init in the JAX layout (``to_jax_tree``), carried back by
    ``from_jax_tree``. The JAX package's own init of the same tree takes
    some 40 s on the CPU; ``test_torch_slice.py::
    test_port_init_has_jax_tree_shapes`` holds both inits to one tree."""
    jtree = to_jax_tree(init_pipeline_params(
        TINY_T, torch.Generator().manual_seed(0), "cpu"))
    return jtree, from_jax_tree(jtree, TINY_T)


def _clear_jax_caches():
    j_mm._mm.clear_cache()
    j_mm._mm_w8a8.clear_cache()
    j_conv._fused_conv.clear_cache()
    j_attn._flash_mha.clear_cache()


@pytest.fixture
def pallas(monkeypatch):
    """JAX's Pallas kernels in interpret mode; returns a Counter of the
    Pallas kernel functions that reached ``pl.pallas_call``."""
    reached = collections.Counter()
    real = pl.pallas_call

    def counting(kernel, *args, **kwargs):
        reached[getattr(kernel, "func", kernel).__name__] += 1
        return real(kernel, *args, **kwargs)

    for mod in (j_mm, j_conv, j_attn):
        monkeypatch.setattr(mod, "INTERPRET", True)
    monkeypatch.setattr(pl, "pallas_call", counting)
    _clear_jax_caches()
    yield reached
    _clear_jax_caches()


@pytest.fixture
def calls(monkeypatch):
    """A Counter of the calls of the port's two int8 GEMM wrappers."""
    seen = collections.Counter()
    for name in ("matmul_int8w", "matmul_w8a8"):
        real = getattr(t_mm, name)

        def counting(*a, _real=real, _name=name, **kw):
            seen[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(t_mm, name, counting)
    return seen


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _np(t):
    return t.detach().numpy() if torch.is_tensor(t) else np.asarray(t)


def assert_close(ours, ref, rel):
    ours = _np(ours).astype(np.float32)
    ref = np.asarray(ref, np.float32)
    assert ours.shape == ref.shape
    err = float(np.abs(ours - ref).max())
    tol = rel * float(np.abs(ref).max())
    assert err <= tol, f"max-abs err {err:.3g} > {tol:.3g}"


def _quantized(w):
    """numpy (k, n) weight -> (int8 weight, float32 scale per column)."""
    scale = (np.abs(w).max(axis=0) / 127.0).astype(np.float32)
    return np.clip(np.rint(w / scale), -127, 127).astype(np.int8), scale


def _leaves(node, path=()):
    """(path, leaf) of every leaf of a tree of dicts and lists."""
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(node, list):
        for i, v in enumerate(node):
            yield from _leaves(v, path + (i,))
    else:
        yield path, node


def _same_tree(ours, theirs):
    """The port's tree and the JAX package's hold the same leaves at the
    same paths: int8 leaves equal, floating ones to float32 rounding; conv
    leaves compared in the JAX layout (HWIO)."""
    a, b = dict(_leaves(ours)), dict(_leaves(theirs))
    assert set(a) == set(b)
    for path, leaf in a.items():
        got, want = _np(leaf), np.asarray(b[path])
        if got.ndim == 4:
            got = got.transpose(2, 3, 1, 0)
        assert got.dtype == want.dtype, path
        if got.dtype == np.int8:
            np.testing.assert_array_equal(got, want, err_msg=str(path))
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=0,
                                       err_msg=str(path))


# ---------------------------------------------------------------------------
# quantizers
# ---------------------------------------------------------------------------

def test_quantize_weight_matches_jax():
    """Equal int8 values (both round half to even in float32) and scales to
    float32 rounding; an all-zero column gets scale 1."""
    w = _rand(48, 40, seed=1) * 0.1
    w[:, 3] = 0.0
    w[0, 5] = w[:, 5].max() * 0.5 + 1e-3   # a value near a rounding tie
    jq, js = j_ptq.quantize_weight(jnp.asarray(w))
    tq, ts = t_ptq.quantize_weight(_t(w))
    np.testing.assert_array_equal(_np(tq), np.asarray(jq))
    np.testing.assert_allclose(_np(ts), np.asarray(js), rtol=1e-6, atol=0)
    assert float(ts[3]) == 1.0 and tq.dtype == torch.int8
    assert tq.shape == (48, 40) and tq.t().is_contiguous()


def test_quantize_unet_matches_jax(trees):
    """The same sites chosen (the transformer matmuls of the UNet and
    nothing else), equal int8 leaves, scales to float32 rounding."""
    jtree, ttree = trees
    jq = j_ptq.quantize_unet(jtree)
    tq = t_ptq.quantize_unet(ttree)
    _same_tree(tq, {k: jq[k] for k in tq})
    sites = [p for p, _ in _leaves(tq) if p[-1] == "w_q"]
    assert sites and all(p[0] == "unet" and p[-2] in t_ptq.QUANT_PARENTS
                         for p in sites)
    assert t_ptq.QUANT_PARENTS == j_ptq.QUANT_PARENTS


def test_count_quantized_matches_jax(trees):
    """TINY has 7 transformers of 10 dense sites each."""
    jtree, ttree = trees
    assert t_ptq.count_quantized(ttree) == 0
    n = t_ptq.count_quantized(t_ptq.quantize_unet(ttree))
    assert n == j_ptq.count_quantized(j_ptq.quantize_unet(jtree)) == 70


@pytest.mark.parametrize("include_dense,min_elems,convs,denses", [
    # the default min_elems of 16384 leaves TINY nearly whole: one conv
    # reaches it (the first up block's conv1, 3 x 3 x 64 x 32 = 18432) and
    # no dense does
    (False, None, 1, 0),
    (True, None, 1, 0),
    # 8 ResBlocks x 2 convs + 5 skips, 7 transformers x 2 projections,
    # conv_in, down, up, conv_out
    (False, 0, 39, 0),
    (True, 0, 39, 78),      # + 70 transformer sites + 8 ResBlock emb
])
def test_quantize_weights_only_matches_jax(trees, include_dense, min_elems,
                                           convs, denses):
    """The same sites chosen, equal int8 leaves (the conv ones compared in
    the JAX layout: the port reduces over OIHW's axes 1-3, the JAX package
    over HWIO's 0-2), scales to float32 rounding."""
    jtree, ttree = trees
    kw = {} if min_elems is None else {"min_elems": min_elems}
    jq = j_ptq.quantize_weights_only(jtree["unet"], include_dense, **kw)
    tq = t_ptq.quantize_weights_only(ttree["unet"], include_dense, **kw)
    _same_tree(tq, jq)
    w8 = [leaf for p, leaf in _leaves(tq) if p[-1] == "w8"]
    assert sum(w.dim() == 4 for w in w8) == convs
    assert sum(w.dim() == 2 for w in w8) == denses
    for w in w8:   # the kernels' memory layouts
        assert (w.is_contiguous(memory_format=torch.channels_last)
                if w.dim() == 4 else w.t().is_contiguous())


# ---------------------------------------------------------------------------
# the two GEMMs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,k,n", [(128, 64, 128), (256, 320, 256),
                                   (64, 96, 160)])
def test_matmul_int8w_matches_jax(pallas, m, k, n):
    """The shapes and tolerance of tests/test_ops.py's
    test_matmul_int8w_matches_dequant (both f32, sums in another order):
    atol 1e-3, rtol 1e-4."""
    x = _rand(m, k, seed=2)
    w8, ws = _quantized(_rand(k, n, seed=3) * 0.05)
    b = _rand(n, seed=4)
    ref = j_mm.matmul_int8w(jnp.asarray(x), jnp.asarray(w8), jnp.asarray(ws),
                            jnp.asarray(b))
    assert pallas["_mm_kernel"] == 1
    tw = t_mm.column_major(_t(w8))
    assert t_mm.eligible(_t(x), tw)
    ours = t_mm.matmul_int8w(_t(x), tw, _t(ws), _t(b))
    np.testing.assert_allclose(_np(ours), np.asarray(ref), atol=1e-3,
                               rtol=1e-4)
    # a leading batch axis and no bias
    x3 = x.reshape(2, m // 2, k)
    ref = j_mm.matmul_int8w(jnp.asarray(x3), jnp.asarray(w8), jnp.asarray(ws))
    ours = t_mm.matmul_int8w(_t(x3), tw, _t(ws))
    np.testing.assert_allclose(_np(ours), np.asarray(ref), atol=1e-3,
                               rtol=1e-4)


@pytest.mark.parametrize("m,k,n", [(256, 320, 320), (512, 1280, 640)])
def test_matmul_w8a8_matches_jax(pallas, m, k, n):
    """The shapes and tolerance of tests/test_ops.py's
    test_matmul_w8a8_matches_xla_int8_dot: the int32 sums are exact on both
    sides, the float32 epilogue differs by rounding: rtol 1e-5, atol 1e-3."""
    x = _rand(m, k, seed=5)
    w8, ws = _quantized(_rand(k, n, seed=6) * 0.05)
    b = _rand(n, seed=7)
    xs = np.float32(np.abs(x).max() / 127.0)
    ref = j_mm.matmul_w8a8(jnp.asarray(x), jnp.asarray(w8), jnp.asarray(ws),
                           jnp.float32(xs), jnp.asarray(b))
    assert pallas["_mm_w8a8_kernel"] == 1
    ours = t_mm.matmul_w8a8(_t(x), t_mm.column_major(_t(w8)), _t(ws),
                            torch.tensor(xs), _t(b))
    np.testing.assert_allclose(_np(ours), np.asarray(ref), rtol=1e-5,
                               atol=1e-3)


def test_int8_matmul_is_exact_past_2_24():
    """K = 5120 of +-127 x +-127 sums to 8.3e7 > 2^24: a float32 product
    would round it, the int32 one does not."""
    xq = torch.full((3, 5120), 127, dtype=torch.int8)
    wq = t_mm.column_major(torch.full((5120, 8), -127, dtype=torch.int8))
    y = t_mm.int8_matmul(xq, wq)
    assert y.dtype == torch.int32 and bool((y == -127 * 127 * 5120).all())


@pytest.mark.parametrize("x_shape,w_shape,layout,dtype,want", [
    ((128, 320), (320, 640), "cm", torch.float32, True),
    ((2, 77, 768), (768, 320), "cm", torch.bfloat16, True),   # M = 154
    ((2, 1280), (1280, 320), "cm", torch.float32, True),      # M = 2
    ((5, 48), (48, 7), "cm", torch.float32, True),            # ragged N
    ((128, 328), (328, 640), "cm", torch.float32, False),     # K % 16
    ((128, 320), (320, 640), "rm", torch.float32, False),     # row-major w
    ((128, 320), (320, 640), "f32w", torch.float32, False),   # w not int8
    ((128, 320), (336, 640), "cm", torch.float32, False),     # K mismatch
    ((128, 320), (320, 640), "x_view", torch.float32, False),  # strided x
    ((0, 320), (320, 640), "cm", torch.float32, False),       # empty
])
def test_matmul_eligible_is_the_kernel_contract(x_shape, w_shape, layout,
                                                dtype, want):
    """A static rule on shapes, dtypes and layouts; the reference's gate
    (TPU tiles: no M = 154, no M < 8) is not the port's."""
    x = torch.zeros(x_shape, dtype=dtype)
    if layout == "x_view":
        x = torch.zeros(x_shape[:-1] + (2 * x_shape[-1],))[..., ::2]
    w = torch.zeros(w_shape, dtype=torch.float32 if layout == "f32w"
                    else torch.int8)
    if layout != "rm":
        w = t_mm.column_major(w)
    assert t_mm.eligible(x, w) is want


@pytest.mark.parametrize("m,n,want", [
    (8192, 320, (160, 1)),     # 64x64 level: 128 exact tiles of 128 x 160
    (2048, 640, (128, 1)),     # 32x32: 80 tiles, too many to split
    (2048, 5120, (256, 1)),    # ff1 at 32x32: 320 tiles of 256 columns
    (512, 1280, (128, 3)),     # 16x16: 40 tiles, K in 3 runs: 120 blocks
    (128, 1280, (128, 10)),    # 8x8: 10 tiles, a block a K step
    (154, 320, (160, 10)), (2, 1280, (128, 10))])
def test_matmul_tile_fills_the_card(m, n, want):
    """``plan_w8a8`` on a 132-SM card at K = 1280 (the kernels run on the
    card only; the choice is plain Python): the column tile, and K split
    where the tiles alone would leave half the SMs idle."""
    p = t_mm.plan_w8a8(m, 1280, n, 132)
    assert (p["bn"], p["splits"]) == want
    assert p["blocks"] <= 132 or p["splits"] == 1


@pytest.mark.parametrize("bad", ["cpu", "float32", "row_major", "x_scale"])
def test_cuda_wrappers_reject_without_launching(bad):
    """The wrappers raise before building or launching anything: they take
    CUDA tensors only (a CPU bf16 tensor is refused too)."""
    x = torch.zeros((32, 64), dtype=torch.float32 if bad == "float32"
                    else torch.bfloat16)
    w = torch.zeros((64, 48), dtype=torch.int8)
    if bad != "row_major":
        w = t_mm.column_major(w)
    before = (t_mm.matmul_int8w_cuda.launches, t_mm.matmul_w8a8_cuda.launches)
    with pytest.raises(ValueError):
        t_mm.matmul_int8w_cuda(x, w, torch.ones(48))
    with pytest.raises(ValueError):
        t_mm.matmul_w8a8_cuda(x, w, torch.ones(48),
                              0.5 if bad == "x_scale" else torch.tensor(0.5))
    assert (t_mm.matmul_int8w_cuda.launches,
            t_mm.matmul_w8a8_cuda.launches) == before


# ---------------------------------------------------------------------------
# dispatch of dense and conv2d on the leaf names
# ---------------------------------------------------------------------------

def _site(kind, m=64, k=96, n=128, seed=10):
    """(x, numpy leaf dict) of one dense site of each kind."""
    x = _rand(m, k, seed=seed)
    w = _rand(k, n, seed=seed + 1) * 0.1
    b = _rand(n, seed=seed + 2)
    if kind == "w":
        return x, {"w": w, "b": b}
    wq, ws = _quantized(w)
    if kind == "w8":
        return x, {"w8": wq, "w8_scale": ws, "b": b}
    p = {"w_q": wq, "w_scale": ws, "b": b}
    if kind == "w_q_static":
        p["x_scale"] = np.float32(np.abs(x).max() / 127.0)
    return x, p


def _both(p):
    """numpy leaf dict -> (the JAX one, the port's)."""
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: (t_mm.column_major(_t(v)) if k in ("w8", "w_q") else _t(v))
          for k, v in p.items()}
    return jp, tp


@pytest.mark.parametrize("kind,flag,disable,routed,kernel,atol,rtol", [
    # plain site, f32 on both sides, sums in another order
    ("w", False, False, None, None, 1e-4, 1e-5),
    # K4 on both sides: tests/test_ops.py's tolerance for it
    ("w8", False, False, "matmul_int8w", "_mm_kernel", 1e-3, 1e-4),
    # the dequant fallback on both sides (DISABLE)
    ("w8", False, True, None, None, 1e-3, 1e-4),
    # per-row dynamic scales: exact int32 sums, f32 epilogue
    ("w_q", False, False, None, None, 1e-3, 1e-5),
    # calibrated, flag at its default: the library product, not K5
    ("w_q_static", False, False, None, None, 1e-3, 1e-5),
    # calibrated, flag on, n >= m: K5 on both sides
    ("w_q_static", True, False, "matmul_w8a8", "_mm_w8a8_kernel", 1e-3,
     1e-5),
    # flag on but DISABLE set: no kernel
    ("w_q_static", True, True, None, None, 1e-3, 1e-5),
])
def test_dense_dispatch_matches_jax(monkeypatch, pallas, calls, kind, flag,
                                    disable, routed, kernel, atol, rtol):
    """``layers.dense`` takes the route the JAX package's takes for the
    same leaves and flags, and computes the same values."""
    for mod in (j_mm, t_mm):
        monkeypatch.setattr(mod, "KERNEL_W8A8", flag)
        monkeypatch.setattr(mod, "DISABLE", disable)
    x, p = _site(kind)
    jp, tp = _both(p)
    ref = j_layers.dense(jp, jnp.asarray(x))
    assert sum(pallas.values()) == (1 if kernel else 0)
    if kernel:
        assert pallas[kernel] == 1
    ours = t_layers.dense(tp, _t(x))
    assert dict(calls) == ({routed: 1} if routed else {})
    np.testing.assert_allclose(_np(ours), np.asarray(ref), atol=atol,
                               rtol=rtol)


def test_dense_w8a8_kernel_needs_n_at_least_m(monkeypatch, calls):
    """The reference's rule (``sdtpu/models/layers.py:125-131``): with the
    flag on, only sites whose weights are the larger stream take K5."""
    monkeypatch.setattr(t_mm, "KERNEL_W8A8", True)
    x, p = _site("w_q_static", m=192, k=96, n=128)
    _, tp = _both(p)
    t_layers.dense(tp, _t(x))
    assert not calls
    t_layers.dense(tp, _t(x[:128]))
    assert dict(calls) == {"matmul_w8a8": 1}


def test_dense_int8_reports_absmax_to_a_scoped_recorder():
    """The recorder gets (w_q leaf, absmax) and turns K5 off while it is
    installed; a thread started meanwhile does not see it."""
    import threading

    x, p = _site("w_q")
    _, tp = _both(p)
    got, other = [], []
    prev = t_layers.set_calibration_recorder(lambda w, a: got.append((w, a)))
    try:
        t_layers.dense(tp, _t(x))
        th = threading.Thread(
            target=lambda: other.append(t_layers._CALIB_RECORDER.get()))
        th.start()
        th.join()
    finally:
        t_layers.set_calibration_recorder(prev)
    assert prev is None and other == [None]
    assert len(got) == 1 and got[0][0] is tp["w_q"]
    assert float(got[0][1]) == float(np.abs(x).max())
    t_layers.dense(tp, _t(x))
    assert len(got) == 1


@pytest.mark.parametrize("k,padding,routed", [(1, 0, True), (3, 1, False)])
def test_conv2d_w8_matches_jax(pallas, calls, k, padding, routed):
    """A weight-only-int8 1x1 conv is a matmul over [N*H*W, Cin] and takes
    K4 on both sides; a 3x3 one dequantizes. Both f32: atol 1e-3, rtol
    1e-4, as for K4 itself."""
    x = _rand(2, 8, 8, 32, seed=20)
    w = _rand(k, k, 32, 48, seed=21) * 0.1
    scale = (np.abs(w).max(axis=(0, 1, 2)) / 127.0).astype(np.float32)
    w8 = np.clip(np.rint(w / scale), -127, 127).astype(np.int8)
    b = _rand(48, seed=22)
    ref = j_layers.conv2d({"w8": jnp.asarray(w8),
                           "w8_scale": jnp.asarray(scale),
                           "b": jnp.asarray(b)}, jnp.asarray(x),
                          padding=padding)
    assert pallas["_mm_kernel"] == (1 if routed else 0)
    tp = from_jax_tree_leaf({"w8": w8, "w8_scale": scale, "b": b})
    ours = t_layers.conv2d(tp, _t(x), padding=padding)
    assert dict(calls) == ({"matmul_int8w": 1} if routed else {})
    np.testing.assert_allclose(_np(ours), np.asarray(ref), atol=1e-3,
                               rtol=1e-4)


def from_jax_tree_leaf(p):
    """One conv leaf dict through the bridge's converter."""
    from sdtpu_torch.io.params import _convert

    return _convert(p)


# ---------------------------------------------------------------------------
# the parameter bridge and the cast
# ---------------------------------------------------------------------------

def test_cast_params_keeps_scales_float32():
    tree = {"a": {"w8": torch.zeros((4, 4), dtype=torch.int8),
                  "w8_scale": torch.ones(4), "b": torch.ones(4)},
            "l": [{"w_q": torch.zeros((4, 4), dtype=torch.int8),
                   "w_scale": torch.ones(4), "x_scale": torch.tensor(0.5)}],
            "n": {"scale": torch.ones(4), "bias": torch.zeros(4)}}
    out = cast_params(tree, torch.bfloat16)
    assert out["a"]["w8_scale"].dtype == torch.float32
    assert out["l"][0]["w_scale"].dtype == torch.float32
    assert out["l"][0]["x_scale"].dtype == torch.float32
    assert out["a"]["w8"].dtype == out["l"][0]["w_q"].dtype == torch.int8
    assert out["a"]["b"].dtype == torch.bfloat16
    assert out["n"]["scale"].dtype == torch.bfloat16   # a norm's, not a quant's


def test_from_jax_tree_takes_quantized_trees(trees):
    """4-D ``w8`` goes HWIO -> OIHW like ``w``; 2-D ``w8`` and ``w_q`` stay
    (in, out), in column-major memory; ``x_scale`` comes across; a wrong
    shape is refused."""
    jtree, _ = trees
    jq = dict(jtree)
    jq["unet"] = jax.tree.map(np.asarray, j_ptq.quantize_weights_only(
        jtree["unet"], include_dense=True, min_elems=0))
    tq = from_jax_tree(jq, TINY_T)
    site = jq["unet"]["down"][0]["blocks"][0]["res"]["conv1"]
    ours = tq["unet"]["down"][0]["blocks"][0]["res"]["conv1"]
    assert ours["w8"].dtype == torch.int8
    assert ours["w8"].is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(_np(ours["w8"]),
                                  site["w8"].transpose(3, 2, 0, 1))
    q = tq["unet"]["down"][0]["blocks"][0]["st"]["attn1"]["q"]
    assert q["w8"].shape == (16, 16) and q["w8"].t().is_contiguous()
    assert q["w8_scale"].dtype == torch.float32

    ji = jax.tree.map(np.asarray, j_ptq.quantize_unet(jtree))
    leaf = ji["unet"]["mid"]["st"]["ff1"]
    leaf["x_scale"] = np.float32(0.25)
    ti = from_jax_tree(ji, TINY_T)
    ours = ti["unet"]["mid"]["st"]["ff1"]
    assert float(ours["x_scale"]) == 0.25 and ours["x_scale"].dim() == 0
    assert ours["w_q"].t().is_contiguous()

    leaf["w_scale"] = leaf["w_scale"][:-1]
    with pytest.raises(ValueError, match="w_scale"):
        from_jax_tree(ji, TINY_T)


# ---------------------------------------------------------------------------
# the UNet under each mode, calibration, Context
# ---------------------------------------------------------------------------

def _unet_inputs(size):
    return (_rand(2, size, size, 4, seed=31), _rand(2, 64, seed=32),
            _rand(2, 16, 32, seed=33))


_RANGES = {}


def _static_ranges(unet_tree, inputs):
    """{path of a W8A8 site: the absmax of its activations} in the JAX
    package's UNet on ``inputs`` (its calibration recorder), from one jit at
    XLA's backend optimization level 0 (the same arithmetic; op by op the
    run took some 30 s), made once: both static-scale cases read it."""
    if "unet" not in _RANGES:
        paths = []

        def ranges(tree, *xs):
            site = {}

            def walk(node, path=()):
                if isinstance(node, dict):
                    if "w_q" in node:
                        site[id(node["w_q"])] = path
                    for k, v in node.items():
                        walk(v, path + (k,))
                elif isinstance(node, list):
                    for i, v in enumerate(node):
                        walk(v, path + (i,))

            walk(tree)
            got = {}
            prev = j_layers.set_calibration_recorder(
                lambda w, a: got.__setitem__(site[id(w)], a))
            try:
                j_unet.apply(tree, *xs, TINY_J.unet)
            finally:
                j_layers.set_calibration_recorder(prev)
            paths.extend(got)
            return list(got.values())

        got = jax.jit(ranges, compiler_options={
            "xla_backend_optimization_level": 0})(
            unet_tree, *(jnp.asarray(a) for a in inputs))
        _RANGES["unet"] = {p: np.asarray(v) for p, v in zip(paths, got)}
    return _RANGES["unet"]


def _jax_unet(tree, inputs, kernels):
    """The JAX package's UNet, jitted at XLA's backend optimization level 0
    (the same arithmetic, compiled in a fraction of the time)."""
    return jax.jit(functools.partial(j_unet.apply, cfg=TINY_J.unet,
                                     kernels=kernels), compiler_options={
        "xla_backend_optimization_level": 0})(
        tree, *(jnp.asarray(a) for a in inputs))


@pytest.mark.parametrize("mode,ours,theirs,kernel,rel", [
    # weight-only modes compute in f32 from the same int8 leaves: the
    # tolerance of tests/test_torch_slice.py
    ("int8w", "cuda_conv", "pallas_conv", "_conv_kernel_b", 1e-4),
    ("int8w_dense", "cuda", "pallas", "_mm_kernel", 1e-4),
    # W8A8 rounds activations to int8 at 70 sites in sequence: a
    # float32-rounding difference upstream moves values across rounding
    # boundaries, one quantum (1/127 of the row's or site's range) each.
    # Measured on the port alone: scaling the input by 1 + 1e-7 moves this
    # output by 2e-3 of its max-abs, by 1 + 1e-6 by 9e-3, where the
    # unquantized UNet moves by 1e-6. Site by site the two packages agree
    # to float32 rounding (test_dense_dispatch_matches_jax)
    ("int8", "cuda", "pallas", None, 3e-2),
    ("int8_static", "cuda", "pallas", None, 3e-2),
    ("int8_static_k5", "cuda", "pallas", "_mm_w8a8_kernel", 3e-2),
])
def test_unet_matches_jax_under_quantization(monkeypatch, pallas, calls,
                                             trees, mode, ours, theirs,
                                             kernel, rel):
    """The port's UNet against the JAX package's from the same bridged
    quantized tree (16x16 latents; TINY's weights are under ``min_elems``,
    so the weight-only modes quantize with ``min_elems=0``)."""
    jtree, _ = trees
    inputs = _unet_inputs(16)
    if mode.startswith("int8w"):
        jq = dict(jtree)
        jq["unet"] = j_ptq.quantize_weights_only(
            jtree["unet"], include_dense=mode == "int8w_dense", min_elems=0)
    else:
        jq = j_ptq.quantize_unet(jtree)
        if mode != "int8":
            # a static scale per site: the site's range on these inputs
            ranges = _static_ranges(jq["unet"], inputs)

            def bake(node, path=()):
                if isinstance(node, dict):
                    if "w_q" in node:
                        return {**node, "x_scale": np.float32(
                            ranges[path]) / np.float32(127.0)}
                    return {k: bake(v, path + (k,)) for k, v in node.items()}
                if isinstance(node, list):
                    return [bake(v, path + (i,)) for i, v in enumerate(node)]
                return node

            jq["unet"] = bake(jq["unet"])
    if mode == "int8_static_k5":
        for mod in (j_mm, t_mm):
            monkeypatch.setattr(mod, "KERNEL_W8A8", True)
    jq = jax.tree.map(np.asarray, jq)
    tq = from_jax_tree(jq, TINY_T)
    ref = _jax_unet(jq["unet"], inputs, theirs)
    if kernel:
        assert pallas[kernel] > 0
    assert pallas["_mm_w8a8_kernel"] == (
        pallas[kernel] if mode == "int8_static_k5" else 0)
    out = t_unet.apply(tq["unet"], *(_t(a) for a in inputs), TINY_T.unet,
                       ours)
    assert_close(out, ref, rel=rel)
    if mode == "int8w_dense":
        # every dense and 1x1 conv site: 70 transformer + 8 emb dense, 14
        # proj_in/proj_out + 5 skip convs
        assert dict(calls) == {"matmul_int8w": 97}
    elif mode == "int8w":
        # the 1x1 convs the fused conv kernel does not take: 7 proj_out + 5
        # skip
        assert dict(calls) == {"matmul_int8w": 12}
    elif mode == "int8_static_k5":
        assert calls["matmul_w8a8"] > 0 and calls["matmul_int8w"] == 0
    else:
        assert not calls


def test_unet_int8w_conv_feeds_the_fused_kernel_int8(monkeypatch, trees):
    """Under ``cuda_conv`` every eligible ``w8`` conv site hands
    ``fused_conv`` its int8 weight and scale (8 ResBlocks x 2 + 7 proj_in
    at TINY)."""
    _, ttree = trees
    tq = t_ptq.quantize_weights_only(ttree["unet"], min_elems=0)
    seen = []
    real = t_conv.fused_conv

    def recording(x, w, b, **kw):
        seen.append((w.dtype, kw.get("w_scale") is not None))
        return real(x, w, b, **kw)

    monkeypatch.setattr(t_conv, "fused_conv", recording)
    t_unet.apply(tq, *(_t(a) for a in _unet_inputs(8)), TINY_T.unet,
                 "cuda_conv")
    assert seen == [(torch.int8, True)] * 23


def test_calibrate_matches_jax(trees):
    """The same prompts, steps, guidance mix and injected latents through
    both packages' ``calibrate``: every site gets an ``x_scale``. The
    first transformer's attn1 q/k/v see activations that no quantized site
    has touched: equal to rtol 1e-5 (float32 sums in another order). Every
    later site lies downstream of int8 roundings that a float32-rounding
    difference can flip (see test_unet_matches_jax_under_quantization):
    rtol 2e-2 on a range."""
    jtree, _ = trees
    jq = j_ptq.quantize_unet(jtree)
    tq = from_jax_tree(jax.tree.map(np.asarray, jq), TINY_T)
    steps, seed = 2, 3
    jcal = j_ptq.calibrate(jq, TINY_J, PROMPTS,
                           JTokenizer.from_merges(J_DEMO_MERGES),
                           steps=steps, seed=seed)
    shape = (1, TINY_J.latent_size, TINY_J.latent_size,
             TINY_J.latent_channels)
    noise = [np.array(jax.random.normal(jax.random.PRNGKey(seed + i),
                                        shape)) for i in range(2)]
    tcal = t_ptq.calibrate(tq, TINY_T, PROMPTS,
                           Tokenizer.from_merges(DEMO_MERGES), steps=steps,
                           seed=seed, noise=noise)
    want = {p: v for p, v in _leaves(jcal) if p[-1] == "x_scale"}
    got = {p: v for p, v in _leaves(tcal) if p[-1] == "x_scale"}
    assert len(want) == 70 and set(got) == set(want)
    for p, v in got.items():
        assert v.dtype == torch.float32 and v.dim() == 0
        first = p[:6] == ("unet", "down", 0, "blocks", 0, "st") and (
            p[6] == "attn1" and p[7] in "qkv")
        np.testing.assert_allclose(float(v), float(want[p]),
                                   rtol=1e-5 if first else 2e-2,
                                   err_msg=str(p))
    assert "x_scale" not in tq["unet"]["mid"]["st"]["ff1"]   # a new tree
    assert t_layers._CALIB_RECORDER.get() is None


@pytest.mark.parametrize("mode,kernels,sites", [
    ("int8", "cuda", 70), ("int8w", "cuda_conv", 0),
    ("int8w_dense", "cuda", 0)])
def test_context_generates_under_quantize(mode, kernels, sites):
    ctx = Context(config="tiny", steps=2, kernels=kernels, quantize=mode,
                  device="cpu")
    assert ctx.quantize == mode
    assert t_ptq.count_quantized(ctx.params) == sites
    assert not any(p[0] != "unet" for p, _ in _leaves(ctx.params)
                   if p[-1] in ("w8", "w_q"))
    img = ctx.generate(PROMPTS[0], seed=3)
    assert img.shape == (16, 16, 3) and img.dtype == np.uint8
    assert img.std() > 0
    if mode == "int8":
        ctx.params = t_ptq.calibrate(ctx.params, ctx.cfg, PROMPTS,
                                     ctx.tokenizer, steps=2)
        fp = Context(config="tiny", steps=2, kernels=kernels, device="cpu")
        m = t_validate.validate_quantized(fp, ctx, PROMPTS[:1], seed=3)[0]
        # same random weights, W8A8 against f32: far from garbage
        assert m["psnr_db"] > 30 and m["prompt"] == PROMPTS[0]


def test_context_rejects_a_bad_quantize():
    with pytest.raises(SdtpuError) as ei:
        Context(config="tiny", quantize="int4", device="cpu")
    assert ei.value.code == ErrorCode.INVALID_ARGUMENT
    msg = str(ei.value.args[0] if ei.value.args else ei.value)
    assert "quantize must be none|int8|int8w|int8w_dense, got 'int4'" in msg
    assert Context(config="tiny", device="cpu").quantize == "none"


def test_image_metrics():
    a = np.zeros((4, 4, 3), np.uint8)
    b = a.copy()
    assert t_validate.image_metrics(a, b)["psnr_db"] == float("inf")
    b[0, 0, 0] = 16
    m = t_validate.image_metrics(a, b)
    assert m["max_abs_diff"] == 16.0
    assert m["psnr_db"] == pytest.approx(
        10 * np.log10(255.0 ** 2 / (256 / 48)))
    assert m["identical_fraction"] == pytest.approx(47 / 48)
