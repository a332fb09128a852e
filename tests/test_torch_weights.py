"""The port's checkpoint layer against the JAX package, at TINY in float32
on the CPU: the LDM rule tables, ``params_to_ldm`` and
``load_ldm_state_dict``, the safetensors reader and writer against the
``safetensors`` package, native files crossing between the packages
(plain, bf16, ``int8w``, ``int8``), ``Context(model_dir=)``, the tokenizer
file, the error codes and the converter.

Weights are the port's own random init at TINY, carried to the JAX
package's layout by ``io.params.to_jax_tree``. Every comparison here is
exact: a load is a permutation and a cast through float32 of the same
numbers.
"""

import shutil

import numpy as np
import pytest
import safetensors.numpy as pkg_np
import safetensors.torch as pkg_st
import torch

from sdtpu import config as j_config
from sdtpu.io import weights as j_weights
from sdtpu_torch import Context, ErrorCode, SdtpuError
from sdtpu_torch import config as t_config
from sdtpu_torch.io import safetensors as t_st
from sdtpu_torch.io import weights as t_weights
from sdtpu_torch.io.params import (cast_params, from_jax_tree,
                                   init_pipeline_params, to_jax_tree)
from sdtpu_torch.quant import ptq as t_ptq
from sdtpu_torch.tokenizer import DEMO_MERGES, Tokenizer, bytes_to_unicode
from sdtpu_torch.tools import convert_weights

TINY_J, TINY_T = j_config.TINY, t_config.TINY
PROMPT = "a photograph of an astronaut riding a horse"
SEED = 5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and eager ops on TINY tensors lose far more to oversubscribed threads
    than they gain from them."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def trees():
    """(the JAX layout as numpy, the port's tree) of the port's TINY init,
    the one a demo ``Context`` builds (seed 0)."""
    ttree = init_pipeline_params(TINY_T, torch.Generator().manual_seed(0),
                                 "cpu")
    return to_jax_tree(ttree), ttree


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def assert_trees_equal(ours, ref):
    """The port's tree ``ours`` against ``ref`` (the port's too): the same
    paths, shapes, dtypes, memory layouts and values."""
    a, b = dict(_leaves(ours)), dict(_leaves(ref))
    assert a.keys() == b.keys()
    for path, t in a.items():
        r = b[path]
        assert t.dtype == r.dtype and t.shape == r.shape, path
        assert [s for s, n in zip(t.stride(), t.shape) if n > 1] == [
            s for s, n in zip(r.stride(), r.shape) if n > 1], path
        assert torch.equal(t, r), path


# ---------------------------------------------------------------------------
# the rule tables and the LDM mapping
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("table", ["unet_rules", "clip_rules", "vae_rules",
                                   "all_rules"])
@pytest.mark.parametrize("name", ["SD15", "TINY"])
def test_rule_tables_match_jax(name, table):
    ours = getattr(t_weights, table)(getattr(t_config, name))
    ref = getattr(j_weights, table)(getattr(j_config, name))
    assert [tuple(r) for r in ours] == [tuple(r) for r in ref]


def test_params_to_ldm_matches_jax(trees):
    """The same keys and float32 arrays, OIHW convs and (out, in) linears;
    every leaf of the tree is named once (the same coverage as the
    reference's)."""
    jtree, ttree = trees
    ours = t_weights.params_to_ldm(ttree, TINY_T)
    ref = j_weights.params_to_ldm(jtree, TINY_J)
    assert ours.keys() == ref.keys()
    for k, v in ref.items():
        assert ours[k].dtype == torch.float32
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)
    assert len(ours) == len(list(_leaves(ttree)))
    w = ours["model.diffusion_model.input_blocks.0.0.weight"]
    assert tuple(w.shape) == (TINY_T.unet.model_channels, 4, 3, 3)


def _ldm_file(tree, cfg, path, dtype, extra=True):
    """An LDM-named checkpoint of ``tree`` in ``dtype``, with the extra keys
    real SD checkpoints carry (an EMA scalar, CLIP's I64 position ids)."""
    sd = {k: v.to(dtype) for k, v in t_weights.params_to_ldm(tree,
                                                             cfg).items()}
    if extra:
        sd["model_ema.decay"] = torch.tensor(0.9999)
        sd["cond_stage_model.transformer.text_model.embeddings."
           "position_ids"] = torch.arange(cfg.clip.context_len)[None]
    pkg_st.save_file(sd, str(path))
    return sd


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
def test_load_ldm_state_dict_matches_jax(trees, tmp_path, dtype):
    """A checkpoint file in F32, F16 and BF16, read by the port's reader:
    the port's load equals ``from_jax_tree`` of the reference's load of the
    same numbers, exactly (dtype, shape, memory layout, value)."""
    _, ttree = trees
    sd = _ldm_file(ttree, TINY_T, tmp_path / "m.safetensors", dtype)
    tensors = t_st.load_file(tmp_path / "m.safetensors")
    assert tensors.keys() == sd.keys()
    ours = t_weights.load_ldm_state_dict(tensors, TINY_T)
    ref = j_weights.load_ldm_state_dict(
        {k: v.float().numpy() for k, v in tensors.items()}, TINY_J)
    assert_trees_equal(ours, from_jax_tree(ref, TINY_T))
    if dtype == torch.float32:
        assert_trees_equal(ours, ttree)
    bf = t_weights.load_ldm_state_dict(tensors, TINY_T, dtype=torch.bfloat16)
    assert bf["unet"]["conv_in"]["w"].dtype == torch.bfloat16


def test_load_ldm_state_dict_refuses_a_missing_key(trees):
    sd = t_weights.params_to_ldm(trees[1], TINY_T)
    key = "model.diffusion_model.out.2.weight"
    del sd[key]
    with pytest.raises(KeyError, match="out.2.weight"):
        t_weights.load_ldm_state_dict(sd, TINY_T)
    # a 1x1 conv stored as [O, I] loads as the 4-D one does
    sd = t_weights.params_to_ldm(trees[1], TINY_T)
    q = "first_stage_model.decoder.mid.attn_1.q.weight"
    full = t_weights.load_ldm_state_dict(sd, TINY_T)
    sd[q] = sd[q][:, :, 0, 0]
    assert_trees_equal(t_weights.load_ldm_state_dict(sd, TINY_T), full)


# ---------------------------------------------------------------------------
# the safetensors reader and writer
# ---------------------------------------------------------------------------

DTYPES = [torch.float32, torch.float16, torch.bfloat16, torch.float64,
          torch.int8, torch.uint8, torch.int32, torch.int64, torch.bool]


def _sample(dtype):
    g = torch.Generator().manual_seed(1)
    if dtype.is_floating_point:
        def make(*s):
            return torch.randn(s, generator=g).to(dtype)
    elif dtype == torch.bool:
        def make(*s):
            return torch.randint(0, 2, s, generator=g).bool()
    else:
        def make(*s):
            lo = 0 if dtype == torch.uint8 else -100
            return torch.randint(lo, 100, s, generator=g).to(dtype)
    return {"b/w": make(3, 5), "a.scalar": make(), "empty": make(0, 4),
            "v": make(7), "odd": make(3)}


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_safetensors_against_the_package(tmp_path, dtype):
    """Each dtype both ways: the package reads the port's file, the port
    reads the package's (with its ``__metadata__``), beside an int8 tensor
    that shifts the offsets; the port's header is padded to 8 bytes."""
    tensors = {**_sample(dtype), "z_int8": torch.arange(5).to(torch.int8)}
    t_st.save_file(tensors, tmp_path / "ours.safetensors")
    pkg_st.save_file(tensors, str(tmp_path / "theirs.safetensors"),
                     metadata={"format": "pt"})
    for f in ("ours", "theirs"):
        path = tmp_path / f"{f}.safetensors"
        for got in (pkg_st.load_file(str(path)), t_st.load_file(path)):
            assert got.keys() == tensors.keys()
            for k, v in tensors.items():
                assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    raw = (tmp_path / "ours.safetensors").read_bytes()
    assert int.from_bytes(raw[:8], "little") % 8 == 0


def test_safetensors_reads_the_numpy_writer_and_refuses_garbage(tmp_path):
    arrays = {"x": np.arange(6, dtype=np.float32).reshape(2, 3),
              "i": np.arange(3, dtype=np.int64)}
    pkg_np.save_file(arrays, str(tmp_path / "n.safetensors"))
    got = t_st.load_file(tmp_path / "n.safetensors")
    for k, v in arrays.items():
        np.testing.assert_array_equal(got[k].numpy(), v)
    (tmp_path / "bad.safetensors").write_bytes(b"\x05")
    with pytest.raises(ValueError, match="too short"):
        t_st.load_file(tmp_path / "bad.safetensors")


# ---------------------------------------------------------------------------
# native files, both ways
# ---------------------------------------------------------------------------

def _quantized(tree, mode):
    """The port's ``tree`` as the converter's --int8w dense / --int8 (one
    site calibrated) would bake it."""
    tree = dict(tree)
    if mode == "int8w":
        tree["unet"] = t_ptq.quantize_weights_only(tree["unet"],
                                                 include_dense=True,
                                                 min_elems=0)
    elif mode == "int8":
        tree = t_ptq.quantize_unet(tree)
        site = tree["unet"]["mid"]["st"]["ff1"]
        tree["unet"]["mid"]["st"]["ff1"] = {**site,
                                            "x_scale": torch.tensor(0.25)}
    return tree


@pytest.mark.parametrize("mode", ["plain", "bf16", "int8w", "int8"])
def test_port_native_file_loads_in_jax(trees, tmp_path, mode):
    """The port's native file read by the JAX package: its tree in the
    JAX layout, the same key names, dtypes and values; and back into the
    port, the same tree."""
    _, ttree = trees
    tree = _quantized(ttree, mode)
    if mode == "bf16":
        tree = cast_params(tree, torch.bfloat16)
    path = tmp_path / f"model{t_weights.NATIVE_SUFFIX}"
    t_weights.save_native(tree, path)
    got = dict(_leaves(j_weights.load_native(path)))
    want = dict(_leaves(to_jax_tree(cast_params(tree, torch.float32))))
    assert got.keys() == want.keys()
    for p, a in got.items():
        a = np.asarray(a)
        if mode == "bf16" and a.dtype.kind == "f" or a.dtype.kind == "V":
            assert str(a.dtype) == "bfloat16", p
            a = a.astype(np.float32)
        assert a.dtype == want[p].dtype and a.shape == want[p].shape, p
        np.testing.assert_array_equal(a, want[p], err_msg=str(p))
    assert_trees_equal(t_weights.load_native(path, TINY_T), tree)


@pytest.mark.parametrize("mode", ["plain", "int8w", "int8"])
def test_jax_native_file_loads_in_the_port(trees, tmp_path, mode):
    """A native file written by the JAX package (of a tree quantized as its
    converter would: the port's quantizers, held to the JAX package's in
    ``test_torch_quant.py``, in the JAX layout) loads in the port as
    ``from_jax_tree`` of that tree."""
    jq = to_jax_tree(_quantized(trees[1], mode))
    path = tmp_path / f"m{t_weights.NATIVE_SUFFIX}"
    j_weights.save_native(jq, path)
    assert_trees_equal(t_weights.load_native(path, TINY_T),
                       from_jax_tree(jq, TINY_T))


# ---------------------------------------------------------------------------
# Context(model_dir=) and the converter: port only, steps=2
# ---------------------------------------------------------------------------

def _context(model_dir=None, **kw):
    return Context(model_dir=None if model_dir is None else str(model_dir),
                   config="tiny", steps=2, device="cpu", **kw)


@pytest.fixture(scope="module")
def demo():
    """The demo Context and its image at ``SEED``."""
    c = _context()
    return c, c.generate(PROMPT, seed=SEED)


@pytest.fixture(scope="module")
def files(demo, tmp_path_factory):
    """The demo weights as an LDM file (float32), as a native file (bf16
    would change the image at TINY's float32), and beside the native file
    an LDM file of other weights that the native one must win over."""
    root = tmp_path_factory.mktemp("models")
    c, _ = demo
    (root / "ldm").mkdir()
    _ldm_file(c.params, TINY_T, root / "ldm" / "sd.safetensors",
              torch.float32)
    (root / "both").mkdir()
    t_weights.save_native(c.params, root / "both" /
                          f"model{t_weights.NATIVE_SUFFIX}")
    other = init_pipeline_params(TINY_T, torch.Generator().manual_seed(9),
                                 "cpu")
    _ldm_file(other, TINY_T, root / "both" / "other.safetensors",
              torch.float32)
    return root


@pytest.mark.parametrize("where", [
    "ldm", "both", "ldm/sd.safetensors",
    f"both/model{t_weights.NATIVE_SUFFIX}"])
def test_context_model_dir_gives_the_demo_bytes(demo, files, where):
    """A directory of an LDM file, a directory where the native file wins
    over an LDM file of other weights, and each file named alone: the
    demo Context's image, byte for byte."""
    c = _context(files / where)
    assert c.model_dir is not None and c.embedding_names() == []
    assert np.array_equal(c.generate(PROMPT, seed=SEED), demo[1])


def _flat_tokenizer(path, merges):
    """A ``ctokenizer.txt``: the 512 base entries, then one merge a line."""
    base = list(bytes_to_unicode().values())
    lines = base + [b + "</w>" for b in base] + [f"{a} {b}" for a, b in
                                                 merges]
    path.write_text("\n".join(lines) + "\n", encoding="utf-8")


@pytest.mark.parametrize("merges,code", [
    (DEMO_MERGES[:10], None),
    (DEMO_MERGES + [("x", "y"), ("y", "z")], ErrorCode.INVALID_ARGUMENT)])
def test_context_takes_the_tokenizer_file(files, tmp_path, merges, code):
    """``model_dir/ctokenizer.txt`` replaces the demo tokenizer; a
    vocabulary larger than the model's is refused."""
    shutil.copy(files / "ldm" / "sd.safetensors", tmp_path)
    _flat_tokenizer(tmp_path / "ctokenizer.txt", merges)
    if code is not None:
        with pytest.raises(SdtpuError) as ei:
            _context(tmp_path)
        assert ei.value.code == code and "vocab" in str(ei.value)
        return
    c = _context(tmp_path)
    want = Tokenizer.from_flat_file(tmp_path / "ctokenizer.txt")
    assert c.tokenizer.vocab_size == 512 + 10 + 2
    assert c.tokenizer.encode(PROMPT) == want.encode(PROMPT)
    assert c.tokenizer.encode(PROMPT) != Tokenizer.from_merges(
        DEMO_MERGES).encode(PROMPT)


def _write_case(case, root, files):
    """A model_dir that fails the way ``case`` names."""
    d = root / case
    d.mkdir()
    if case == "missing":
        d.rmdir()
    elif case == "missing_key":
        sd = t_st.load_file(files / "ldm" / "sd.safetensors")
        del sd["model.diffusion_model.out.2.weight"]
        t_st.save_file(sd, d / "sd.safetensors")
    elif case == "openclip":
        t_st.save_file({"cond_stage_model.model.ln_final.weight":
                        torch.ones(4)}, d / "sd2.safetensors")
    elif case == "sdxl":
        t_st.save_file({"conditioner.embedders.0.transformer.x":
                        torch.ones(4)}, d / "xl.safetensors")
    elif case == "native_family":
        t_st.save_file({"clip2/final_ln/scale": torch.ones(4)},
                       d / f"model{t_weights.NATIVE_SUFFIX}")
    elif case == "orbax":
        (d / "_CHECKPOINT_METADATA").write_text("{}")
    return d


@pytest.mark.parametrize("case,code,text", [
    ("missing", ErrorCode.RUNTIME_ERROR, "model load failed"),
    ("empty", ErrorCode.RUNTIME_ERROR, "no .safetensors checkpoint"),
    ("missing_key", ErrorCode.RUNTIME_ERROR, "checkpoint keys missing"),
    ("openclip", ErrorCode.INVALID_ARGUMENT, "SD 2.x"),
    ("sdxl", ErrorCode.INVALID_ARGUMENT, "SDXL"),
    ("native_family", ErrorCode.INVALID_ARGUMENT, "clip2"),
    ("orbax", ErrorCode.INVALID_ARGUMENT, "orbax")])
def test_context_model_dir_error_codes(files, tmp_path, case, code, text):
    """The reference's codes: a missing or empty directory or a broken
    checkpoint is ``RUNTIME_ERROR`` "model load failed: ..."; a family the
    port does not load yet is ``INVALID_ARGUMENT``, refused before any
    weight is converted. Nothing falls back to demo weights."""
    d = _write_case(case, tmp_path, files)
    with pytest.raises(SdtpuError) as ei:
        _context(d)
    assert ei.value.code == code and text in str(ei.value)
    if code == ErrorCode.RUNTIME_ERROR:
        assert "model load failed" in str(ei.value)


@pytest.mark.parametrize("src,extra,kw", [
    ("sd.safetensors", [], {}),
    ("sd.ckpt", [], {}),
    ("sd.safetensors", ["--int8w", "conv"],
     {"quantize": "int8w", "kernels": "cuda_conv"})])
def test_converter_ldm_to_native_to_context(demo, files, tmp_path, src,
                                            extra, kw):
    """``sdtpu_torch.tools.convert_weights`` from an LDM safetensors or a
    torch ``.ckpt`` (``state_dict`` inside) to a native file, then a
    Context on it: the bytes of the demo Context (with ``--int8w conv``,
    those of the demo Context under ``quantize="int8w"``); the tokenizer
    is copied alongside; a second run without --force keeps the file."""
    ldm = files / "ldm" / "sd.safetensors"
    if src.endswith(".ckpt"):
        torch.save({"state_dict": t_st.load_file(ldm), "epoch": 1},
                   tmp_path / src)
    else:
        shutil.copy(ldm, tmp_path / src)
    _flat_tokenizer(tmp_path / "tok.txt", DEMO_MERGES)
    out = tmp_path / "out"
    argv = [str(tmp_path / src), str(out), "--config", "tiny", "--dtype",
            "float32", "--tokenizer", str(tmp_path / "tok.txt"), *extra]
    assert convert_weights.main(argv) == 0
    native = out / f"model{t_weights.NATIVE_SUFFIX}"
    assert (out / "ctokenizer.txt").exists()
    mtime = native.stat().st_mtime_ns
    assert convert_weights.main(argv) == 0
    assert native.stat().st_mtime_ns == mtime
    want = demo[1] if not kw else _context(**kw).generate(PROMPT, seed=SEED)
    c = _context(out, kernels=kw.get("kernels", "plain"))
    assert np.array_equal(c.generate(PROMPT, seed=SEED), want)
    if extra:
        assert any(p[-1] == "w8" and t.dtype == torch.int8
                   for p, t in _leaves(c.params["unet"]))
