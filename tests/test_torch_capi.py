"""The port's C API (``sdtpu_torch/capi``, bound by
``sdtpu_torch.io.native``) on the CPU: the library is built here with
``g++`` and loaded into this process, whose interpreter the engine
functions then embed; ``SDTPU_TORCH_DEVICE=cpu`` puts their Context on the
host. The cases of the JAX package's ``tests/test_native.py`` against the
port: the header's declarations are the reference's, the tokenizer's ids
and the DPM solver against the port's Python, the error surface and the
handle checks, the E2E app, the threaded stress app under ThreadSanitizer,
and ``sdtpu_setup`` + each engine entry (generate, LoRA, depth2img, edit
with a textual-inversion word, the quality knobs, upscale) against the
port's ``Context`` on the same demo weights: the same bytes. The embedded
context's seed starts at 0 and goes up by one a call."""

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from sdtpu_torch import Context
from sdtpu_torch.io import native
from sdtpu_torch.samplers import dpm
from sdtpu_torch.samplers.schedule import NoiseSchedule
from sdtpu_torch.tokenizer import DEMO_MERGES, Tokenizer, bytes_to_unicode

pytestmark = pytest.mark.skipif(
    shutil.which("g++") is None or shutil.which("gcc") is None,
    reason="no native toolchain")

REPO = native.PKG_DIR.parent
c_void_p, c_char_p = ctypes.c_void_p, ctypes.c_char_p
u8p = ctypes.POINTER(ctypes.c_uint8)
SIGS = {
    "sdtpu_setup": [ctypes.POINTER(c_void_p), c_char_p, c_char_p,
                    ctypes.c_int32, ctypes.c_int32, ctypes.c_int32],
    "sdtpu_set_steps": [c_void_p, ctypes.c_int32],
    "sdtpu_set_pag_scale": [c_void_p, ctypes.c_float],
    "sdtpu_set_deepcache": [c_void_p, ctypes.c_int32],
    "sdtpu_set_tome_ratio": [c_void_p, ctypes.c_float],
    "sdtpu_generate_image": [c_void_p, c_char_p, ctypes.c_float,
                             ctypes.POINTER(c_void_p),
                             ctypes.POINTER(ctypes.c_size_t)],
    "sdtpu_load_lora": [c_void_p, c_char_p, c_char_p],
    "sdtpu_generate_image_lora": [c_void_p, c_char_p, ctypes.c_float,
                                  c_char_p, ctypes.POINTER(c_void_p),
                                  ctypes.POINTER(ctypes.c_size_t)],
    "sdtpu_depth2img_image": [c_void_p, c_char_p, ctypes.c_float,
                              ctypes.c_float, u8p, ctypes.c_size_t,
                              ctypes.POINTER(ctypes.c_float),
                              ctypes.c_size_t, ctypes.POINTER(c_void_p),
                              ctypes.POINTER(ctypes.c_size_t)],
    "sdtpu_edit_image": [c_void_p, c_char_p, ctypes.c_float, ctypes.c_float,
                         u8p, ctypes.c_size_t, ctypes.POINTER(c_void_p),
                         ctypes.POINTER(ctypes.c_size_t)],
    "sdtpu_upscale_image": [c_void_p, c_char_p, ctypes.c_float,
                            ctypes.c_int, u8p, ctypes.c_size_t,
                            ctypes.POINTER(c_void_p),
                            ctypes.POINTER(ctypes.c_size_t)],
    "sdtpu_load_embedding": [c_void_p, c_char_p, c_char_p],
    "sdtpu_release": [c_void_p],
    "sdtpu_ref_context": [c_void_p],
    "sdtpu_free_buffer": [c_void_p],
}


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
def lib():
    lib = native.load_library()
    for name, args in SIGS.items():
        getattr(lib, name).argtypes = args
    return lib


@pytest.fixture()
def on_cpu(monkeypatch):
    monkeypatch.setenv(native.DEVICE_VAR, "cpu")


@pytest.fixture(scope="module")
def flat_file(tmp_path_factory):
    base = list(bytes_to_unicode().values())
    lines = (base + [c + "</w>" for c in base]
             + [f"{a} {b}" for a, b in DEMO_MERGES])
    p = tmp_path_factory.mktemp("tok") / "ctokenizer.txt"
    p.write_text("\n".join(lines) + "\n", encoding="utf-8")
    return p


def _setup(lib, config, steps, use_kernels=0):
    handle = c_void_p()
    rc = lib.sdtpu_setup(ctypes.byref(handle), None, config, steps, 0,
                         use_kernels)
    assert rc == 0, lib.sdtpu_get_last_error_extra_info(rc, None)
    return handle


def _fetch(lib, buf, n, shape):
    out = np.ctypeslib.as_array(ctypes.cast(buf, u8p),
                                (n.value,)).copy().reshape(shape)
    lib.sdtpu_free_buffer(buf)
    return out


def _generate(lib, handle, prompt, size, guidance=7.5, lora=None,
              expect=0):
    buf, n = c_void_p(), ctypes.c_size_t()
    if lora is None:
        rc = lib.sdtpu_generate_image(handle, prompt, guidance,
                                      ctypes.byref(buf), ctypes.byref(n))
    else:
        rc = lib.sdtpu_generate_image_lora(handle, prompt, guidance, lora,
                                           ctypes.byref(buf),
                                           ctypes.byref(n))
    if expect != 0:
        assert rc != 0
        return None
    assert rc == 0, lib.sdtpu_get_last_error_extra_info(rc, handle)
    return _fetch(lib, buf, n, (size, size, 3))


def _declarations(path):
    """The header without its comments, whitespace collapsed."""
    text = path.read_text()
    text = re.sub(r"/\*.*?\*/", " ", text, flags=re.S)
    text = re.sub(r"//[^\n]*", " ", text)
    return " ".join(text.split())


def test_header_declarations_are_the_references():
    ours = _declarations(native.CAPI_DIR / "include" / "sdtpu.h")
    ref = _declarations(REPO / "csrc" / "libsdtpu" / "include" / "sdtpu.h")
    assert ours == ref and "sdtpu_generate_image" in ours


def test_sources_are_the_references_but_sdtpu_setup():
    """Every copied file is the reference's after its first line, but
    ``capi.cpp``'s ``sdtpu_setup`` (the import, the kernels, the
    device)."""
    ref_dir = REPO / "csrc"
    pairs = [(p, ref_dir / "libsdtpu" / "src" / p.name)
             for p in sorted((native.CAPI_DIR / "src").iterdir())]
    pairs += [(p, ref_dir / "test" / p.name)
              for p in sorted((native.CAPI_DIR / "test").iterdir())]
    assert len(pairs) == 14
    for ours, ref in pairs:
        body = ours.read_text().split("\n", 1)[1]
        if ours.name != "capi.cpp":
            assert body == ref.read_text(), ours.name
            continue
        cut = (lambda s: re.sub(r"int sdtpu_setup\(.*?\n}\n", "", s,
                                flags=re.S))
        assert cut(body) == cut(ref.read_text())
        assert 'PyImport_ImportModule("sdtpu_torch")' in body
        assert native.DEVICE_VAR in body


def test_native_tokenizer_matches_python(lib, flat_file):
    prompts = ["a photograph of an astronaut riding a horse",
               "The   QUICK brownfox ...", "it's 123 things, isn't it?",
               "résumé café née", "emoji 🚀🚀 test", "日本語のテキスト",
               "a&amp;b &#65; &#x42;", "!!'s (.'s --'ll #'t ''s", ""]
    py = Tokenizer.from_flat_file(flat_file)
    nat = native.NativeTokenizer(flat_file)
    assert nat.vocab_size == py.vocab_size
    for p in prompts:
        assert nat.tokenize(p) == py.tokenize(p), p
    long = "horse " * 200
    assert nat.tokenize(long, 77) == py.tokenize(long, 77)
    assert nat.tokenize("the horse", 16) == py.tokenize("the horse", 16)


def test_native_dpm_matches_python(lib):
    steps = 20
    plan = dpm.plan(NoiseSchedule.sd_v1(), steps, device="cpu")
    nat = native.NativeDpm()
    nat.prepare(steps)
    np.testing.assert_allclose(nat.model_ts(), plan.model_t.numpy(),
                               atol=1e-3)
    rng = np.random.default_rng(0)
    x_py = rng.standard_normal(64).astype(np.float32)
    x_nat = x_py.copy()
    st = dpm.init_state(torch.from_numpy(x_py))
    for i in range(steps):
        eps = rng.standard_normal(64).astype(np.float32)
        x_t, st = dpm.step(plan, i, torch.from_numpy(x_py),
                           torch.from_numpy(eps), st)
        x_py = x_t.numpy()
        x_nat = nat.update(i, x_nat, eps)
        np.testing.assert_allclose(x_nat, x_py, atol=2e-4,
                                   err_msg=f"step {i}")


def test_native_error_surface(lib):
    with pytest.raises(RuntimeError, match="invalid argument"):
        native.NativeTokenizer("/nonexistent/vocab.txt")
    nat = native.NativeDpm()
    with pytest.raises(RuntimeError, match="runtime error"):
        nat.update(0, np.zeros(4, np.float32), np.zeros(4, np.float32))


def test_capi_refcount_semantics(lib, on_cpu):
    """A garbage handle is INVALID_CONTEXT, never a crash; a referenced
    handle survives one release and dies at the second."""
    assert lib.sdtpu_set_steps(c_void_p(0), 20) == 4
    handle = _setup(lib, b"tiny", 2)
    assert lib.sdtpu_ref_context(handle) == 0
    assert lib.sdtpu_release(handle) == 0
    assert lib.sdtpu_set_steps(handle, 3) == 0
    assert lib.sdtpu_release(handle) == 0


def test_setup_generate_is_the_contexts_bytes(lib, on_cpu):
    """``sdtpu_setup("tiny", 2)`` + ``sdtpu_generate_image``: the port's
    ``Context.generate`` bytes for seed 0, then seed 1."""
    py = Context(config="tiny", steps=2, device="cpu")
    size = py.cfg.image_size
    handle = _setup(lib, b"tiny", 2)
    try:
        got = _generate(lib, handle, b"the horse", size)
        assert np.array_equal(got, py.generate("the horse", seed=0))
        got = _generate(lib, handle, b"the horse", size, guidance=5.0)
        assert np.array_equal(got, py.generate("the horse", guidance=5.0,
                                               seed=1))
    finally:
        lib.sdtpu_release(handle)


def test_setup_takes_the_card_unless_told(lib, monkeypatch):
    """With the device variable unset the embedded Context asks for the
    card: without one, ``sdtpu_setup`` is RUNTIME_ERROR (nothing falls
    back to the CPU); the setting is read at each setup."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.delenv(native.DEVICE_VAR, raising=False)
    handle = c_void_p()
    rc = lib.sdtpu_setup(ctypes.byref(handle), None, b"tiny", 2, 0, 1)
    assert rc == 3 and not handle.value
    monkeypatch.setenv(native.DEVICE_VAR, "cpu")
    lib.sdtpu_release(_setup(lib, b"tiny", 2, use_kernels=1))


def test_simple_app_e2e_engine(lib, tmp_path):
    """The E2E app drives the embedded engine through the C ABI: setup ->
    generate -> img2img of its own output -> raw .bin files; the first is
    the port's Context bytes (4 steps, seed 0, the plain path)."""
    app = native.build_app("simple_app")
    env = {**os.environ, native.DEVICE_VAR: "cpu",
           "PYTHONPATH": f"{REPO}:{os.environ.get('PYTHONPATH', '')}",
           "OMP_NUM_THREADS": "1"}
    run = subprocess.run([str(app), "the horse", "tiny"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env=env)
    assert run.returncode == 0, run.stderr[-2000:]
    a = np.fromfile(tmp_path / "output.bin", np.uint8)
    b = np.fromfile(tmp_path / "output2.bin", np.uint8)
    assert a.size == 16 * 16 * 3 and b.size == a.size
    assert not np.array_equal(a, b)
    py = Context(config="tiny", steps=4, device="cpu")
    assert np.array_equal(a.reshape(16, 16, 3), py.generate("the horse",
                                                            seed=0))


def test_threaded_capi_under_tsan(flat_file):
    """8 threads share one tokenizer and the mutex-guarded error table, and
    churn DPM solvers of their own, under -fsanitize=thread: the app checks
    every thread's ids against single-threaded ones, TSan aborts on a
    race."""
    try:
        app = native.build_app("test_threads", sanitize="thread")
    except RuntimeError as e:
        pytest.skip(f"tsan build failed: {str(e)[-300:]}")
    run = subprocess.run([str(app), str(flat_file), "8", "100"],
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "TSAN_OPTIONS": "halt_on_error=1"})
    assert run.returncode == 0, run.stderr[-2000:] + run.stdout[-500:]


def _lora_npz(ctx, path, seed):
    from sdtpu_torch.io.kohya import load_lora_kohya, site_map
    from sdtpu_torch.train.lora import save_lora_npz

    g = torch.Generator().manual_seed(seed)
    flat = {}
    for name, (tree_path, kind) in sorted(site_map(ctx.cfg).items()):
        if kind != "linear" or not name.startswith("lora_unet") or \
                "_attn" not in name:
            continue
        node = ctx.params
        for k in tree_path:
            node = node[k]
        d_in, d_out = node["w"].shape
        flat[name + ".lora_down.weight"] = torch.randn((2, d_in), generator=g)
        flat[name + ".lora_up.weight"] = 0.3 * torch.randn((d_out, 2),
                                                           generator=g)
        flat[name + ".alpha"] = torch.tensor(2.0)
    save_lora_npz(load_lora_kohya(flat, ctx.cfg)["unet"], path)


def test_capi_lora_routing(lib, on_cpu, tmp_path):
    py = Context(config="tiny", steps=2, device="cpu")
    npz = tmp_path / "style.npz"
    _lora_npz(py, npz, 3)
    py.load_lora("style", str(npz))
    size = py.cfg.image_size
    handle = _setup(lib, b"tiny", 2)
    try:
        assert lib.sdtpu_load_lora(handle, b"style", str(npz).encode()) == 0
        got_lora = _generate(lib, handle, b"the horse", size, lora=b"style")
        assert np.array_equal(got_lora,
                              py.generate("the horse", seed=0, lora="style"))
        got_base = _generate(lib, handle, b"the horse", size, lora=b"")
        assert np.array_equal(got_base, py.generate("the horse", seed=1))
        assert not np.array_equal(got_lora, got_base)
        _generate(lib, handle, b"the horse", size, lora=b"nope", expect=1)
    finally:
        lib.sdtpu_release(handle)


def test_capi_concat_models_and_embedding(lib, on_cpu, tmp_path):
    """``sdtpu_depth2img_image`` (5-ch), ``sdtpu_edit_image`` (8-ch ip2p)
    and ``sdtpu_load_embedding``, each the Context's bytes; a wrong depth
    count is a clean error."""
    py5 = Context(config="tiny_depth", steps=2, device="cpu")
    size = py5.cfg.image_size
    image = np.random.default_rng(0).integers(
        0, 256, (size, size, 3)).astype(np.uint8)
    depth = np.linspace(0, 500, size * size, dtype=np.float32).reshape(
        size, size)
    want = py5.depth2img("the horse", image, depth, strength=0.5, seed=0)
    img_c, dep_c = np.ascontiguousarray(image), np.ascontiguousarray(depth)
    fp = ctypes.POINTER(ctypes.c_float)
    handle = _setup(lib, b"tiny_depth", 2)
    try:
        buf, n = c_void_p(), ctypes.c_size_t()
        for count, rc_want in ((dep_c.size, 0), (dep_c.size - 1, None)):
            rc = lib.sdtpu_depth2img_image(
                handle, b"the horse", 7.5, 0.5, img_c.ctypes.data_as(u8p),
                img_c.size, dep_c.ctypes.data_as(fp), count,
                ctypes.byref(buf), ctypes.byref(n))
            if rc_want == 0:
                assert rc == 0
                assert np.array_equal(_fetch(lib, buf, n, (size, size, 3)),
                                      want)
            else:
                assert rc != 0
    finally:
        lib.sdtpu_release(handle)

    py8 = Context(config="tiny_ip2p", steps=2, device="cpu")
    ids = py8.tokenizer.encode("horse")
    vecs = py8.params["clip"]["token_embedding"][ids].float().numpy()
    npz = tmp_path / "h.npz"
    np.savez(npz, emb=vecs)
    want = py8.instruct_pix2pix("a horse photo", image, guidance=6.0,
                                image_guidance=1.4, seed=0)
    handle = _setup(lib, b"tiny_ip2p", 2)
    try:
        assert lib.sdtpu_load_embedding(handle, b"<h>",
                                        str(npz).encode()) == 0
        buf, n = c_void_p(), ctypes.c_size_t()
        rc = lib.sdtpu_edit_image(handle, b"a <h> photo", 6.0, 1.4,
                                  img_c.ctypes.data_as(u8p), img_c.size,
                                  ctypes.byref(buf), ctypes.byref(n))
        assert rc == 0
        assert np.array_equal(_fetch(lib, buf, n, (size, size, 3)), want)
    finally:
        lib.sdtpu_release(handle)


def test_capi_quality_knobs(lib, on_cpu):
    """PAG, DeepCache and ToMe through their setters, each the Context's
    bytes; invalid values are clean errors and the context stays live."""
    py = Context(config="tiny", steps=3, device="cpu")
    want_pag = py.generate("the horse", seed=0, pag_scale=3.0)
    py_dc = Context(config="tiny", steps=3, deepcache=2, device="cpu")
    want_dc = py_dc.generate("the horse", seed=1)
    size = py.cfg.image_size
    handle = _setup(lib, b"tiny", 3)
    try:
        assert lib.sdtpu_set_pag_scale(handle, 3.0) == 0
        assert np.array_equal(_generate(lib, handle, b"the horse", size),
                              want_pag)
        assert lib.sdtpu_set_pag_scale(handle, 0.0) == 0
        assert lib.sdtpu_set_deepcache(handle, 2) == 0
        assert np.array_equal(_generate(lib, handle, b"the horse", size),
                              want_dc)
        assert lib.sdtpu_set_deepcache(handle, 1) != 0
        assert lib.sdtpu_set_deepcache(handle, 0) == 0
        assert lib.sdtpu_set_tome_ratio(handle, 0.9) != 0
        assert lib.sdtpu_set_tome_ratio(handle, 0.5) == 0
        # TINY's levels sit under ToMe's 4,096-token gate: the base bytes
        assert np.array_equal(_generate(lib, handle, b"the horse", size),
                              py.generate("the horse", seed=2))
    finally:
        lib.sdtpu_release(handle)


def test_capi_upscale(lib, on_cpu):
    """``sdtpu_upscale_image`` takes the low-res input at the latent grid:
    the Context's bytes; a full-size input or a level out of range is a
    clean error."""
    py = Context(config="tiny_x4", steps=2, device="cpu")
    ls, size = py.cfg.latent_size, py.cfg.image_size
    low = np.random.default_rng(3).integers(0, 256, (ls, ls, 3)).astype(
        np.uint8)
    want = py.upscale("a castle", low, noise_level=5, guidance=9.0, seed=0)
    handle = _setup(lib, b"tiny_x4", 2)
    try:
        buf, n = c_void_p(), ctypes.c_size_t()
        low_c = np.ascontiguousarray(low)
        rc = lib.sdtpu_upscale_image(handle, b"a castle", 9.0, 5,
                                     low_c.ctypes.data_as(u8p), low_c.size,
                                     ctypes.byref(buf), ctypes.byref(n))
        assert rc == 0
        assert np.array_equal(_fetch(lib, buf, n, (size, size, 3)), want)
        big = np.zeros((size, size, 3), np.uint8)
        for arr, level in ((big, 5), (low_c, 999)):
            rc = lib.sdtpu_upscale_image(handle, b"x", 9.0, level,
                                         arr.ctypes.data_as(u8p), arr.size,
                                         ctypes.byref(buf), ctypes.byref(n))
            assert rc != 0
    finally:
        lib.sdtpu_release(handle)
