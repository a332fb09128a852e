"""The port's command line (``sdtpu_torch.cli``) in-process on the CPU
(``--platform cpu``): the JAX package's ``tests/test_cli.py`` serving
cases (info, generate to PNG and to raw ``.bin`` with ``show``, the
img2img and inpaint flags, a bad sampler), each ported subcommand's option
set against the reference parser's, read from both ``--help`` outputs,
``SAMPLER_CHOICES`` against the port's registry, the measurement
subcommands (``bench``, ``profile``, ``sweep``, ``analyze``) at TINY
(``train``: ``tests/test_torch_train.py`` runs it), ``info``'s version,
``serve``'s Context and ``warmup`` with its artifact's member check."""

import io
import json
import re
import tarfile

import numpy as np
import pytest
import torch
from PIL import Image

from sdtpu import cli as j_cli
from sdtpu_torch import Context, ErrorCode, SdtpuError
from sdtpu_torch import cli as t_cli
from sdtpu_torch.engine import server as t_server
from sdtpu_torch.ops import _build
from sdtpu_torch.samplers import SAMPLERS

main = t_cli.main
TINY = ["--config", "tiny", "--steps", "2", "--platform", "cpu"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and eager ops on TINY tensors lose far more to oversubscribed threads
    than they gain from them."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture()
def init_png(tmp_path):
    row = np.linspace(0, 255, 16, dtype=np.uint8)
    img = np.ascontiguousarray(
        np.broadcast_to(row[None, :, None], (16, 16, 3)))
    p = tmp_path / "init.png"
    Image.fromarray(img).save(p)
    return p


def test_info_runs(capsys):
    assert main(["info"]) == 0
    out = capsys.readouterr().out
    assert "sdtpu_torch" in out and "config sd15" in out
    if not torch.cuda.is_available():
        assert "backend: cpu" in out


def test_generate_png_and_bin_roundtrip(tmp_path):
    """The PNG decodes to ``Context.generate``'s bytes for the same seed;
    the raw ``.bin`` holds the same bytes, and ``show`` renders it."""
    png = tmp_path / "out.png"
    args = ["generate", *TINY, "--seed", "3", "--prompt", "the horse"]
    assert main(args + ["--out", str(png)]) == 0
    a = np.asarray(Image.open(png))
    assert a.shape == (16, 16, 3) and a.dtype == np.uint8
    ctx = Context(config="tiny", steps=2, device="cpu")
    assert np.array_equal(a, ctx.generate("the horse", seed=3))

    bin_path = tmp_path / "out.bin"
    assert main(args + ["--out", str(bin_path)]) == 0
    raw = np.fromfile(bin_path, np.uint8).reshape(16, 16, 3)
    assert np.array_equal(raw, a)
    assert main(["show", str(bin_path)]) == 0
    assert np.array_equal(np.asarray(Image.open(tmp_path / "out.png")), raw)


def test_generate_img2img_and_inpaint_flags(tmp_path, init_png):
    out = tmp_path / "i.png"
    base = ["generate", *TINY, "--seed", "1", "--init-image", str(init_png),
            "--out", str(out)]
    assert main(base + ["--strength", "0.5"]) == 0
    got = np.asarray(Image.open(out))
    ctx = Context(config="tiny", steps=2, device="cpu")
    init = np.asarray(Image.open(init_png).convert("RGB"))
    prompt = t_cli.DEFAULT_PROMPT
    assert np.array_equal(got, ctx.img2img(prompt, init, strength=0.5,
                                           seed=1))

    mask = np.zeros((16, 16), np.uint8)
    mask[:, 8:] = 255
    mask_path = init_png.parent / "mask.png"
    Image.fromarray(mask, "L").save(mask_path)
    assert main(base + ["--mask-image", str(mask_path)]) == 0
    assert np.array_equal(np.asarray(Image.open(out)),
                          ctx.inpaint(prompt, init, mask, seed=1))


def test_bad_sampler_rejected():
    with pytest.raises(SystemExit):
        main(["generate", "--config", "tiny", "--sampler", "nope"])


def test_default_platform_is_the_card():
    """``--platform auto`` asks for the card: without one the Context's
    typed RUNTIME_ERROR comes out, nothing falls back to the CPU."""
    if torch.cuda.is_available():
        assert t_cli._device("auto") == "cuda"
        return
    with pytest.raises(SdtpuError) as ei:
        main(["generate", "--config", "tiny", "--steps", "2"])
    assert ei.value.code == ErrorCode.RUNTIME_ERROR


def _options(main_fn, cmd, capsys):
    """The long options of ``cmd``'s ``--help``."""
    with pytest.raises(SystemExit):
        main_fn([cmd, "--help"])
    return set(re.findall(r"(?<![\w-])(--[a-z][a-z0-9-]*)",
                          capsys.readouterr().out))


@pytest.mark.parametrize("cmd", ["generate", "show", "serve", "warmup",
                                 "info", "train", "bench", "profile",
                                 "sweep", "analyze"])
def test_option_set_is_the_references(cmd, capsys):
    assert _options(main, cmd, capsys) == _options(j_cli.main, cmd, capsys)


def test_subcommands_are_the_references(capsys):
    def subs(main_fn):
        with pytest.raises(SystemExit):
            main_fn(["--help"])
        text = capsys.readouterr().out
        return set(re.search(r"\{([a-z,]+)\}", text).group(1).split(","))

    assert subs(main) == subs(j_cli.main)


def test_sampler_choices_are_the_registry():
    assert t_cli.SAMPLER_CHOICES == sorted(SAMPLERS)
    assert t_cli.SAMPLER_CHOICES == j_cli.SAMPLER_CHOICES


@pytest.mark.parametrize("cmd", ["bench", "profile", "sweep", "analyze"])
def test_measurement_subcommands_run(cmd, tmp_path, capsys):
    """``bench``, ``profile``, ``sweep`` and ``analyze`` at TINY on the CPU,
    each returning 0 with its output: the part table, the kernels by time
    and class, one JSON line a config, the table over ``bench``'s files."""
    results = tmp_path / "results"
    runs = {
        "bench": ["bench", "--config", "tiny", "--platform", "cpu",
                  "--warmup", "1", "--iters", "2", "--parts", "unet,temb",
                  "--results", str(results), "--phases", "--steps", "2"],
        "profile": ["profile", "--config", "tiny", "--platform", "cpu",
                    "--part", "vae_decoder", "--top", "4", "--trace-dir",
                    str(tmp_path / "trace")],
        "sweep": ["sweep", "--config", "tiny", "--platform", "cpu",
                  "--quick", "--steps-list", "2", "--iters", "1"],
        "analyze": ["analyze", "--results", str(results)],
    }
    if cmd == "analyze":
        assert main(runs["bench"]) == 0
        capsys.readouterr()
    assert main(runs[cmd]) == 0
    out = capsys.readouterr().out
    if cmd in ("bench", "analyze"):
        assert re.search(r"^unet\s+\d", out, re.M)
        assert re.search(r"^temb\s+\d", out, re.M)
        assert "pipeline estimate (20-step)" in out
        assert sorted(p.name for p in results.iterdir()) == [
            "temb.json", "unet.json"]
    if cmd == "bench":
        assert "benchmarked: ['temb', 'unet']" in out
        assert re.search(r"^  per_step\s+[\d.]+ ms$", out, re.M)
    elif cmd == "profile":
        assert "== vae_decoder (cpu, kernels=plain)" in out
        assert "top 4 ops by device time:" in out
        assert (tmp_path / "trace" / "trace.json").exists()
    elif cmd == "sweep":
        row = json.loads(out.splitlines()[-1])
        assert (row["config"], row["steps"], row["kernels"]) == (
            "tiny", 2, "plain")


def test_info_prints_the_version(capsys):
    from sdtpu_torch import __version__

    assert main(["info"]) == 0
    first = capsys.readouterr().out.splitlines()[0]
    assert first.startswith(f"sdtpu_torch {__version__} (torch ")
    assert __version__ == "0.1.0"


def test_serve_builds_the_context(monkeypatch):
    """``serve``'s flags reach ``Context`` and ``engine.server.serve``."""
    seen = {}
    monkeypatch.setattr(t_server, "serve",
                        lambda ctx, **kw: seen.update(ctx=ctx, **kw))
    assert main(["serve", *TINY, "--port", "0", "--max-batch", "2",
                 "--stream-slots", "2", "--stream-steps", "1,3"]) == 0
    ctx = seen["ctx"]
    assert ctx.device.type == "cpu" and ctx.steps == 2
    assert ctx.cfg.image_size == 16 and ctx.kernels == "plain"
    assert seen["max_batch"] == 2 and seen["stream_slots"] == 2
    assert seen["stream_steps"] == (1, 3) and seen["port"] == 0
    assert main(["serve", *TINY, "--lora", "nameless"]) == 2
    with pytest.raises(SdtpuError) as ei:
        main(["serve", *TINY, "--mesh", "2,4"])
    assert ei.value.code == ErrorCode.INVALID_ARGUMENT


def test_warmup_and_artifact(tmp_path, capsys, monkeypatch):
    """``warmup`` on the CPU serves each batch size's first image (there
    is no kernel library to build); ``--pack`` writes the built libraries
    as ``<hash>/<library>`` members and ``--unpack`` takes those alone."""
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    cache = tmp_path / "cache"
    art = tmp_path / "a.tar.gz"
    assert main(["warmup", "--configs", "tiny", "--steps", "2",
                 "--batch-sizes", "1,2", "--platform", "cpu",
                 "--cache-dir", str(cache), "--pack", str(art)]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert lines[0]["config"] == "tiny" and set(
        lines[0]["first_image_s"]) == {"1", "2"}
    assert lines[-1]["backend"] == "cpu" and lines[-1]["entries"] == 0
    assert _build.BUILD_DIR == cache

    def tar(path, members):
        with tarfile.open(path, "w:gz") as tf:
            for name in members:
                info = tarfile.TarInfo(name)
                info.size = 3
                tf.addfile(info, io.BytesIO(b"lib"))

    good = tmp_path / "good.tar.gz"
    tar(good, [f"0123456789abcdef/{_build.LIB_NAME}"])
    dest = tmp_path / "dest"
    assert main(["warmup", "--unpack", str(good), "--cache-dir",
                 str(dest)]) == 0
    assert json.loads(capsys.readouterr().out)["entries"] == 1
    for bad in ("../evil/x.so", "flat.so", "a/b/c.so"):
        art = tmp_path / "bad.tar.gz"
        tar(art, [bad])
        with pytest.raises(SystemExit, match="unsafe archive member"):
            main(["warmup", "--unpack", str(art), "--cache-dir",
                  str(tmp_path / "dest2")])
