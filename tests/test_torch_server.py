"""The port's HTTP service (``sdtpu_torch.engine.server``) at TINY on the
CPU, on ``127.0.0.1`` with an ephemeral port: each case of the JAX
package's ``tests/test_server.py`` against the port's ``Context``
(healthz, PNG and raw bodies, micro-batching, the image endpoints, the
caps, malformed payloads, backpressure, LoRA routing, the ControlNet
endpoint, depth2img and edit, stream mode with previews and per-request
steps), and every malformed payload sent to the reference's server and to
the port's: the same status and the same error text. Those requests return
before any model work, so both servers run over the same stub context."""

import base64
import io
import json
import re
import socket
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from sdtpu.engine import logging as j_slog
from sdtpu.engine import server as j_server
from sdtpu_torch import Context, SdtpuError
from sdtpu_torch.engine import logging as t_slog
from sdtpu_torch.engine.server import MicroBatcher, QueueFull, serve
from sdtpu_torch.io.kohya import load_lora_kohya, site_map
from sdtpu_torch.models import layers as t_layers
from sdtpu_torch.train.lora import save_lora_npz

#: /healthz's keys (``sdtpu/engine/server.py:402-414``)
HEALTHZ_KEYS = {"status", "backend", "image_size", "steps", "sampler",
                "max_batch", "stream_slots", "stream_step_choices",
                "lora_adapters", "controlnets"}


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


def _start(serve_fn, ctx, **kw):
    """Start ``serve_fn(ctx, ...)`` on an ephemeral port -> (base URL,
    the server); the test hooks name it."""
    ready = threading.Event()
    t = threading.Thread(target=serve_fn, args=(ctx,),
                         kwargs={"port": 0, "ready_event": ready, **kw},
                         daemon=True)
    t.start()
    assert ready.wait(30)
    httpd = serve_fn.last_server
    return f"http://127.0.0.1:{httpd.server_address[1]}", httpd


#: the micro-batcher of the module's server
BATCHER = {}


@pytest.fixture(scope="module")
def server():
    ctx = Context(config="tiny", steps=2, device="cpu")
    base, httpd = _start(serve, ctx)
    BATCHER["server"] = serve.last_batcher
    yield ctx, base
    httpd.shutdown()


def _post(url, obj):
    req = urllib.request.Request(
        url, data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def _post_raw(url, data: bytes):
    req = urllib.request.Request(
        url, data=data, headers={"Content-Type": "application/json"},
        method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _raw_head(base, content_length):
    """The status line of a POST whose Content-Length header is
    ``content_length`` and whose body never comes."""
    host, port = base.replace("http://", "").split(":")
    with socket.create_connection((host, int(port)), timeout=30) as s:
        s.sendall(
            f"POST /generate HTTP/1.1\r\nHost: {host}\r\n"
            f"Content-Type: application/json\r\n"
            f"Content-Length: {content_length}\r\n\r\n".encode())
        return s.recv(4096).decode(errors="replace").splitlines()[0]


def _b64(arr, mode=None):
    buf = io.BytesIO()
    Image.fromarray(arr, mode).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _ramp(size):
    row = np.linspace(0, 255, size, dtype=np.uint8)
    return np.ascontiguousarray(
        np.broadcast_to(row[None, :, None], (size, size, 3)))


def _img(body, size):
    return np.frombuffer(body, np.uint8).reshape(size, size, 3)


def _within_one(a, b):
    return np.abs(a.astype(int) - b.astype(int)).max() <= 1


def test_healthz(server):
    """The reference's keys; the backend is the Context's device."""
    ctx, base = server
    with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
        info = json.loads(r.read())
    assert set(info) == HEALTHZ_KEYS
    assert info["status"] == "ok" and info["backend"] == "cpu"
    assert info["image_size"] == ctx.cfg.image_size
    assert info["max_batch"] == 4 and info["stream_slots"] == 0


def test_generate_png(server):
    _, base = server
    status, ctype, body = _post(base + "/generate",
                                {"prompt": "the horse", "seed": 1})
    assert status == 200 and ctype == "image/png"
    assert body[:8] == b"\x89PNG\r\n\x1a\n"


def test_generate_raw_matches_direct(server):
    ctx, base = server
    status, ctype, body = _post(
        base + "/generate",
        {"prompt": "the horse", "seed": 7, "format": "raw"})
    assert status == 200 and ctype == "application/octet-stream"
    img = _img(body, ctx.cfg.image_size)
    assert np.array_equal(img, ctx.generate("the horse", seed=7))


def test_concurrent_requests_micro_batched(server):
    """4 simultaneous requests, each within one level of its own single
    call; the PNG decodes to the raw bytes."""
    ctx, base = server
    size = ctx.cfg.image_size
    results = {}

    def one(i):
        results[i] = _post(base + "/generate",
                           {"prompt": "the horse", "seed": 100 + i,
                            "guidance": 5.0 + i, "format": "raw"})

    threads = [threading.Thread(target=one, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for i in range(4):
        status, _, body = results[i]
        assert status == 200, body
        direct = ctx.generate("the horse", seed=100 + i, guidance=5.0 + i)
        assert _within_one(_img(body, size), direct), i


def test_batcher_forms_one_batch_of_four(server):
    """With the linger long enough, four concurrent requests run as one
    batch of 4, whose images are the bytes of ``generate_batch`` on the
    same requests, and each decodes from its PNG."""
    ctx, base = server
    size = ctx.cfg.image_size
    reqs = [{"prompt": "the horse", "seed": i, "guidance": 5.0 + i}
            for i in range(4)]
    batcher = BATCHER["server"]
    before = batcher.batch_sizes[("gen", 4)]
    old, batcher.max_wait = batcher.max_wait, 30.0
    try:
        results = {}

        def one(i):
            results[i] = _post(base + "/generate", reqs[i])

        threads = [threading.Thread(target=one, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        batcher.max_wait = old
    assert batcher.batch_sizes[("gen", 4)] == before + 1
    want = ctx.generate_batch(reqs)
    for i in range(4):
        status, ctype, body = results[i]
        assert status == 200 and ctype == "image/png"
        got = np.asarray(Image.open(io.BytesIO(body)))
        assert got.shape == (size, size, 3)
        assert np.array_equal(got, want[i])


def test_generate_batch_api(server):
    ctx, _ = server
    single = ctx.generate("the horse", seed=11, guidance=6.0)
    [b1] = ctx.generate_batch(
        [{"prompt": "the horse", "seed": 11, "guidance": 6.0}])
    assert np.array_equal(b1, single)
    outs = ctx.generate_batch([
        {"prompt": "the horse", "seed": 1},
        {"prompt": "a cat", "seed": 2, "guidance": 3.0},
        {"prompt": "the horse", "seed": 3, "negative_prompt": "blurry"},
    ])
    assert len(outs) == 3
    assert not np.array_equal(outs[0], outs[1])


def test_img2img_and_inpaint_endpoints(server):
    ctx, base = server
    size = ctx.cfg.image_size
    init = _ramp(size)
    status, _, body = _post(
        base + "/img2img",
        {"prompt": "the horse", "seed": 3, "strength": 0.5,
         "image_b64": _b64(init, "RGB"), "format": "raw"})
    assert status == 200, body
    direct = ctx.img2img("the horse", init, strength=0.5, seed=3)
    assert np.array_equal(_img(body, size), direct)

    mask = np.zeros((size, size), np.uint8)
    mask[:, size // 2:] = 255
    status, _, body = _post(
        base + "/inpaint",
        {"prompt": "the horse", "seed": 3, "image_b64": _b64(init, "RGB"),
         "mask_b64": _b64(mask, "L"), "format": "raw"})
    assert status == 200, body
    direct = ctx.inpaint("the horse", init, mask, seed=3)
    assert np.array_equal(_img(body, size), direct)

    status, _, body = _post(
        base + "/inpaint", {"prompt": "x", "image_b64": _b64(init, "RGB")})
    assert status == 400 and b"mask_b64" in body


def test_generate_missing_prompt(server):
    _, base = server
    status, _, body = _post(base + "/generate", {"guidance": 7.5})
    assert status == 400 and b"prompt" in body


def test_unknown_route(server):
    _, base = server
    status, _, _ = _post(base + "/nope", {})
    assert status == 404
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(base + "/nope", timeout=30)
    assert ei.value.code == 404


def test_concurrent_img2img_micro_batched(server):
    """4 simultaneous same-strength img2img requests through the batcher's
    img2img group, each within one level of its single call."""
    ctx, base = server
    size = ctx.cfg.image_size
    init = _ramp(size)
    b64 = _b64(init, "RGB")
    batcher = BATCHER["server"]
    before = sum(v for k, v in batcher.batch_sizes.items() if k[0] == "i2i")
    results = {}

    def one(i):
        results[i] = _post(base + "/img2img",
                           {"prompt": "the horse", "seed": 200 + i,
                            "strength": 0.5, "image_b64": b64,
                            "format": "raw"})

    threads = [threading.Thread(target=one, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for i in range(4):
        status, _, body = results[i]
        assert status == 200, body
        direct = ctx.img2img("the horse", init, strength=0.5, seed=200 + i)
        assert _within_one(_img(body, size), direct), i
    i2i = {k: v for k, v in batcher.batch_sizes.items() if k[0] == "i2i"}
    assert sum(i2i.values()) > before
    assert sum(k[1] * v for k, v in i2i.items()) >= 4


def test_img2img_batch_api(server):
    ctx, _ = server
    init = _ramp(ctx.cfg.image_size)
    single = ctx.img2img("the horse", init, strength=0.5, seed=31)
    [b1] = ctx.img2img_batch(
        [{"prompt": "the horse", "image": init, "seed": 31}], strength=0.5)
    assert np.array_equal(b1, single)
    with pytest.raises(SdtpuError):
        ctx.img2img_batch([], strength=0.5)
    with pytest.raises(SdtpuError):
        ctx.img2img_batch([{"prompt": "x", "image": init[:4]}], strength=0.5)


def test_body_size_cap(server):
    """A body over the cap gets 413 before it is read."""
    _, base = server
    assert " 413 " in _raw_head(base, 64 << 20)


def test_bad_content_length_header(server):
    _, base = server
    assert " 400 " in _raw_head(base, "abc")


def _bad_payloads():
    """(route, body) of every malformed payload of the reference's fuzz
    test (``tests/test_server.py:283-318``)."""
    gen = "/generate"
    junk_image = base64.b64encode(b"not an image at all").decode()
    return [
        (gen, b'{"prompt": "x", '),
        (gen, b"[1, 2, 3]"),
        (gen, b'"just a string"'),
        (gen, json.dumps({"prompt": ""}).encode()),
        (gen, json.dumps({"prompt": 7}).encode()),
        (gen, json.dumps({"no_prompt": "x"}).encode()),
        (gen, json.dumps({"prompt": "x", "guidance": "high"}).encode()),
        (gen, b'{"prompt": "x", "guidance": NaN}'),
        (gen, b'{"prompt": "x", "guidance": Infinity}'),
        (gen, json.dumps({"prompt": "x", "seed": 1.5}).encode()),
        (gen, json.dumps({"prompt": "x", "seed": True}).encode()),
        (gen, b'{"prompt": "x", "seed": 1e999}'),
        (gen, b'{"prompt": "x", "seed": -1e999}'),
        (gen, json.dumps({"prompt": "x", "negative_prompt": 7}).encode()),
        (gen, json.dumps({"prompt": "x", "lora": 3}).encode()),
        (gen, json.dumps({"prompt": "x", "lora": "never-loaded"}).encode()),
        (gen, json.dumps({"prompt": "x", "format": "jpeg"}).encode()),
        (gen, json.dumps({"prompt": "x",
                          "control_images_b64": {}}).encode()),
        (gen, json.dumps({"prompt": "x", "steps": 2}).encode()),
        (gen, json.dumps({"prompt": "x", "steps": 2.5}).encode()),
        ("/img2img", json.dumps({"prompt": "x"}).encode()),
        ("/img2img", json.dumps(
            {"prompt": "x", "image_b64": "!!!not-base64!!!"}).encode()),
        ("/img2img", json.dumps(
            {"prompt": "x", "image_b64": junk_image}).encode()),
        ("/img2img", json.dumps({"prompt": "x", "image_b64": 12345}).encode()),
        ("/img2img", json.dumps({"prompt": "x", "image_b64": _b64(
            _ramp(16), "RGB"), "strength": "half"}).encode()),
        ("/inpaint", json.dumps(
            {"prompt": "x", "image_b64": base64.b64encode(
                b"x").decode()}).encode()),
        ("/inpaint", json.dumps(
            {"prompt": "x", "image_b64": _b64(_ramp(16), "RGB")}).encode()),
        ("/depth2img", json.dumps(
            {"prompt": "x", "image_b64": _b64(_ramp(16), "RGB")}).encode()),
        ("/edit", json.dumps({"prompt": "x", "image_b64": _b64(
            _ramp(16), "RGB"), "image_guidance": [1]}).encode()),
        ("/upscale", json.dumps({"prompt": "x"}).encode()),
    ]


BAD = _bad_payloads()


@pytest.fixture(scope="module")
def both_servers():
    """The reference's server and the port's over stubs of a Context with
    the attributes the parse phase reads (an engine call would fail with
    a TypeError, a 500, on both)."""
    def stub(slog):
        return types.SimpleNamespace(
            logger=slog.Logger(slog.LogLevel.ERROR), lora_names=lambda: [],
            instruct_pix2pix=None, upscale=None, depth2img=None)

    jbase, jhttpd = _start(j_server.serve, stub(j_slog))
    tbase, thttpd = _start(serve, stub(t_slog))
    yield jbase, tbase
    jhttpd.shutdown()
    thttpd.shutdown()


@pytest.mark.parametrize("i", range(len(BAD)))
def test_malformed_payload_answers_as_the_reference(both_servers, i):
    """400 with the reference's error text, before any model work."""
    jbase, tbase = both_servers
    route, body = BAD[i]
    j_status, j_body = _post_raw(jbase + route, body)
    t_status, t_body = _post_raw(tbase + route, body)
    assert t_status == j_status == 400, (route, body[:80], t_body[:200])
    # PIL's text names the buffer object by its address
    t_err, j_err = (re.sub(r" at 0x[0-9a-f]+", "", json.loads(b)["error"])
                    for b in (t_body, j_body))
    assert t_err == j_err


def test_protocol_errors_answer_as_the_reference(both_servers):
    """413 and a bad Content-Length's 400 on both; 404 on an unknown
    route; /preview off outside stream mode."""
    jbase, tbase = both_servers
    for cl in (64 << 20, "abc"):
        assert _raw_head(tbase, cl) == _raw_head(jbase, cl)
    for route in ("/nope", "/preview?tag=x"):
        got = []
        for base in (jbase, tbase):
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(base + route, timeout=30)
            got.append((ei.value.code, ei.value.read()))
        assert got[0] == got[1] and got[0][0] == 404


def test_malformed_payloads_rejected_400(server):
    """The fuzz batch on the live server: every payload 400 with a JSON
    error, and the server still serves valid work after it."""
    _, base = server
    for route, body in BAD:
        status, resp = _post_raw(base + route, body)
        assert status == 400, (route, body[:80], status, resp[:200])
        assert "error" in json.loads(resp)
    status, ctype, _ = _post(base + "/generate",
                             {"prompt": "the horse", "seed": 3})
    assert status == 200 and ctype == "image/png"


def test_concurrent_client_load(server):
    """12 concurrent clients against max_batch=4: every request served,
    each within one level of its own single call."""
    ctx, base = server
    size = ctx.cfg.image_size
    results = {}

    def one(i):
        results[i] = _post(base + "/generate",
                           {"prompt": "the horse" if i % 2 else "a cat",
                            "seed": 500 + i, "format": "raw"})

    threads = [threading.Thread(target=one, args=(i,)) for i in range(12)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(results) == 12
    for i in range(12):
        status, _, body = results[i]
        assert status == 200, body[:200]
        direct = ctx.generate("the horse" if i % 2 else "a cat",
                              seed=500 + i)
        assert _within_one(_img(body, size), direct), i


def test_microbatcher_queue_full(server):
    """With the dispatch blocked (the device lock held), the bounded queue
    refuses the excess request with QueueFull and drains on release."""
    ctx, _ = server
    lock = threading.Lock()
    b = MicroBatcher(ctx, lock, max_batch=1, max_wait_ms=1.0, max_queue=1)
    outs = {}

    def bg(i):
        outs[i] = b.submit({"prompt": "the horse", "seed": i})

    with lock:
        t0 = threading.Thread(target=bg, args=(0,), daemon=True)
        t0.start()
        deadline = time.monotonic() + 10
        while b._queue and time.monotonic() < deadline:
            time.sleep(0.01)
        assert not b._queue
        t1 = threading.Thread(target=bg, args=(1,), daemon=True)
        t1.start()
        while not b._queue and time.monotonic() < deadline:
            time.sleep(0.01)
        assert len(b._queue) == 1
        with pytest.raises(QueueFull):
            b.submit({"prompt": "the horse", "seed": 2})
    t0.join(120)
    t1.join(120)
    size = ctx.cfg.image_size
    assert outs[0].shape == outs[1].shape == (size, size, 3)


def test_backpressure_http_503(server):
    ctx, _ = server
    base2, httpd = _start(serve, ctx, max_queue=1)
    batcher = serve.last_batcher
    try:
        batcher.max_queue = 0   # every enqueue refuses
        req = urllib.request.Request(
            base2 + "/generate",
            data=json.dumps({"prompt": "the horse"}).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=60)
        assert ei.value.code == 503
        assert ei.value.headers.get("Retry-After") == "1"
        batcher.max_queue = 1
        status, ctype, _ = _post(base2 + "/generate",
                                 {"prompt": "the horse", "seed": 5})
        assert status == 200 and ctype == "image/png"
    finally:
        httpd.shutdown()


def _adapter_npz(ctx, path, seed):
    """A rank-2 LoRA of every attention projection of ``ctx``'s UNet,
    drawn from ``seed``, as a native ``.npz``."""
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


def test_lora_per_request_routing(server, tmp_path):
    """Two adapters and the base served concurrently: each HTTP result is
    the Context's bytes for its adapter; an unknown adapter is a 400 that
    names the registry."""
    ctx, base = server
    pa, pb = tmp_path / "styleA.npz", tmp_path / "styleB.npz"
    _adapter_npz(ctx, pa, seed=1)
    _adapter_npz(ctx, pb, seed=2)
    ctx.load_lora("styleA", str(pa))
    ctx.load_lora("styleB", str(pb))
    with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
        assert json.loads(r.read())["lora_adapters"] == ["styleA", "styleB"]

    ref = {"styleA": ctx.generate("the horse", seed=42, lora="styleA"),
           "styleB": ctx.generate("the horse", seed=42, lora="styleB"),
           None: ctx.generate("the horse", seed=42)}
    assert not np.array_equal(ref["styleA"], ref[None])
    assert not np.array_equal(ref["styleA"], ref["styleB"])
    size = ctx.cfg.image_size
    results = {}

    def one(lora):
        req = {"prompt": "the horse", "seed": 42, "format": "raw"}
        if lora is not None:
            req["lora"] = lora
        results[lora] = _post(base + "/generate", req)

    threads = [threading.Thread(target=one, args=(k,)) for k in ref]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for k, want in ref.items():
        status, _, body = results[k]
        assert status == 200, (k, body)
        assert np.array_equal(_img(body, size), want), k
    status, _, body = _post(base + "/generate",
                            {"prompt": "x", "lora": "nope"})
    assert status == 400 and b"nope" in body and b"styleA" in body


def test_controlnet_endpoint(server):
    ctx, base = server
    ctx.load_controlnet("edges", "random")
    with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
        assert "edges" in json.loads(r.read())["controlnets"]
    size = ctx.cfg.image_size
    hint = np.random.default_rng(0).integers(0, 256, (size, size, 3),
                                             dtype=np.uint8)
    want = ctx.generate("the horse", seed=5, control_image=hint,
                        control="edges", control_scale=0.7)
    status, _, body = _post(base + "/generate", {
        "prompt": "the horse", "seed": 5, "format": "raw",
        "control_image_b64": _b64(hint), "control": "edges",
        "control_scale": 0.7})
    assert status == 200, body
    got = _img(body, size)
    assert np.array_equal(got, want)
    assert not np.array_equal(got, ctx.generate("the horse", seed=5))


def test_depth2img_and_edit_endpoints():
    """One server a concat configuration: the raw output is the direct
    Context call's bytes."""
    def with_server(ctx, fn):
        base, httpd = _start(serve, ctx)
        try:
            fn(base)
        finally:
            httpd.shutdown()

    ctx5 = Context(config="tiny_depth", steps=2, device="cpu")
    size = ctx5.cfg.image_size
    init = _ramp(size)
    depth16 = np.linspace(0, 60000, size * size, dtype=np.float32).reshape(
        size, size).astype(np.uint16)

    def drive_depth(base):
        status, _, body = _post(
            base + "/depth2img",
            {"prompt": "the horse", "seed": 2, "strength": 0.5,
             "image_b64": _b64(init, "RGB"), "depth_b64": _b64(depth16),
             "format": "raw"})
        assert status == 200, body
        direct = ctx5.depth2img("the horse", init, depth16.astype(np.float32),
                                strength=0.5, seed=2)
        assert np.array_equal(_img(body, size), direct)
        status, _, body = _post(
            base + "/depth2img", {"prompt": "x", "image_b64": _b64(init)})
        assert status == 400 and b"depth_b64" in body

    with_server(ctx5, drive_depth)
    ctx8 = Context(config="tiny_ip2p", steps=2, device="cpu")

    def drive_edit(base):
        status, _, body = _post(
            base + "/edit",
            {"prompt": "make it winter", "seed": 5, "image_guidance": 1.4,
             "image_b64": _b64(init, "RGB"), "format": "raw"})
        assert status == 200, body
        direct = ctx8.instruct_pix2pix("make it winter", init,
                                       image_guidance=1.4, seed=5)
        assert np.array_equal(_img(body, size), direct)

    with_server(ctx8, drive_edit)


def test_steps_rejected_without_stream_mode(server):
    _, base = server
    status, _, body = _post(base + "/generate",
                            {"prompt": "x", "steps": 4, "format": "raw"})
    assert status == 400 and b"stream mode" in body


@pytest.fixture(scope="module")
def stream_server():
    ctx = Context(config="tiny", steps=6, device="cpu")
    base, httpd = _start(serve, ctx, stream_slots=2, stream_steps=(3,))
    yield ctx, base
    httpd.shutdown()


def test_stream_mode_serving(stream_server):
    """Concurrent plain /generate requests flow through the pool; each raw
    image is within one level of the single Context path."""
    ctx, base = stream_server
    with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
        info = json.loads(r.read())
    assert set(info) == HEALTHZ_KEYS and info["stream_slots"] == 2
    size = ctx.cfg.image_size
    outs = {}

    def call(seed):
        outs[seed] = _post(base + "/generate", {
            "prompt": "the horse", "seed": seed, "format": "raw"})

    threads = [threading.Thread(target=call, args=(s,)) for s in (41, 42, 43)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for s in (41, 42, 43):
        status, _, body = outs[s]
        assert status == 200, body
        assert _within_one(_img(body, size), ctx.generate("the horse", seed=s))


def test_stream_mode_per_request_steps(stream_server):
    ctx, base = stream_server
    with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
        assert json.loads(r.read())["stream_step_choices"] == [3, 6]
    status, _, body = _post(
        base + "/generate",
        {"prompt": "the horse", "seed": 77, "steps": 3, "format": "raw"})
    assert status == 200, body
    img = _img(body, ctx.cfg.image_size)
    old = ctx.steps
    ctx.set_steps(3)
    try:
        ref = ctx.generate("the horse", seed=77)
    finally:
        ctx.set_steps(old)
    d = np.abs(img.astype(np.int16) - ref.astype(np.int16))
    assert d.max() <= 1 and (d > 0).mean() < 0.01
    status, _, body = _post(base + "/generate",
                            {"prompt": "x", "steps": 5, "format": "raw"})
    assert status == 400 and b"[3, 6]" in body
    status, _, body = _post(base + "/generate",
                            {"prompt": "x", "steps": 3.5, "format": "raw"})
    assert status == 400 and b"must be an int" in body
    status, _, body = _post(base + "/generate",
                            {"prompt": "x", "steps": 3, "pag_scale": 1.0,
                             "format": "raw"})
    assert status == 400 and b"stream mode" in body


def test_stream_mode_preview_and_fallbacks(stream_server):
    """Tagged requests expose /preview while in flight; a PAG request takes
    the static path and still serves."""
    ctx, base = stream_server
    status, _, body = _post(base + "/generate",
                            {"prompt": "the horse", "seed": 9,
                             "pag_scale": 1.0, "format": "raw"})
    assert status == 200, body
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(base + "/preview?tag=nope", timeout=30)
    assert ei.value.code == 404
    got = {}

    def call():
        _post(base + "/generate", {"prompt": "the horse", "seed": 10,
                                   "tag": "t1", "format": "raw"})

    fillers = [threading.Thread(
        target=lambda s=s: _post(base + "/generate",
                                 {"prompt": "the horse", "seed": s,
                                  "format": "raw"})) for s in (100, 101, 102)]
    t = threading.Thread(target=call)
    t.start()
    for f in fillers:
        f.start()
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline and not got:
        try:
            with urllib.request.urlopen(base + "/preview?tag=t1",
                                        timeout=30) as r:
                got["png"] = r.read()
        except urllib.error.HTTPError:
            time.sleep(0.01)
    t.join()
    for f in fillers:
        f.join()
    assert got and got["png"][:8] == b"\x89PNG\r\n\x1a\n"
    s = ctx.cfg.latent_size
    assert np.asarray(Image.open(io.BytesIO(got["png"]))).shape == (s, s, 3)
