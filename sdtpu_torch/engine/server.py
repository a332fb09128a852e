"""The HTTP service over a Context, the counterpart of
``sdtpu/engine/server.py``: a dependency-free (stdlib, numpy, PIL) front
end with the reference's routes, fields, status codes and texts.

    POST /generate  {"prompt": "...", "guidance": 7.5, "seed": 1,
                     "negative_prompt": "...", "lora": "<adapter name>",
                     "control_image_b64": <base64 png/jpg>,  # ControlNet
                     "control": "<controlnet name>", "control_scale": 1.0,
                     "pag_scale": 3.0,  # perturbed-attention guidance
                     "steps": 4,        # stream mode: one of its choices
                     "tag": "t1",       # stream mode: /preview?tag=t1
                     "format": "png"|"raw"}
      -> image/png bytes (or application/octet-stream raw uint8 HWC)
    POST /img2img   {..., "image_b64": <base64 png/jpg>, "strength": 0.6}
    POST /inpaint   {..., "image_b64": ..., "mask_b64": <base64 grayscale,
                     white = repaint>, "strength": 1.0}
    POST /depth2img {..., "image_b64": ..., "depth_b64": <base64 grayscale
                     8/16-bit, any monotone depth scale>, "strength": 0.8}
                    (a depth-conditioned config, e.g. sd2_depth)
    POST /edit      {..., "image_b64": ..., "image_guidance": 1.5}
                    (InstructPix2Pix; config sd15_ip2p: the prompt is the
                    edit instruction)
    POST /upscale   {..., "image_b64": <low-res input at the latent grid
                    size>, "noise_level": 20}  (config sd_x4)
    GET /healthz    -> {"status": "ok", "backend": "cuda"|"cpu", ...}
    GET /preview?tag=X  -> the live latent-resolution preview PNG of an
                    in-flight /generate that passed "tag" (stream mode)

``lora`` selects a named adapter of the Context's registry per request;
"" forces the base model.

Concurrent /generate, /img2img and /inpaint requests are micro-batched: a
worker collects same-group requests for up to ``max_wait_ms`` (or until
``max_batch``) and runs them as one call with a guidance, seed and
negative prompt each (``Context.generate_batch_async``,
``img2img_batch_async``, ``inpaint_batch_async``, padded to a power of two
there). img2img and inpaint group by strength (it sets the start step),
every kind by LoRA adapter (it changes the UNet weights), /generate also
by PAG on or off (an extra eval a step), with ``pag_scale`` a sample
inside the PAG group. The worker launches batch k + 1 before it copies
batch k to the host, so the card runs while the host encodes PNGs.
ControlNet, depth2img, edit and upscale requests run one at a time under
the device lock. Bodies above ``max_body_mb`` get 413; a full queue
(``max_queue``) gets 503 with ``Retry-After``; a malformed request gets
400 with the reference's text before any model work.

``serve(..., stream_slots=N)`` serves plain /generate requests through the
continuous-batching pool (``engine.stream.StreamScheduler``) instead: one
denoising step is the scheduling unit, requests join as soon as a slot
frees, and a client that passes ``tag`` can poll /preview. LoRA, PAG and
ControlNet requests and the image endpoints keep their static paths.

Threads: the ``ThreadingHTTPServer``'s handler threads, the batcher's
worker and the stream's worker share the Context and its device; each
launch sequence runs under the device lock or in a worker, on torch's
default stream.
"""

from __future__ import annotations

import base64
import collections
import binascii
import io
import json
import math
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np


class QueueFull(RuntimeError):
    """Backpressure signal: the serving queue is at capacity. The HTTP
    layer maps this to 503 + Retry-After so load balancers shed load
    instead of piling unbounded work onto the device (the reference's C
    API gets this for free by being a single blocking call,
    reference: libsdod.cpp:235; a network server must bound its queue)."""


class BadRequest(ValueError):
    """Client-input validation failure -> HTTP 400 (vs 500 for engine
    faults). Raised only during the request-parse phase, before any
    device work is enqueued."""


class MicroBatcher:
    """Collect concurrent requests into one batched call a group.

    Requests are submitted with a ``group`` key; only same-group requests
    batch together (txt2img is one group, img2img groups by strength). The
    first waiter pays up to ``max_wait_ms`` of added latency; everyone in
    the batch shares one UNet eval a step. ``batch_sizes`` counts the
    dispatched batches by (kind, size).
    """

    def __init__(self, ctx, device_lock, max_batch: int = 4,
                 max_wait_ms: float = 25.0, max_queue: int = 64):
        self.ctx = ctx
        self.device_lock = device_lock
        self.max_batch = max(1, int(max_batch))
        self.max_wait = max_wait_ms / 1e3
        self.max_queue = max(1, int(max_queue))
        self._cv = threading.Condition()
        # FIFO of items; each carries its group key — the worker drains the
        # oldest group's items first (bounded unfairness: one group's batch
        # per dispatch)
        self._queue: list[dict] = []
        self.batch_sizes: collections.Counter = collections.Counter()
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="sdtpu-batcher")
        self._worker.start()

    def submit(self, req: dict, group=("gen", None)) -> np.ndarray:
        item = {"req": req, "group": group, "done": threading.Event(),
                "result": None, "error": None}
        with self._cv:
            if len(self._queue) >= self.max_queue:
                raise QueueFull(
                    f"serving queue full ({self.max_queue} waiting)")
            self._queue.append(item)
            self._cv.notify_all()
        item["done"].wait()
        if item["error"] is not None:
            raise item["error"]
        return item["result"]

    def _collect(self, wait: bool):
        """Take the oldest group's items off the queue. With ``wait`` the
        caller has nothing in flight: block for work, then linger up to
        ``max_wait`` for batch-mates. Without it (a batch is already in
        flight and must be fetched soon) take whatever is queued NOW —
        the in-flight fetch, not a timer, is the batching window."""
        with self._cv:
            if wait:
                while not self._queue:
                    self._cv.wait()
            if not self._queue:
                return []
            group = self._queue[0]["group"]
            if wait:
                deadline = time.monotonic() + self.max_wait

                def _ready():
                    return sum(
                        1 for i in self._queue if i["group"] == group)

                while _ready() < self.max_batch:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cv.wait(remaining)
            batch = [i for i in self._queue if i["group"] == group]
            batch = batch[: self.max_batch]
            for i in batch:
                self._queue.remove(i)
            return batch

    def _dispatch(self, batch):
        """Launch one batched call; returns a fetch callable (the device
        runs on; the host copy happens at fetch time)."""
        group = batch[0]["group"]
        reqs = [b["req"] for b in batch]
        self.batch_sizes[(group[0], len(reqs))] += 1
        with self.device_lock:
            if group[0] == "gen":    # ("gen", lora)
                return self.ctx.generate_batch_async(reqs, lora=group[1])
            if group[0] == "inp":    # ("inp", strength, lora)
                return self.ctx.inpaint_batch_async(
                    reqs, strength=group[1], lora=group[2])
            # ("i2i", strength, lora)
            return self.ctx.img2img_batch_async(
                reqs, strength=group[1], lora=group[2])

    def _run(self):
        """Double-buffered serve loop: launch batch k+1 before fetching
        batch k, so the host-side fetch, PNG encode and delivery of one
        batch overlap the device work of the next."""
        pending = None  # (batch_items, fetch_callable) in flight
        while True:
            batch = self._collect(wait=pending is None)
            if batch:
                try:
                    fetch = self._dispatch(batch)
                except Exception as e:  # noqa: BLE001 — to the waiters
                    for b in batch:
                        b["error"] = e
                        b["done"].set()
                    batch = None
            if pending is not None:
                pbatch, pfetch = pending
                try:
                    outs = pfetch()
                    for b, o in zip(pbatch, outs):
                        b["result"] = o
                except Exception as e:  # noqa: BLE001
                    for b in pbatch:
                        b["error"] = e
                for b in pbatch:
                    b["done"].set()
                pending = None
            if batch:
                pending = (batch, fetch)


class StreamWorker:
    """Continuous-batching serving worker over engine/stream.

    Unlike the MicroBatcher's barrier batches, requests join the device
    pool the moment a slot frees — one denoising step is the scheduling
    unit, so a request's latency is queue-wait + steps*tick with no
    batch-boundary waits (see engine/stream.StreamScheduler). Plain
    txt2img only (prompt/negative/guidance/seed); LoRA/ControlNet/PAG and
    the image endpoints keep their static paths. Clients that pass a
    ``tag`` can poll ``GET /preview?tag=...`` for a live latent-resolution
    preview while their request is in flight."""

    def __init__(self, ctx, slots: int = 4, max_queue: int = 64,
                 step_choices: tuple = (), sched=None):
        from sdtpu_torch.engine.stream import StreamScheduler

        self.sched = (StreamScheduler(ctx, slots, step_choices=step_choices)
                      if sched is None else sched)
        self.max_queue = max(1, int(max_queue))
        self._cv = threading.Condition()
        self._waiters: dict[int, dict] = {}
        self._tags: dict[str, int] = {}
        self._previews: dict[int, np.ndarray] = {}
        # a short job can finish between two client polls; keep its LAST
        # preview for a grace window so /preview answers instead of 404ing
        self._recent: dict[str, tuple[float, np.ndarray]] = {}
        self.preview_grace_s = 5.0
        threading.Thread(target=self._run, daemon=True,
                         name="sdtpu-stream").start()

    def submit(self, prompt: str, guidance: float, seed, negative_prompt,
               tag: str | None = None,
               steps: int | None = None) -> np.ndarray:
        item = {"done": threading.Event(), "result": None, "error": None}
        with self._cv:
            if len(self.sched._queue) >= self.max_queue:
                raise QueueFull(
                    f"stream queue full ({self.max_queue} waiting)")
            rid = self.sched.submit(prompt, guidance=guidance, seed=seed,
                                    negative_prompt=negative_prompt,
                                    steps=steps)
            self._waiters[rid] = item
            if tag:
                self._tags[str(tag)] = rid
            self._cv.notify_all()
        item["done"].wait()
        if item["error"] is not None:
            raise item["error"]
        return item["result"]

    def preview(self, tag: str):
        with self._cv:
            tag = str(tag)
            rid = self._tags.get(tag)
            if rid is not None and rid in self._previews:
                return self._previews[rid]
            ent = self._recent.get(tag)
            if ent is not None and ent[0] > time.monotonic():
                return ent[1]
            return None

    def _run(self):
        while True:
            with self._cv:
                while not (self.sched._queue or self.sched._live):
                    self._cv.wait()
                try:
                    self.sched.tick()
                    if self._tags:
                        self._previews.update(self.sched.previews())
                    done = self.sched.completed()
                except Exception as e:  # noqa: BLE001 — fail the waiters
                    for it in self._waiters.values():
                        it["error"] = e
                        it["done"].set()
                    self._waiters.clear()
                    self._tags.clear()
                    self._previews.clear()
                    continue
                now = time.monotonic()
                self._recent = {t: e for t, e in self._recent.items()
                                if e[0] > now}
                for rid, img in done.items():
                    it = self._waiters.pop(rid, None)
                    if it is not None:
                        it["result"] = img
                        it["done"].set()
                    last = self._previews.pop(rid, None)
                    for t in [t for t, r in self._tags.items() if r == rid]:
                        if last is not None:
                            self._recent[t] = (
                                now + self.preview_grace_s, last)
                        del self._tags[t]


def _b64_bytes(field: str, b64) -> bytes:
    if not isinstance(b64, str):
        raise BadRequest(f"'{field}' must be a base64 string")
    try:
        return base64.b64decode(b64, validate=True)
    except (binascii.Error, ValueError) as e:
        raise BadRequest(f"'{field}' is not valid base64: {e}") from None


def _open_image(field: str, b64):
    from PIL import Image

    try:
        im = Image.open(io.BytesIO(_b64_bytes(field, b64)))
        im.load()
        return im
    except BadRequest:
        raise
    except Exception as e:  # noqa: BLE001 — PIL raises many types
        raise BadRequest(f"'{field}' is not a decodable image: {e}") from None


def _decode_image(b64: str, field: str = "image_b64") -> np.ndarray:
    return np.asarray(_open_image(field, b64).convert("RGB"))


def _decode_mask(b64: str, field: str = "mask_b64") -> np.ndarray:
    return np.asarray(_open_image(field, b64).convert("L"))


def _decode_depth(b64: str, field: str = "depth_b64") -> np.ndarray:
    """Grayscale depth map, 8- or 16-bit png (any monotone scale — the
    program min/max-normalizes per sample)."""
    im = _open_image(field, b64)
    if im.mode not in ("I", "I;16", "F", "L"):
        im = im.convert("L")
    d = np.asarray(im, np.float32)
    if d.ndim == 3:
        d = d.mean(axis=-1)
    return d


def _finite(field: str, v, default: float) -> float:
    """Parse an optional numeric JSON field; non-numeric / NaN / inf -> 400
    (a NaN guidance would silently poison every image in its batch)."""
    if v is None:
        return float(default)
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        raise BadRequest(f"'{field}' must be a number")
    v = float(v)
    if not math.isfinite(v):
        raise BadRequest(f"'{field}' must be finite")
    return v


def make_handler(ctx, lock: threading.Lock, batcher: MicroBatcher,
                 max_body: int = 32 << 20,
                 stream: "StreamWorker | None" = None):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # route through engine logging
            ctx.logger.debug("http: " + fmt % args)

        def _send(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, code: int, obj):
            self._send(code, json.dumps(obj).encode(), "application/json")

        def _image(self, img: np.ndarray, fmt: str):
            if fmt == "raw":
                return self._send(200, img.tobytes(),
                                  "application/octet-stream")
            from PIL import Image

            buf = io.BytesIO()
            Image.fromarray(img).save(buf, format="PNG")
            return self._send(200, buf.getvalue(), "image/png")

        def do_GET(self):
            if self.path.startswith("/preview"):
                # live in-flight preview (stream mode): the request's
                # latent-resolution RGB approximation, refreshed per tick
                from urllib.parse import parse_qs, urlparse

                if stream is None:
                    return self._json(404, {"error": "stream mode off"})
                q = parse_qs(urlparse(self.path).query)
                tag = (q.get("tag") or [None])[0]
                if not tag:
                    return self._json(400, {"error": "missing 'tag'"})
                img = stream.preview(tag)
                if img is None:
                    return self._json(404, {"error": "unknown tag or no "
                                                     "preview yet"})
                return self._image(img, "png")
            if self.path != "/healthz":
                return self._json(404, {"error": "not found"})
            self._json(200, {
                "status": "ok",
                "backend": ctx.device.type,
                "image_size": ctx.cfg.image_size,
                "steps": ctx.steps,
                "sampler": ctx.sampler,
                "max_batch": batcher.max_batch,
                "stream_slots": stream.sched.slots if stream else 0,
                "stream_step_choices": (
                    list(stream.sched.step_choices) if stream else []),
                "lora_adapters": ctx.lora_names(),
                "controlnets": ctx.controlnet_names(),
            })

        def do_POST(self):
            if self.path not in ("/generate", "/img2img", "/inpaint",
                                 "/depth2img", "/edit", "/upscale"):
                return self._json(404, {"error": "not found"})
            try:
                try:
                    n = int(self.headers.get("Content-Length", 0))
                except ValueError:
                    return self._json(400, {"error": "bad Content-Length"})
                if n < 0 or n > max_body:
                    return self._json(413, {
                        "error": f"request body {n} exceeds {max_body} bytes"})
                try:
                    req = json.loads(self.rfile.read(n) or b"{}")
                except json.JSONDecodeError as e:
                    return self._json(400, {"error": f"invalid JSON: {e}"})
                if not isinstance(req, dict):
                    return self._json(400,
                                      {"error": "body must be a JSON object"})
                prompt = req.get("prompt")
                if not isinstance(prompt, str) or not prompt.strip():
                    return self._json(400, {"error": "missing 'prompt'"})
                fmt = req.get("format", "png")
                if fmt not in ("png", "raw"):
                    return self._json(400, {"error": "'format' must be "
                                                     "'png' or 'raw'"})
                guidance = _finite("guidance", req.get("guidance"), 7.5)
                seed = req.get("seed")
                if seed is not None:
                    # reject non-finite floats BEFORE int(): 1e999 parses to
                    # inf and int(inf) raises OverflowError, which would fall
                    # through to the generic 500 instead of the typed 400
                    if isinstance(seed, bool) or not isinstance(
                            seed, (int, float)) or (
                            isinstance(seed, float)
                            and not math.isfinite(seed)) or int(seed) != seed:
                        return self._json(400,
                                          {"error": "'seed' must be an int"})
                    seed = int(seed)
                neg = req.get("negative_prompt")
                if neg is not None and not isinstance(neg, str):
                    return self._json(400, {"error": "'negative_prompt' "
                                                     "must be a string"})
                lora = req.get("lora")
                if lora is not None and not isinstance(lora, str):
                    return self._json(400, {"error": "'lora' must be a "
                                                     "string adapter name"})
                if lora and lora not in ctx.lora_names():
                    return self._json(400, {
                        "error": f"unknown lora adapter {lora!r} "
                                 f"(loaded: {ctx.lora_names()})"})
                if self.path == "/generate":
                    if "control_image_b64" in req or \
                            "control_images_b64" in req:
                        # ControlNet conditioning: serialized through the
                        # device lock (like inpaint — per-request hint
                        # tensors don't batch across requests). Lists give
                        # multi-ControlNet composition (summed residuals).
                        if "control_images_b64" in req:
                            imgs = req["control_images_b64"]
                            if not isinstance(imgs, list) or not imgs:
                                return self._json(400, {
                                    "error": "'control_images_b64' must be "
                                             "a non-empty list"})
                            hint = [_decode_image(b, "control_images_b64")
                                    for b in imgs]
                            control = req.get("controls") or req.get(
                                "control")
                            scale = req.get(
                                "control_scales",
                                req.get("control_scale", 1.0))
                        else:
                            hint = _decode_image(req["control_image_b64"],
                                                 "control_image_b64")
                            control = req.get("control")
                            scale = _finite("control_scale",
                                            req.get("control_scale"), 1.0)
                        with lock:
                            img = ctx.generate(
                                prompt, guidance=guidance, seed=seed,
                                negative_prompt=neg, lora=lora,
                                control_image=hint,
                                control=control,
                                control_scale=scale)
                        return self._image(img, fmt)
                    pag0 = req.get("pag_scale")
                    steps_req = req.get("steps")
                    if steps_req is not None:
                        # per-request step counts are a stream-pool feature:
                        # each choice has its own per-slot solver plan
                        if (isinstance(steps_req, bool)
                                or not isinstance(steps_req, (int, float))
                                or int(steps_req) != steps_req):
                            return self._json(
                                400, {"error": "'steps' must be an int"})
                        steps_req = int(steps_req)
                        if stream is None or lora is not None \
                                or pag0 is not None:
                            return self._json(400, {
                                "error": "per-request 'steps' requires "
                                         "stream mode (--stream-slots) and "
                                         "no lora/pag_scale"})
                        if steps_req not in stream.sched.step_choices:
                            return self._json(400, {
                                "error": f"'steps' must be one of "
                                         f"{list(stream.sched.step_choices)}"
                                         f" (--stream-steps), got "
                                         f"{steps_req}"})
                    if (stream is not None and lora is None
                            and pag0 is None):
                        # continuous batching: join the step-level pool
                        img = stream.submit(prompt, guidance, seed, neg,
                                            tag=req.get("tag"),
                                            steps=steps_req)
                        return self._image(img, fmt)
                    # grouped by adapter AND by PAG on/off: the adapter
                    # changes the UNet weights; PAG adds a perturbed
                    # eval a step (its scale stays a sample inside the
                    # group)
                    breq = {"prompt": prompt, "guidance": guidance,
                            "seed": seed, "negative_prompt": neg}
                    pag = req.get("pag_scale")
                    if pag is not None:
                        breq["pag_scale"] = float(pag)
                    img = batcher.submit(
                        breq, group=("gen", lora, pag is not None))
                    return self._image(img, fmt)
                if "image_b64" not in req:
                    return self._json(400, {"error": "missing 'image_b64'"})
                init = _decode_image(req["image_b64"])
                if self.path == "/img2img":
                    # micro-batched: same-strength same-adapter requests
                    # share one batched call (strength selects the start
                    # step, so it is part of the group key)
                    strength = _finite("strength", req.get("strength"), 0.6)
                    img = batcher.submit(
                        {"prompt": prompt, "image": init,
                         "guidance": guidance, "seed": seed,
                         "negative_prompt": neg},
                        group=("i2i", strength, lora),
                    )
                elif self.path == "/edit":
                    # InstructPix2Pix: the prompt is the edit instruction
                    with lock:
                        img = ctx.instruct_pix2pix(
                            prompt, init, guidance=guidance,
                            image_guidance=_finite(
                                "image_guidance",
                                req.get("image_guidance"), 1.5),
                            seed=seed, negative_prompt=neg, lora=lora)
                elif self.path == "/upscale":
                    # SD x4 latent upscaler (config sd_x4): image_b64 is
                    # the LOW-RES input at the latent grid size
                    with lock:
                        img = ctx.upscale(
                            prompt, init,
                            noise_level=int(_finite(
                                "noise_level",
                                req.get("noise_level"), 20)),
                            guidance=guidance, seed=seed,
                            negative_prompt=neg, lora=lora)
                elif self.path == "/depth2img":
                    if "depth_b64" not in req:
                        return self._json(400,
                                          {"error": "missing 'depth_b64'"})
                    depth = _decode_depth(req["depth_b64"])
                    with lock:
                        img = ctx.depth2img(
                            prompt, init, depth,
                            strength=_finite("strength",
                                             req.get("strength"), 0.8),
                            guidance=guidance, seed=seed,
                            negative_prompt=neg, lora=lora)
                else:
                    if "mask_b64" not in req:
                        return self._json(400,
                                          {"error": "missing 'mask_b64'"})
                    mask = _decode_mask(req["mask_b64"])
                    # micro-batched like img2img: same-strength same-adapter
                    # inpaints fuse into one batched call
                    strength = _finite("strength", req.get("strength"), 1.0)
                    img = batcher.submit(
                        {"prompt": prompt, "image": init, "mask": mask,
                         "guidance": guidance, "seed": seed,
                         "negative_prompt": neg},
                        group=("inp", strength, lora),
                    )
                return self._image(img, fmt)
            except BadRequest as e:
                return self._json(400, {"error": str(e)})
            except QueueFull as e:
                # backpressure: bounded queue is full — shed load upstream
                self.send_response(503)
                body = json.dumps({"error": str(e)}).encode()
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Retry-After", "1")
                self.end_headers()
                self.wfile.write(body)
                return None
            except Exception as e:  # noqa: BLE001
                ctx.logger.error(f"{self.path} failed: {e}")
                return self._json(500, {"error": str(e)})

    return Handler


def serve(ctx, host: str = "127.0.0.1", port: int = 8000,
          ready_event: threading.Event | None = None,
          max_batch: int = 4, max_wait_ms: float = 25.0,
          max_body_mb: int = 32, stream_slots: int = 0,
          max_queue: int = 64, stream_steps: tuple = (), leader=None):
    """Blocking serve loop. `ready_event` is set once the socket is bound.
    ``stream_slots`` > 0 serves plain /generate requests through the
    continuous-batching pool instead of the barrier micro-batcher;
    ``stream_steps`` lists additional per-request step counts the pool
    schedules (heterogeneous traffic: clients pass ``"steps"``).
    ``max_queue`` bounds the number of waiting requests per worker; excess
    requests get 503 + Retry-After (backpressure, not unbounded buildup).
    ``leader`` (``parallel.follow.Leader``): rank 0 of a mesh, whose
    followers make every call it makes on the Context and the pool."""
    sched = None
    if leader is not None:
        ctx = leader.mirror("ctx")
        if stream_slots:
            sched = leader.new("pool", stream_slots,
                               step_choices=stream_steps)
    lock = threading.Lock()
    batcher = MicroBatcher(ctx, lock, max_batch, max_wait_ms,
                           max_queue=max_queue)
    stream = (StreamWorker(ctx, stream_slots, max_queue=max_queue,
                           step_choices=stream_steps, sched=sched)
              if stream_slots else None)
    httpd = ThreadingHTTPServer(
        (host, port),
        make_handler(ctx, lock, batcher, max_body=max_body_mb << 20,
                     stream=stream))
    ctx.logger.info(f"serving on http://{host}:{httpd.server_address[1]} "
                    f"(max_batch={batcher.max_batch}, "
                    f"stream_slots={stream_slots})")
    if ready_event is not None:
        serve.last_server = httpd    # test hooks
        serve.last_batcher = batcher
        serve.last_stream = stream
        ready_event.set()
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()
