"""Streaming training data: sharded readers, epoch semantics, device
prefetch.

Carried over from ``sdtpu/train/data.py`` (the JAX package), whose host
code is numpy and PIL: the sources (``NpzShardSource``,
``ImageFolderSource``), ``make_dataset`` and ``batches`` are its lines
unchanged, so a seed, an epoch and a shard layout give the reference's
batches. The port cannot import them, because any ``import sdtpu.*``
imports JAX. What differs is the device side: ``Prefetcher`` stages
batches with torch (pinned host tensors and ``non_blocking`` copies on a
side stream, one background thread, its errors passed on to the
consumer) in place of ``jax.device_put``, and ``stream`` takes a
``device`` in place of a sharding.

* **Sources.** Two on-disk layouts, auto-detected by `make_dataset`:
  - a directory of ``.npz`` shards (or one ``.npz`` file), each with
    ``latents`` [N, h, w, 4] float and ``tokens`` [N, T] int32 — the
    precomputed-latents artifact;
  - an image folder with a ``captions.txt`` manifest
    (``<filename>\\t<caption>`` per line): images are decoded on the host,
    captions tokenized, and the VAE encode runs on the device inside the
    train step (`ldm_loss` accepts ``images`` instead of ``latents``).
* **Epoch semantics.** `batches(batch, epoch, ...)` visits every example
  exactly once per epoch (minus the final partial batch), with shard order
  AND within-shard order shuffled deterministically from ``(seed, epoch)``
  — reproducible and resumable (the CLI derives the epoch from the
  optimizer step). Shards are loaded one at a time; peak host memory is two
  shards, not the dataset.
"""

from __future__ import annotations

import queue
import threading
from pathlib import Path

import numpy as np


class NpzShardSource:
    """A directory of .npz shards (or a single .npz file) of precomputed
    latents+tokens. Shards may have different sizes; keys: ``latents``
    [N, h, w, c] float, ``tokens`` [N, T] int."""

    kind = "latents"

    def __init__(self, path):
        path = Path(path)
        if path.is_file():
            self.shards = [path]
        else:
            self.shards = sorted(path.glob("*.npz"))
        if not self.shards:
            raise FileNotFoundError(f"no .npz shards under {path}")
        self._sizes = []
        for s in self.shards:
            with np.load(s) as d:
                if "latents" not in d or "tokens" not in d:
                    raise ValueError(
                        f"{s} must contain 'latents' and 'tokens'")
                n = d["latents"].shape[0]
                if d["tokens"].shape[0] != n:
                    raise ValueError(f"{s}: latents/tokens row mismatch")
            self._sizes.append(n)

    def __len__(self) -> int:
        return sum(self._sizes)

    def examples(self, epoch: int, seed: int, shuffle: bool = True):
        """Yield (latents [h,w,c] f32, tokens [T] i32) one example at a time,
        each shard loaded once per epoch."""
        order = np.arange(len(self.shards))
        if shuffle:
            order = np.random.default_rng(
                (seed, epoch, 0xD5)).permutation(order)
        for si in order:
            with np.load(self.shards[si]) as d:
                lat = np.asarray(d["latents"], np.float32)
                tok = np.asarray(d["tokens"], np.int32)
            idx = np.arange(lat.shape[0])
            if shuffle:
                idx = np.random.default_rng(
                    (seed, epoch, int(si))).permutation(idx)
            for i in idx:
                yield {"latents": lat[i], "tokens": tok[i]}


class ImageFolderSource:
    """An image folder with a ``captions.txt`` manifest: one
    ``<filename>\\t<caption>`` per line. Images are center-cropped/resized
    to ``image_size`` and normalized to [-1, 1]; captions are tokenized on
    the host. The VAE encode itself happens on-device in the train step
    (ldm_loss's ``images`` path), so this source never runs the model."""

    kind = "images"

    def __init__(self, path, tokenizer, context_len: int, image_size: int):
        self.root = Path(path)
        manifest = self.root / "captions.txt"
        if not manifest.exists():
            raise FileNotFoundError(f"{manifest} not found")
        self.entries = []
        for line in manifest.read_text(encoding="utf-8").splitlines():
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            name, _, caption = line.partition("\t")
            if not _:
                raise ValueError(
                    f"captions.txt line needs <file>\\t<caption>: {line!r}")
            self.entries.append((name, caption))
        if not self.entries:
            raise ValueError(f"{manifest} lists no examples")
        self.tokenizer = tokenizer
        self.context_len = int(context_len)
        self.image_size = int(image_size)
        # tokenize once (captions are tiny; image decode stays lazy)
        self._tokens = np.asarray(
            [tokenizer.tokenize(c, self.context_len)
             for _, c in self.entries], np.int32)

    def __len__(self) -> int:
        return len(self.entries)

    def _load_image(self, name: str) -> np.ndarray:
        from PIL import Image

        img = Image.open(self.root / name).convert("RGB")
        s = self.image_size
        w, h = img.size
        if (w, h) != (s, s):
            # shortest-side resize + center crop (the SD preprocessing
            # convention)
            scale = s / min(w, h)
            img = img.resize((max(s, round(w * scale)),
                              max(s, round(h * scale))), Image.BICUBIC)
            w, h = img.size
            left, top = (w - s) // 2, (h - s) // 2
            img = img.crop((left, top, left + s, top + s))
        return np.asarray(img, np.float32) / 127.5 - 1.0

    def examples(self, epoch: int, seed: int, shuffle: bool = True):
        idx = np.arange(len(self.entries))
        if shuffle:
            idx = np.random.default_rng((seed, epoch)).permutation(idx)
        for i in idx:
            yield {"images": self._load_image(self.entries[i][0]),
                   "tokens": self._tokens[i]}


def make_dataset(path, tokenizer=None, context_len: int = 77,
                 image_size: int = 512):
    """Auto-detect the source layout under `path`."""
    p = Path(path)
    if p.is_file() and p.suffix == ".npz":
        return NpzShardSource(p)
    if p.is_dir() and (p / "captions.txt").exists():
        if tokenizer is None:
            raise ValueError("image-folder datasets need a tokenizer")
        return ImageFolderSource(p, tokenizer, context_len, image_size)
    if p.is_dir() and list(p.glob("*.npz")):
        return NpzShardSource(p)
    raise FileNotFoundError(
        f"{path}: expected a .npz file, a directory of .npz shards, or an "
        f"image folder with captions.txt")


def batches(source, batch_size: int, epoch: int, seed: int = 0,
            shuffle: bool = True, drop_last: bool = True):
    """Assemble host-side numpy batches for one epoch (batches may span
    shard boundaries; only the final partial batch is dropped)."""
    buf: list[dict] = []
    for ex in source.examples(epoch, seed, shuffle):
        buf.append(ex)
        if len(buf) == batch_size:
            yield {k: np.stack([e[k] for e in buf]) for k in buf[0]}
            buf = []
    if buf and not drop_last:
        yield {k: np.stack([e[k] for e in buf]) for k in buf[0]}


class Prefetcher:
    """Device-staging prefetch: a background thread pulls host batches from
    `it`, copies each array into pinned host memory and onto `device` with
    a ``non_blocking`` copy on a side stream, and keeps up to `depth`
    device-resident batches queued ahead of the consumer, each with an event
    the consumer's stream waits on. With depth>=2 the host IO/decode and
    H2D copy of batch k+1 overlap the device step on batch k. An error in
    the thread is raised to the consumer at the batch where it happened;
    `close()` stops the thread."""

    _DONE = object()

    def __init__(self, it, depth: int = 2, device=None):
        import torch

        self._q: queue.Queue = queue.Queue(maxsize=max(1, int(depth)))
        self._err: Exception | None = None
        self._stop = threading.Event()
        device = torch.device("cpu" if device is None else device)
        cuda = device.type == "cuda"
        side = torch.cuda.Stream(device) if cuda else None

        def put(b):
            host = {k: torch.from_numpy(np.ascontiguousarray(v))
                    for k, v in b.items()}
            if not cuda:
                return host, None
            with torch.cuda.stream(side):
                out = {k: v.pin_memory().to(device, non_blocking=True)
                       for k, v in host.items()}
                done = torch.cuda.Event()
                done.record(side)
            return out, done

        def run():
            try:
                for b in it:
                    if self._stop.is_set():
                        return
                    self._q.put(put(b))
            except Exception as e:  # noqa: BLE001 — re-raised in consumer
                self._err = e
            finally:
                self._q.put(self._DONE)

        self._t = threading.Thread(target=run, daemon=True,
                                   name="sdtpu-torch-prefetch")
        self._t.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._DONE:
            self._q.put(self._DONE)   # a later next() stops again
            if self._err is not None:
                raise self._err
            raise StopIteration
        batch, done = item
        if done is not None:
            import torch

            # the consumer's stream waits for the copies; the allocator
            # learns the tensors are used there
            for v in batch.values():
                stream = torch.cuda.current_stream(v.device)
                stream.wait_event(done)
                v.record_stream(stream)
        return batch

    def close(self, timeout: float = 10.0) -> None:
        """Stop the thread (it finishes the batch it is staging)."""
        self._stop.set()
        while self._t.is_alive():
            try:
                self._q.get(timeout=0.1)
            except queue.Empty:
                pass
            self._t.join(timeout=0.1)
            timeout -= 0.2
            if timeout <= 0:
                break


def stream(source, batch_size: int, seed: int = 0, epochs=None,
           shuffle: bool = True, prefetch: int = 2, device=None,
           start_epoch: int = 0):
    """Epoch-looping batch stream: the one-call input pipeline for the
    train CLI. `epochs=None` streams forever. With `prefetch` > 0, tensors
    staged on `device` by a `Prefetcher`; with 0, host numpy batches."""
    def host_batches():
        epoch = start_epoch
        while epochs is None or epoch < start_epoch + epochs:
            yield from batches(source, batch_size, epoch, seed, shuffle)
            epoch += 1

    if prefetch and prefetch > 0:
        return Prefetcher(host_batches(), depth=prefetch, device=device)
    return host_batches()
