"""CLIP BPE tokenizer — pure Python, numerically identical token ids to CLIP.

Carried over unchanged from ``sdtpu/tokenizer.py`` (the JAX package), plus
``DEMO_MERGES`` from ``sdtpu/engine/context.py``: the port cannot import
them, because any ``import sdtpu.*`` imports JAX.

Host-side component of the pipeline (the reference implements this in C++:
csrc/libsdod/src/tokenizer.{h,cpp}). Design goals, matching the reference's
behavior (reference: tokenizer.cpp:228-369):

* loads a single flat ``ctokenizer.txt`` asset: lines WITHOUT a space are
  vocab tokens (in id order), lines WITH a space are merge pairs (in rank
  order); ``<|startoftext|>`` / ``<|endoftext|>`` are appended at the end
  (reference: tokenizer.cpp:228-255);
* ``tokenize(text, context_len=77)`` returns exactly ``context_len`` ids:
  ``[sot, ...bpe ids..., eot, eot, ...]`` padded with the end token
  (reference: tokenizer.cpp:274-275 pads with end_token — this also matches
  Stable Diffusion's HF usage where pad_token == <|endoftext|>);
* text sanitation = whitespace collapse + lowercase, UTF-8 aware
  (reference: tokenizer.cpp:55-108);
* pre-tokenization implements CLIP's regex
  ``'s|'t|'re|'ve|'m|'ll|'d|\\p{L}+|\\p{N}|[^\\s\\p{L}\\p{N}]+``
  as a hand-rolled scanner (reference: tokenizer.cpp:113-222 does the same
  as a state machine); note ``\\p{N}`` matches a SINGLE numeric char;
* GPT-2/CLIP ``bytes_to_unicode`` byte remap (reference: tokenizer.cpp:22-53);
* greedy lowest-rank BPE merge loop (reference: tokenizer.cpp:279-369).

No torch / regex / transformers imports — host math only.
"""

from __future__ import annotations

import gzip
import html
import unicodedata
from functools import lru_cache
from pathlib import Path
from typing import Iterable, Iterator, Sequence

SOT_TEXT = "<|startoftext|>"
EOT_TEXT = "<|endoftext|>"
CONTEXT_LEN = 77

#: Merge table for the built-in demo tokenizer (random-init weights mode).
#: Sized so TINY.clip.vocab_size == 512 + len(DEMO_MERGES) + 2.
DEMO_MERGES = [
    ("t", "h"), ("th", "e</w>"), ("a", "n"), ("i", "n"), ("in", "g</w>"),
    ("e", "r</w>"), ("an", "d</w>"), ("o", "f</w>"), ("r", "i"), ("ri", "d"),
    ("rid", "ing</w>"), ("h", "o"), ("ho", "r"), ("hor", "s"),
    ("hors", "e</w>"), ("o", "n</w>"), ("a", "s"), ("as", "t"), ("o", "n"),
    ("p", "h"), ("ph", "o"), ("g", "raph</w>"),
]


@lru_cache()
def bytes_to_unicode() -> dict[int, str]:
    """GPT-2/CLIP reversible byte -> unicode-char map.

    Printable bytes map to themselves; the rest are displaced to 256+i so
    every byte has a dedicated printable codepoint.
    """
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


def whitespace_clean(text: str) -> str:
    return " ".join(text.split())


def _is_letter(ch: str) -> bool:
    return unicodedata.category(ch).startswith("L")


def _is_number(ch: str) -> bool:
    return unicodedata.category(ch).startswith("N")


def _is_space(ch: str) -> bool:
    # \s in the `regex` module: unicode whitespace.
    return ch.isspace()


_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")


def pretokenize(text: str) -> Iterator[str]:
    """Scan `text` into CLIP pre-tokens.

    Equivalent to findall of CLIP's pattern
    ``'s|'t|'re|'ve|'m|'ll|'d|[\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+``
    (the special tokens are handled by the caller, not here). Alternation is
    ordered: at each position, contractions are tried first, then a letter
    run, then a single numeric char, then an "other" (non-space/letter/num)
    run.
    """
    i, n = 0, len(text)
    while i < n:
        ch = text[i]
        if _is_space(ch):
            i += 1
            continue
        if ch == "'":
            rest = text[i + 1 : i + 3].lower()
            matched = None
            for c in _CONTRACTIONS:
                suf = c[1:]
                if rest.startswith(suf):
                    matched = c
                    break
            if matched is not None:
                yield text[i : i + len(matched)]
                i += len(matched)
                continue
        if _is_letter(ch):
            j = i + 1
            while j < n and _is_letter(text[j]):
                j += 1
            yield text[i:j]
            i = j
            continue
        if _is_number(ch):
            yield ch
            i += 1
            continue
        # "other" run: chars that are not space/letter/number. CLIP's regex
        # alternation only tries contractions at the MATCH START, so an
        # apostrophe inside a punctuation run is consumed greedily even when
        # a contraction suffix follows ("!!'s" -> ["!!'", "s"], not
        # ["!!", "'s"]).
        j = i
        while j < n:
            cj = text[j]
            if _is_space(cj) or _is_letter(cj) or _is_number(cj):
                break
            j += 1
        yield text[i:j]
        i = j


class Tokenizer:
    """CLIP BPE tokenizer over a merged flat vocab file or explicit tables."""

    def __init__(
        self,
        vocab: Sequence[str],
        merges: Sequence[tuple[str, str]],
    ):
        self.encoder: dict[str, int] = {tok: i for i, tok in enumerate(vocab)}
        self.decoder: dict[int, str] = dict(enumerate(vocab))
        self.bpe_ranks: dict[tuple[str, str], int] = {
            pair: i for i, pair in enumerate(merges)
        }
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        if SOT_TEXT not in self.encoder or EOT_TEXT not in self.encoder:
            raise ValueError("vocab must contain <|startoftext|>/<|endoftext|>")
        self.sot = self.encoder[SOT_TEXT]
        self.eot = self.encoder[EOT_TEXT]
        self._bpe_cache: dict[str, list[str]] = {}
        # textual-inversion placeholders: normalized word -> id sequence
        # (ids point past the BPE vocab, into rows appended to the CLIP
        # embedding table by Context.load_embedding)
        self._added: dict[str, list[int]] = {}

    # -- constructors --------------------------------------------------

    @classmethod
    def from_flat_file(cls, path: str | Path) -> "Tokenizer":
        """Load the single-file asset (reference format, tokenizer.cpp:228-255).

        Lines without a space: vocab entries, in id order. Lines with a
        space: merge pairs, in rank order (each pair's concatenation is also
        a vocab entry, appended in rank order after the base entries).
        The two special tokens are appended last.
        """
        vocab: list[str] = []
        merges: list[tuple[str, str]] = []
        text = Path(path).read_text(encoding="utf-8")
        for line in text.split("\n"):
            if not line:
                continue
            if " " in line:
                a, b = line.split(" ")
                merges.append((a, b))
                vocab.append(a + b)
            else:
                vocab.append(line)
        vocab.append(SOT_TEXT)
        vocab.append(EOT_TEXT)
        return cls(vocab, merges)

    @classmethod
    def from_merges(cls, merges: Sequence[tuple[str, str]]) -> "Tokenizer":
        """Build the CLIP vocab from a merge list (the openai construction):
        256 byte chars, then each + ``</w>``, then one entry per merge,
        then the 2 special tokens.
        """
        base = list(bytes_to_unicode().values())
        vocab = base + [c + "</w>" for c in base]
        vocab.extend(a + b for a, b in merges)
        vocab.append(SOT_TEXT)
        vocab.append(EOT_TEXT)
        return cls(vocab, merges)

    @classmethod
    def from_openai_gz(cls, path: str | Path) -> "Tokenizer":
        """Build directly from CLIP's ``bpe_simple_vocab_16e6.txt.gz``."""
        with gzip.open(path, "rt", encoding="utf-8") as f:
            lines = f.read().split("\n")
        # Same slice the openai simple_tokenizer uses: skip header line,
        # take exactly 49152-256-2 merges.
        merge_lines = lines[1 : 49152 - 256 - 2 + 1]
        merges = [tuple(l.split()) for l in merge_lines]
        return cls.from_merges(merges)  # type: ignore[arg-type]

    @classmethod
    def from_hf_files(cls, vocab_json: str | Path, merges_txt: str | Path) -> "Tokenizer":
        """Build from HuggingFace-style vocab.json + merges.txt."""
        import json

        enc = json.loads(Path(vocab_json).read_text(encoding="utf-8"))
        vocab = [None] * len(enc)
        for tok, i in enc.items():
            vocab[i] = tok
        lines = Path(merges_txt).read_text(encoding="utf-8").split("\n")
        merges = []
        for l in lines:
            if not l or l.startswith("#version"):
                continue
            parts = l.split()
            if len(parts) == 2:
                merges.append((parts[0], parts[1]))
        return cls(vocab, merges)  # type: ignore[arg-type]

    # -- core ------------------------------------------------------------

    def bpe(self, token: str) -> list[str]:
        """Greedy lowest-rank merge of one pre-token (already byte-remapped)."""
        cached = self._bpe_cache.get(token)
        if cached is not None:
            return cached
        word: list[str] = list(token[:-1]) + [token[-1] + "</w>"]
        if len(word) == 1:
            self._bpe_cache[token] = word
            return word
        ranks = self.bpe_ranks
        while len(word) > 1:
            best_rank = None
            best_i = -1
            for i in range(len(word) - 1):
                r = ranks.get((word[i], word[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank = r
                    best_i = i
            if best_rank is None:
                break
            # merge ALL occurrences of the best pair, left to right
            a, b = word[best_i], word[best_i + 1]
            out: list[str] = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == a and word[i + 1] == b:
                    out.append(a + b)
                    i += 2
                else:
                    out.append(word[i])
                    i += 1
            word = out
        self._bpe_cache[token] = word
        return word

    def add_placeholder(self, word: str, ids: Sequence[int]) -> None:
        """Register a textual-inversion placeholder: the standalone `word`
        (whitespace-free, matched case-insensitively after prompt
        normalization) encodes to the given id sequence instead of BPE.
        The ids index rows APPENDED to the CLIP embedding table — the
        tokenizer itself never emits them otherwise."""
        key = whitespace_clean(html.unescape(html.unescape(word))).lower()
        if not key or " " in key:
            raise ValueError(
                f"placeholder must be one whitespace-free word, got {word!r}")
        self._added[key] = list(ids)

    def encode(self, text: str) -> list[int]:
        """Text -> BPE ids (no special tokens, no padding). Registered
        textual-inversion placeholders match as standalone words."""
        text = whitespace_clean(html.unescape(html.unescape(text))).lower()
        if self._added and any(w in self._added for w in text.split(" ")):
            ids: list[int] = []
            for word in text.split(" "):
                hit = self._added.get(word)
                if hit is not None:
                    ids.extend(hit)
                else:
                    ids.extend(self._encode_clean(word))
            return ids
        return self._encode_clean(text)

    def _encode_clean(self, text: str) -> list[int]:
        """BPE-encode already-normalized text."""
        ids: list[int] = []
        be = self.byte_encoder
        for tok in pretokenize(text):
            remapped = "".join(be[b] for b in tok.encode("utf-8"))
            for piece in self.bpe(remapped):
                ids.append(self.encoder[piece])
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        text = "".join(self.decoder[i] for i in ids)
        raw = bytearray(self.byte_decoder[c] for c in text if c in self.byte_decoder)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")

    def tokenize(self, text: str, context_len: int = CONTEXT_LEN) -> list[int]:
        """Full prompt encoding: sot + ids (truncated) + eot, eot-padded to
        `context_len` (reference: tokenizer.h:24, tokenizer.cpp:274-275)."""
        ids = self.encode(text)[: context_len - 2]
        out = [self.sot] + ids + [self.eot]
        out.extend([self.eot] * (context_len - len(out)))
        return out

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)
