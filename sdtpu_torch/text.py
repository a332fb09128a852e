"""Prompt attention syntax, long-prompt chunking and prompt scheduling.

Carried over from ``sdtpu/text.py`` (the JAX package): pure host code,
with no JAX in it, copied because importing any ``sdtpu`` module imports
JAX. ``tests/test_torch_serving.py`` pins it against the original.

* Attention weighting (the A1111 grammar): ``(text)`` multiplies the
  enclosed tokens' influence by 1.1, ``[text]`` by 1/1.1, ``(text:1.5)``
  sets an explicit factor; parentheses nest multiplicatively; ``\\(``
  escapes a literal bracket. Weights scale the encoded token embeddings,
  then the per-sample embedding mean is restored to its pre-weighting value
  (``engine.pipeline.encode_text``).
* Long prompts: token streams beyond the window are split into chunks of
  ``context_len - 2``, each wrapped in sot/eot and encoded through CLIP
  separately; the hidden states concatenate into one long cross-attention
  context. A batch pads every prompt to the same chunk count with empty
  (eot-filled) chunks.
* Prompt scheduling (``[from:to:when]``, ``[a|b]``): ``Context.generate``
  resolves the prompt at every step (``schedule_table``) and conditions
  each step on its variant (``engine.pipeline.generate(..., sched_idx=)``).
"""

from __future__ import annotations

import re

import numpy as np

_ATTN_RE = re.compile(r"""
\\\(|\\\)|\\\[|\\\]|\\\\   # escaped bracket or backslash -> literal
|\(|\[                     # open round / square
|:\s*([+-]?[\d.]+)\s*\)    # :number) explicit-weight close
|\)|\]                     # plain close
|[^\\()\[\]:]+             # plain text run
|:                         # lone colon (literal)
""", re.X)

_ROUND_UP = 1.1
_SQUARE_DOWN = 1.0 / 1.1


def parse_weighted(text: str) -> list[tuple[str, float]]:
    """Prompt with attention syntax -> [(fragment, weight)], in order.

    Unbalanced closers are literal; unclosed openers apply to the rest of
    the prompt. Adjacent fragments with equal weights merge.
    """
    res: list[list] = []          # [text, weight]
    round_stack: list[int] = []   # index into res where each '(' opened
    square_stack: list[int] = []

    def scale(start: int, mult: float):
        for item in res[start:]:
            item[1] *= mult

    for m in _ATTN_RE.finditer(text):
        tok = m.group(0)
        if tok.startswith("\\"):
            res.append([tok[1:], 1.0])
        elif tok == "(":
            round_stack.append(len(res))
        elif tok == "[":
            square_stack.append(len(res))
        elif m.group(1) is not None and round_stack:   # ":w)"
            scale(round_stack.pop(), float(m.group(1)))
        elif tok == ")" and round_stack:
            scale(round_stack.pop(), _ROUND_UP)
        elif tok == "]" and square_stack:
            scale(square_stack.pop(), _SQUARE_DOWN)
        elif m.group(1) is not None:                   # ":w)" w/o opener
            res.append([tok, 1.0])
        else:
            res.append([tok, 1.0])
    # unclosed openers: weight the remainder as if closed at the end
    for start in round_stack:
        scale(start, _ROUND_UP)
    for start in square_stack:
        scale(start, _SQUARE_DOWN)
    # merge adjacent equal-weight fragments
    out: list[tuple[str, float]] = []
    for text_, w in res:
        if out and out[-1][1] == w:
            out[-1] = (out[-1][0] + text_, w)
        else:
            out.append((text_, w))
    return out or [("", 1.0)]


def has_attention_syntax(text: str) -> bool:
    """Cheap pre-check: does parsing change anything vs the raw string?"""
    frags = parse_weighted(text)
    return len(frags) > 1 or frags[0][1] != 1.0 or frags[0][0] != text


def chunked_tokens(tokenizer, text: str, context_len: int,
                   min_chunks: int = 1):
    """-> (tokens [k, context_len] int32, weights [k, context_len] f32).

    Fragments are BPE-encoded individually (fragment boundaries are token
    boundaries, as in the standard implementation); the id stream splits
    into chunks of ``context_len - 2``, each wrapped sot/eot and eot-padded.
    Specials and padding carry weight 1.0. ``min_chunks`` pads with empty
    chunks (batch members must agree on k)."""
    ids: list[int] = []
    ws: list[float] = []
    for frag, w in parse_weighted(text):
        frag_ids = tokenizer.encode(frag)
        ids.extend(frag_ids)
        ws.extend([w] * len(frag_ids))

    body = context_len - 2
    n_chunks = max(min_chunks, (len(ids) + body - 1) // body, 1)
    toks = np.full((n_chunks, context_len), tokenizer.eot, np.int32)
    wout = np.ones((n_chunks, context_len), np.float32)
    toks[:, 0] = tokenizer.sot
    for c in range(n_chunks):
        part = ids[c * body: (c + 1) * body]
        toks[c, 1: 1 + len(part)] = part
        wout[c, 1: 1 + len(part)] = ws[c * body: (c + 1) * body]
    return toks, wout


def strip_syntax(text: str) -> str:
    """Remove attention syntax, keeping the plain text (the form the
    tokenizer should see when no weighting/chunking machinery is needed —
    e.g. ``(x:1.0)`` -> ``x``, ``\\(lit\\)`` -> ``(lit)``)."""
    return "".join(f for f, _ in parse_weighted(text))


def needs_chunking(tokenizer, text: str, context_len: int) -> bool:
    """True when `text` overflows one window or carries non-unit weights —
    i.e. the chunked encode path is required (otherwise the legacy
    single-window path stays bit-identical)."""
    frags = parse_weighted(text)
    if any(w != 1.0 for _, w in frags):
        return True
    n = sum(len(tokenizer.encode(f)) for f, _ in frags)
    return n > context_len - 2


# -- prompt scheduling (A1111 "prompt editing") ---------------------------
#
# ``[from:to:when]`` switches the prompt text mid-trajectory (when < 1:
# fraction of steps; when >= 1: absolute step), ``[to:when]`` starts empty,
# ``[from::when]`` ends empty, ``[a|b|c]`` alternates per step. Plain
# ``[x]`` (attention-down) is untouched. Constructs resolve innermost-first,
# so nesting works. Host-side: the engine resolves the prompt once per
# step index, dedupes the variants, and feeds its loop a per-step variant
# index (``schedule_table``).

_SCHED_RE = re.compile(r"\[([^\[\]]*)\]")
_PROT_OPEN, _PROT_CLOSE = "\x00", "\x01"


def _split_top_colons(s: str) -> list[str]:
    """Split on colons OUTSIDE parentheses (attention syntax like
    ``(x:1.3)`` keeps its colon)."""
    parts, cur, depth = [], [], 0
    for ch in s:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth = max(0, depth - 1)
        if ch == ":" and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    parts.append("".join(cur))
    return parts


def _resolve_pass(text: str, i: int, steps: int) -> str:
    def repl(m):
        c = m.group(1)
        if "|" in c:
            opts = c.split("|")
            return opts[i % len(opts)]
        cols = _split_top_colons(c)
        if len(cols) >= 2:
            try:
                w = float(cols[-1])
            except ValueError:
                # attention-down bracket with a literal colon: protect
                return _PROT_OPEN + c + _PROT_CLOSE
            switch = int(round(w * steps)) if w < 1.0 else int(w)
            if len(cols) == 2:
                frm, to = "", cols[0]  # [to:when]
            else:
                frm, to = cols[0], ":".join(cols[1:-1])
            return to if i >= switch else frm
        return _PROT_OPEN + c + _PROT_CLOSE  # plain attention bracket

    return _SCHED_RE.sub(repl, text)


def schedule_at(text: str, i: int, steps: int) -> str:
    """Resolve every scheduling construct for step index `i` (0-based)."""
    s = text
    while True:
        prev = s
        s = _resolve_pass(s, i, steps)
        if s == prev:
            break
    return s.replace(_PROT_OPEN, "[").replace(_PROT_CLOSE, "]")


def has_schedule(text: str, steps: int) -> bool:
    """True if the prompt contains any scheduling construct: resolving it
    changes the text (plain attention brackets resolve to themselves)."""
    return schedule_at(text, 0, steps) != text


def schedule_table(prompts: list[str], steps: int):
    """-> (variants, idx): ``variants`` is the deduped list of resolved
    prompt ROWS (one string per batch member per variant), ``idx`` a
    [steps] int array mapping each step to its variant row — one encode
    table serves the whole batch."""
    variants: list[list[str]] = []
    seen: dict[tuple, int] = {}
    idx = np.zeros(steps, np.int32)
    for i in range(steps):
        row = tuple(schedule_at(p, i, steps) for p in prompts)
        v = seen.get(row)
        if v is None:
            v = len(variants)
            seen[row] = v
            variants.append(list(row))
        idx[i] = v
    return variants, idx
