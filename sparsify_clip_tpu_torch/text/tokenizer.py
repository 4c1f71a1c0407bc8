"""CLIP BPE tokenizer (vocab 49408, context 77), ported from
:mod:`sparsify_clip_tpu.text.tokenizer` without the ``regex`` package.

The JAX tokenizer splits text with ``regex`` and the pattern
``<\\|startoftext\\|>|<\\|endoftext\\|>|'s|'t|'re|'ve|'m|'ll|'d|[\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+``
under ``IGNORECASE``.  Here the same split runs on the standard
library's ``re``:

* ``\\p{L}`` and ``\\p{N}`` become explicit classes of the code points
  whose ``unicodedata`` category starts with ``L`` / ``N``.  On every
  code point assigned in the interpreter's Unicode version the two agree
  (``regex`` ships newer tables, so they differ only on code points
  unassigned there).
* ``regex``'s ``\\s`` is ``str.isspace`` less U+001C-U+001F.
* ``IGNORECASE`` applies to the literal alternatives alone; ``re`` folds
  them as ``regex`` does (``'ſ`` matches ``'s``).  On the classes it
  matters once: U+0345 (a combining mark whose case partner is a letter)
  is in none of them, so ``regex`` skips it as it skips whitespace.

Everything else (byte↔unicode map, merges, the double ``html.unescape``
of ``_basic_clean``, context assembly, the vocab resolution order) is
the JAX tokenizer's.  ``tests/test_torch_port_text.py`` holds the ids
equal to the JAX tokenizer's over every assigned code point.
"""

from __future__ import annotations

import functools
import gzip
import html
import os
import re
import sys
import unicodedata
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np

VOCAB_SIZE = 49408
CONTEXT_LENGTH = 77
SOT_TOKEN = "<|startoftext|>"
EOT_TOKEN = "<|endoftext|>"

# in none of the pattern's classes under IGNORECASE (see the module docstring)
_SKIPPED = 0x345


def _is_space(c: str) -> bool:
    """``regex``'s ``\\s``: str.isspace() without U+001C-U+001F."""
    return c.isspace() and not "\x1c" <= c <= "\x1f"


def _ranges(flags: List[bool]) -> str:
    """A character-class body (escaped ranges) of the code points whose
    flag is set."""
    parts, start = [], None
    for cp, inside in enumerate(flags + [False]):
        if inside and start is None:
            start = cp
        elif not inside and start is not None:
            lo, hi = re.escape(chr(start)), re.escape(chr(cp - 1))
            parts.append(lo if start == cp - 1 else f"{lo}-{hi}")
            start = None
    return "".join(parts)


@functools.lru_cache(maxsize=1)
def _classes() -> Tuple[str, str, str]:
    """The class bodies of regex's \\s, \\p{L} and \\p{N}, from one pass
    over every code point."""
    chars = [chr(cp) for cp in range(sys.maxunicode + 1)]
    major = [unicodedata.category(c)[0] for c in chars]
    return (_ranges([_is_space(c) for c in chars]), _ranges([m == "L" for m in major]),
            _ranges([m == "N" for m in major]))


@functools.lru_cache(maxsize=1)
def _pattern() -> "re.Pattern[str]":
    """The pre-tokenizer, built on first use (it scans every code point)."""
    space, letter, number = _classes()
    skipped = re.escape(chr(_SKIPPED))
    return re.compile(
        r"(?i:<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d)"
        rf"|[{letter}]+|[{number}]|[^{space}{letter}{number}{skipped}]+"
    )


def pre_tokenize(text: str) -> List[str]:
    """``regex.findall(_PAT, text)`` of the JAX tokenizer."""
    return _pattern().findall(text)


@functools.lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """Reversible byte → printable-unicode-char map (GPT-2 convention)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word: Tuple[str, ...]) -> set:
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


@functools.lru_cache(maxsize=1)
def _ftfy():
    """``ftfy`` when importable, else None, looked up once: a failed import
    searches ``sys.path`` again on every attempt."""
    try:
        import ftfy  # type: ignore
    except ImportError:
        return None
    return ftfy


def _basic_clean(text: str) -> str:
    # The reference stack runs ftfy.fix_text first; ftfy is optional here.
    ftfy = _ftfy()
    if ftfy is not None:
        text = ftfy.fix_text(text)
    return html.unescape(html.unescape(text)).strip()


def _whitespace_clean(text: str) -> str:
    return re.sub(f"[{_classes()[0]}]+", " ", text).strip()


_DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
REAL_VOCAB_PATH = os.path.join(_DATA_DIR, "bpe_simple_vocab_16e6.txt.gz")
SUBSET_VOCAB_PATH = os.path.join(_DATA_DIR, "coco_en_merges.txt.gz")


def default_bpe_path() -> Optional[str]:
    """Default merges file: ``$CLIP_BPE_PATH`` → the real open_clip
    vocab in ``text/data/`` → the committed subset vocab → ``None``
    (byte-level fallback).  Nothing is downloaded."""
    env = os.environ.get("CLIP_BPE_PATH")
    if env and os.path.exists(env):
        return env
    for path in (REAL_VOCAB_PATH, SUBSET_VOCAB_PATH):
        if os.path.exists(path):
            return path
    return None


def _load_merges(bpe_path: str) -> List[Tuple[str, str]]:
    opener = gzip.open if bpe_path.endswith(".gz") else open
    with opener(bpe_path, "rt", encoding="utf-8") as fh:
        lines = fh.read().split("\n")
    # CLIP convention: skip the header line, keep exactly enough merges
    # to fill a 49,152-entry merged vocab (512 byte-level + merges).
    merges = lines[1 : 49152 - 256 - 2 + 1]
    return [tuple(m.split()) for m in merges if m]


class CLIPTokenizer:
    """CLIP byte-pair encoder.

    Args:
        bpe_path: merges file (gzipped or not).  ``None`` → the
            :func:`default_bpe_path` resolution chain.
        context_length: tokens per sequence (reference: 77).
    """

    backend = "python"

    def __init__(self, bpe_path: Optional[str] = None, context_length: int = CONTEXT_LENGTH):
        self.context_length = context_length
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}

        bpe_path = bpe_path or default_bpe_path()
        if bpe_path and os.path.exists(bpe_path):
            merges = _load_merges(bpe_path)
            self.hermetic = False
            self.vocab_kind = (
                "subset" if os.path.abspath(bpe_path) == SUBSET_VOCAB_PATH else "openai"
            )
        else:
            merges = []
            self.hermetic = True
            self.vocab_kind = "byte-fallback"

        base = list(self.byte_encoder.values())
        vocab: List[str] = base + [v + "</w>" for v in base]
        vocab.extend("".join(m) for m in merges)

        self.encoder: Dict[str, int] = {tok: i for i, tok in enumerate(vocab)}
        # specials pinned at the canonical CLIP ids, so eot == max id (the
        # text tower pools the embedding at argmax(token ids))
        self.sot_id = VOCAB_SIZE - 2
        self.eot_id = VOCAB_SIZE - 1
        self.encoder[SOT_TOKEN] = self.sot_id
        self.encoder[EOT_TOKEN] = self.eot_id
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.bpe_ranks: Dict[Tuple[str, str], int] = {m: i for i, m in enumerate(merges)}
        self.cache: Dict[str, str] = {SOT_TOKEN: SOT_TOKEN, EOT_TOKEN: EOT_TOKEN}
        self.vocab_size = VOCAB_SIZE

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word: Tuple[str, ...] = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"

        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)

        result = " ".join(word)
        self.cache[token] = result
        return result

    def encode(self, text: str) -> List[int]:
        """Text → BPE ids (no specials, no padding)."""
        ids: List[int] = []
        text = _whitespace_clean(_basic_clean(text)).lower()
        for token in pre_tokenize(text):
            token_bytes = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self.bpe(token_bytes).split(" "))
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        text = "".join(
            self.decoder[i]
            for i in ids
            if i in self.decoder and i not in (self.sot_id, self.eot_id)
        )
        raw = bytearray(self.byte_decoder[c] for c in text if c in self.byte_decoder)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")

    def __call__(
        self, texts: Union[str, Sequence[str]], context_length: Optional[int] = None
    ) -> np.ndarray:
        """Tokenize a batch: (B, context_length) int32, zero-padded,
        truncated so position ``context_length-1`` holds ``eot`` when a
        caption overflows (open_clip's truncation convention)."""
        if isinstance(texts, str):
            texts = [texts]
        ctx = context_length or self.context_length
        out = np.zeros((len(texts), ctx), dtype=np.int32)
        for row, text in enumerate(texts):
            ids = [self.sot_id] + self.encode(text) + [self.eot_id]
            if len(ids) > ctx:
                ids = ids[:ctx]
                ids[-1] = self.eot_id
            out[row, : len(ids)] = ids
        return out


@functools.lru_cache(maxsize=4)
def get_tokenizer(model_name: str = "RN50", bpe_path: Optional[str] = None) -> CLIPTokenizer:
    """Parity with ``open_clip.get_tokenizer``: every CLIP-family model
    shares one BPE, so ``model_name`` only mirrors the reference's call
    sites."""
    del model_name
    return CLIPTokenizer(bpe_path=bpe_path)
