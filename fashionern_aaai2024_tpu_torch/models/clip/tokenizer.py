"""CLIP BPE tokenizer of the port (open_clip `SimpleTokenizer` ids).

JAX counterpart: `fashionern_aaai2024_tpu/models/clip/tokenizer.py`. The
same lowercased byte-pair encoding, the same vocabulary order and ids,
the same `[SOT] tokens [EOT]` rows (truncated with the last slot forced
to EOT, zero-padded), given the same merges table. Batches go through
the native core (`native/tokenizer.py`); the rows it flags (HTML
entities, non-ASCII, special-token literals) are encoded here in Python.

Two differences of implementation, none of result:
  * The JAX split is the `regex` pattern
    `<|startoftext|>|<|endoftext|>|'s|'t|'re|'ve|'m|'ll|'d|[\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+`
    (IGNORECASE). Python's `re` has no `\\p{..}`, and the port does not
    depend on `regex`, so `_split` scans the text in the alternation's order
    with `unicodedata` categories: letters are L*, numbers N* (one at a
    time, "²" and "Ⅻ" included), whitespace is `regex`'s `\\s`
    (`_WHITESPACE`: Unicode White_Space, which leaves out U+001C-U+001F
    where `str.isspace` does not), and the rest runs together. Two of
    `regex`'s IGNORECASE matches are kept: U+017F (long s) matches the
    "s" of a literal, and U+0345 (combining ypogegrammeni, which folds to
    a Greek letter) matches no alternative and is skipped. Characters
    that `regex`'s newer Unicode tables assign and Python's
    `unicodedata` does not (Cn here) may split differently.
  * `ftfy.fix_text` is skipped, as the JAX tokenizer skips it without
    ftfy (mojibake repair only; clean captions are unchanged).

A table is found as the JAX package finds one (`default_bpe_path`):
`FASHIONERN_BPE_PATH`, this package's `models/clip/data/`, an installed
open_clip / clip, the HuggingFace cache. Nothing is downloaded. A table
can also be learned offline from captions (`learn_merges`,
`write_bpe_table`, as `tools/make_fixture.py:109` does).
"""

from __future__ import annotations

import functools
import glob
import gzip
import html
import os
import re
import unicodedata
from collections import Counter
from typing import Iterable, Sequence

import numpy as np

from fashionern_aaai2024_tpu_torch.native.tokenizer import NativeBPE

SOT_TEXT = "<|startoftext|>"
EOT_TEXT = "<|endoftext|>"
BPE_FILENAME = "bpe_simple_vocab_16e6.txt.gz"

# the split's literal alternatives, in the pattern's order
_LITERALS = (SOT_TEXT, EOT_TEXT, "'s", "'t", "'re", "'ve", "'m", "'ll", "'d")
# what a literal's character matches under `regex`'s IGNORECASE
_FOLDS = {c: c + c.upper() for c in "abcdefghijklmnopqrstuvwxyz"}
_FOLDS["s"] += "\u017f"
# `regex`'s \s on str patterns: the Unicode White_Space characters
_WHITESPACE = frozenset("\t\n\x0b\x0c\r \x85\xa0\u1680\u2028\u2029\u202f\u205f\u3000"
                        + "".join(map(chr, range(0x2000, 0x200b))))
_WHITESPACE_RUN = re.compile("[" + "".join(sorted(_WHITESPACE)) + "]+")
_NO_MATCH = "\u0345"


@functools.lru_cache()
def bytes_to_unicode() -> dict[int, str]:
    """Reversible byte <-> printable-unicode map (GPT-2 / CLIP scheme)."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word: tuple[str, ...]) -> set[tuple[str, str]]:
    return set(zip(word[:-1], word[1:]))


def basic_clean(text: str) -> str:
    return html.unescape(html.unescape(text)).strip()


def whitespace_clean(text: str) -> str:
    return _WHITESPACE_RUN.sub(" ", text).strip()


def _kind(c: str) -> str:
    """'L' letter, 'N' number, ' ' whitespace or U+0345 (matched by no
    alternative), '.' anything else."""
    if c in _WHITESPACE or c == _NO_MATCH:
        return " "
    cat = unicodedata.category(c)[0]
    return cat if cat in "LN" else "."


def _literal_at(text: str, i: int) -> str | None:
    for lit in _LITERALS:
        if len(text) - i >= len(lit) and all(
                text[i + j] in _FOLDS.get(ch, ch) for j, ch in enumerate(lit)):
            return text[i:i + len(lit)]
    return None


def _split(text: str) -> list[str]:
    """`re.findall` of the CLIP pattern (module docstring), exactly."""
    out: list[str] = []
    i, n = 0, len(text)
    while i < n:
        lit = _literal_at(text, i)
        if lit is not None:
            out.append(lit)
            i += len(lit)
            continue
        kind = _kind(text[i])
        if kind == " ":
            i += 1
            continue
        j = i + 1
        if kind != "N":  # a letter run or a run of the rest
            while j < n and _kind(text[j]) == kind:
                j += 1
        out.append(text[i:j])
        i = j
    return out


def default_bpe_path() -> str | None:
    """The CLIP merges table, searched in order:

    1. the `FASHIONERN_BPE_PATH` environment variable;
    2. this package's data dir (`models/clip/data/`) and beside this module;
    3. an installed `open_clip` / `clip` package (both vendor the file);
    4. the HuggingFace hub cache (any snapshot holding the file)."""
    p = os.environ.get("FASHIONERN_BPE_PATH")
    if p and os.path.exists(p):
        return p
    here = os.path.dirname(__file__)
    for cand in (os.path.join(here, "data", BPE_FILENAME), os.path.join(here, BPE_FILENAME)):
        if os.path.exists(cand):
            return cand
    for pkg in ("open_clip", "clip"):
        try:
            mod = __import__(pkg)
        except ImportError:
            continue
        cand = os.path.join(os.path.dirname(mod.__file__ or ""), BPE_FILENAME)
        if os.path.exists(cand):
            return cand
    hf_home = os.environ.get("HF_HOME", os.path.expanduser("~/.cache/huggingface"))
    hits = glob.glob(os.path.join(hf_home, "hub", "**", BPE_FILENAME), recursive=True)
    return hits[0] if hits else None


def read_merges(bpe_path: str) -> list[tuple[str, str]]:
    """The merges CLIP uses from a table: lines 1 .. 49152-256-2."""
    opener = gzip.open if bpe_path.endswith(".gz") else open
    with opener(bpe_path, "rt", encoding="utf-8") as f:
        lines = f.read().split("\n")
    merges = [tuple(line.split()) for line in lines[1:49152 - 256 - 2 + 1]]
    return [m for m in merges if len(m) == 2]


def learn_merges(captions: Iterable[str], n_merges: int) -> list[tuple[str, str]]:
    """A valid merges table learned from captions: `n_merges` times, the
    most frequent adjacent pair of the lowercased whitespace-split words
    (ties to the larger pair) is merged (`tools/make_fixture.py:109`)."""
    b2u = bytes_to_unicode()
    words: Counter = Counter()
    for line in captions:
        for w in line.lower().split():
            enc = "".join(b2u[b] for b in w.encode("utf-8"))
            words[tuple(enc[:-1]) + (enc[-1] + "</w>",)] += 1
    merges: list[tuple[str, str]] = []
    for _ in range(n_merges):
        pairs: Counter = Counter()
        for word, freq in words.items():
            for a, b in zip(word[:-1], word[1:]):
                pairs[(a, b)] += freq
        if not pairs:
            break
        best = max(pairs, key=lambda p: (pairs[p], p))
        merges.append(best)
        merged: Counter = Counter()
        for word, freq in words.items():
            out, i = [], 0
            while i < len(word):
                if i < len(word) - 1 and (word[i], word[i + 1]) == best:
                    out.append(word[i] + word[i + 1])
                    i += 2
                else:
                    out.append(word[i])
                    i += 1
            merged[tuple(out)] += freq
        words = merged
    return merges


def write_bpe_table(root: str, captions: Iterable[str], n_merges: int = 64) -> str:
    """`learn_merges` written as `<root>/bpe.txt.gz` in the table format
    (a header line, then one merge a line); returns the path."""
    merges = learn_merges(captions, n_merges)
    path = os.path.join(root, "bpe.txt.gz")
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("synthetic fixture merges\n")
        f.write("\n".join(" ".join(m) for m in merges))
    return path


class SimpleTokenizer:
    """Batch tokenizer: `tok(texts, context_length)` -> int32 [B, L]."""

    def __init__(self, bpe_path: str | None = None,
                 merges: Sequence[tuple[str, str]] | None = None):
        if merges is None:
            bpe_path = bpe_path or default_bpe_path()
            if bpe_path is None:
                raise FileNotFoundError(
                    f"no BPE merges table found: pass bpe_path= (a copy of {BPE_FILENAME} or "
                    "a table from write_bpe_table), pass merges=, or set FASHIONERN_BPE_PATH")
            merges = read_merges(bpe_path)
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        vocab.extend("".join(m) for m in merges)
        vocab.extend([SOT_TEXT, EOT_TEXT])
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.bpe_ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.cache = {SOT_TEXT: SOT_TEXT, EOT_TEXT: EOT_TEXT}
        self._merges = [tuple(m) for m in merges]
        self._native: NativeBPE | None = None

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    @property
    def sot_token(self) -> int:
        return self.encoder[SOT_TEXT]

    @property
    def eot_token(self) -> int:
        return self.encoder[EOT_TEXT]

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: list[str] = []
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
            pairs = _get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> list[int]:
        tokens: list[int] = []
        for token in _split(whitespace_clean(basic_clean(text)).lower()):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            tokens.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return tokens

    def decode(self, tokens: Iterable[int]) -> str:
        text = "".join(self.decoder[int(t)] for t in tokens)
        return (bytearray(self.byte_decoder[c] for c in text)
                .decode("utf-8", errors="replace").replace("</w>", " "))

    def _row(self, text: str, context_length: int) -> list[int]:
        tokens = [self.sot_token] + self.encode(text) + [self.eot_token]
        if len(tokens) > context_length:
            tokens = tokens[:context_length]
            tokens[-1] = self.eot_token
        return tokens

    def python_ids(self, texts: str | Sequence[str], context_length: int = 77) -> np.ndarray:
        """`__call__` with every row encoded in Python (no native core)."""
        texts = [texts] if isinstance(texts, str) else list(texts)
        result = np.zeros((len(texts), context_length), dtype=np.int32)
        for i, text in enumerate(texts):
            row = self._row(text, context_length)
            result[i, :len(row)] = row
        return result

    def _core(self) -> NativeBPE:
        if self._native is None:
            native = NativeBPE(self._merges)
            if (native.sot_token, native.eot_token) != (self.sot_token, self.eot_token):
                raise RuntimeError("the native tokenizer's vocabulary does not line up with "
                                   "the Python encoder's")
            self._native = native
        return self._native

    def __call__(self, texts: str | Sequence[str], context_length: int = 77) -> np.ndarray:
        """Batch-tokenize as `open_clip.get_tokenizer(...)(texts, 77)` does:
        [SOT] tokens [EOT], truncated with the last slot forced to EOT,
        zero-padded. Returns int32 [B, context_length]."""
        texts = [texts] if isinstance(texts, str) else list(texts)
        result, fallback = self._core().encode_batch(texts, context_length)
        for i in np.flatnonzero(fallback):
            row = self._row(texts[i], context_length)
            result[i, :] = 0
            result[i, :len(row)] = row
        return result


@functools.lru_cache()
def _default_tokenizer() -> SimpleTokenizer:
    return SimpleTokenizer()


def tokenize(texts: str | Sequence[str], context_length: int = 77) -> np.ndarray:
    """Tokenize with the table `default_bpe_path` finds (FileNotFoundError
    at the first call when there is none)."""
    return _default_tokenizer()(texts, context_length)
