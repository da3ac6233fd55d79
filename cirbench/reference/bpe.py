"""CLIP's byte-pair tokenizer in plain Python: the benchmark's reference
for the caption ids.

OpenAI CLIP `clip/simple_tokenizer.py`: the vocabulary is the 256 byte
symbols of `bytes_to_unicode`, the same with the word-end mark `</w>`,
one symbol per merge, then `<|startoftext|>` and `<|endoftext|>`; a word
is split into byte symbols (its last one marked), and the lowest-ranked
adjacent pair is merged until none is in the table. A row is
[SOT] ids [EOT], truncated with its last slot EOT, zero-padded.

The benchmark's captions are lowercase ASCII words separated by single
spaces, so the text clean-up and the split of CLIP's pattern reduce to
`str.split` here; `encode` refuses any other caption.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def bytes_to_unicode() -> dict[int, str]:
    """CLIP's reversible map of the 256 bytes onto printable characters."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


class BPE:
    def __init__(self, merges: Sequence[tuple[str, str]]):
        symbols = list(bytes_to_unicode().values())
        vocab = symbols + [s + "</w>" for s in symbols] + ["".join(m) for m in merges]
        vocab += ["<|startoftext|>", "<|endoftext|>"]
        self.ids = {s: i for i, s in enumerate(vocab)}
        self.ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.sot, self.eot = len(vocab) - 2, len(vocab) - 1
        self.byte_map = bytes_to_unicode()

    def word(self, word: str) -> list[str]:
        parts = [self.byte_map[b] for b in word.encode("utf-8")]
        parts[-1] += "</w>"
        while len(parts) > 1:
            pairs = [(self.ranks.get((a, b), float("inf")), i)
                     for i, (a, b) in enumerate(zip(parts[:-1], parts[1:]))]
            rank, _ = min(pairs)
            if rank == float("inf"):
                break
            first, second = next((a, b) for a, b in zip(parts[:-1], parts[1:])
                                 if self.ranks.get((a, b)) == rank)
            merged, i = [], 0
            while i < len(parts):
                if i + 1 < len(parts) and (parts[i], parts[i + 1]) == (first, second):
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(parts[i])
                    i += 1
            parts = merged
        return parts

    def encode(self, caption: str) -> list[int]:
        words = caption.split(" ")
        if not all(w.isascii() and w.isalpha() and w.islower() for w in words):
            raise ValueError(f"not a caption of lowercase ASCII words: {caption!r}")
        return [self.ids[s] for w in words for s in self.word(w)]

    def rows(self, captions: Sequence[str], context_length: int) -> np.ndarray:
        out = np.zeros((len(captions), context_length), dtype=np.int64)
        for i, caption in enumerate(captions):
            row = [self.sot, *self.encode(caption), self.eot]
            if len(row) > context_length:
                row = row[:context_length]
                row[-1] = self.eot
            out[i, :len(row)] = row
        return out
