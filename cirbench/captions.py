"""Seeded FashionIQ-shaped captions and the BPE merges table both sides read.

A FashionIQ query carries two relative captions written by annotators
("is darker and longer", "has a floral print"), which the reference
joins with " and ". The generator draws two modifier phrases from the
word lists below and joins them so that the row has a chosen number of
BPE tokens (SOT and EOT included), drawn uniformly from `lengths`.

No CLIP table is in the repository, so the benchmark makes its own
merges table from the word lists: each word's byte symbols merged left
to right until the word is one symbol (words that share a prefix share
its merges; a merge made for one word may split another differently, as
in any BPE table). The program's tokenizer and the reference's
(`reference/bpe.py`) both read this table.
"""

from __future__ import annotations

import random

from cirbench.reference.bpe import BPE, bytes_to_unicode

VERBS = ["is", "has", "looks", "becomes", "shows", "features", "wears", "uses"]
DEGREES = ["more", "less", "much", "slightly", "very", "a", "bit", "darker", "lighter",
           "brighter", "longer", "shorter", "looser", "tighter", "simpler", "fancier"]
COLOURS = ["red", "blue", "black", "white", "green", "yellow", "pink", "purple", "grey",
           "brown", "beige", "navy", "orange", "maroon", "teal", "gold", "silver", "cream"]
GARMENTS = ["dress", "shirt", "top", "tee", "blouse", "skirt", "sleeves", "collar", "neckline",
            "hem", "print", "pattern", "pocket", "buttons", "straps", "waist", "graphic",
            "logo", "stripes", "lace", "ruffles", "belt", "hood", "zipper"]
MATERIALS = ["cotton", "silk", "denim", "satin", "lace", "knit", "leather", "linen",
             "chiffon", "velvet", "floral", "plaid", "solid", "sheer", "casual", "formal",
             "elegant", "sporty", "vintage", "modern", "shiny", "matte", "fitted", "flowy"]
LINKS = ["with", "and", "no", "without", "instead", "of", "on", "the", "in", "at", "front",
         "back", "short", "long"]
WORDS = sorted({w for ws in (VERBS, DEGREES, COLOURS, GARMENTS, MATERIALS, LINKS) for w in ws})
POOLS = (DEGREES, COLOURS, GARMENTS, MATERIALS, LINKS)


def merges(words=WORDS) -> list[tuple[str, str]]:
    """Each word's symbols merged left to right into one, in word order,
    each merge once."""
    byte_map = bytes_to_unicode()
    out: list[tuple[str, str]] = []
    seen = set()
    for w in words:
        parts = [byte_map[b] for b in w.encode("utf-8")]
        parts[-1] += "</w>"
        acc = parts[0]
        for p in parts[1:]:
            if (acc, p) not in seen:
                seen.add((acc, p))
                out.append((acc, p))
            acc += p
    return out


def captions(n: int, seed: int, lengths: tuple[int, int], bpe: BPE) -> list[str]:
    """n captions, each "<phrase> and <phrase>", whose rows have a token
    count drawn uniformly from [lengths[0], lengths[1]], SOT and EOT
    included."""
    rng = random.Random(f"cirbench-captions:{seed}")
    lo, hi = lengths
    size = {w: len(bpe.word(w)) for w in WORDS}
    out = []
    for _ in range(n):
        target = rng.randint(lo, hi)
        while True:
            phrases = [[rng.choice(VERBS)], [rng.choice(VERBS)]]
            # SOT, EOT, "and", the two verbs
            count = 2 + sum(size[w] for w in ("and", *phrases[0], *phrases[1]))
            if count <= target:
                break
        while count < target:
            word = rng.choice(rng.choice(POOLS))
            if count + size[word] > target:
                continue
            rng.choice(phrases).append(word)
            count += size[word]
        out.append(" ".join(phrases[0]) + " and " + " ".join(phrases[1]))
    return out
