"""Caption processing and augmentation.

A copy of `fashionern_aaai2024_tpu/data/captions.py`, kept in the port so
that it imports nothing of the JAX package. Exact ports of the
reference's text-side behavior: they define the training distribution
and the eval inputs, so semantics are preserved verbatim (sources in
each function).
"""

from __future__ import annotations

import random
from typing import List, Sequence


def join_fiq_captions(cap1: str, cap2: str) -> str:
    """Eval-time deterministic join: "Cap1 and cap2"
    (`run/valid/validate_fiq.py:75-79`)."""
    return f"{cap1.strip('.?, ').capitalize()} and {cap2.strip('.?, ')}"


def generate_randomized_fiq_caption(
    flattened_captions: Sequence[str], rng: random.Random | None = None
) -> List[str]:
    """Train-time 4-way randomized caption join, p=1/4 each
    (`utils/utils.py:102-123`): (a) cap1 and cap2, (b) cap2 and cap1,
    (c) cap1, (d) cap2. Input length 2·B, output length B."""
    rand = rng.random if rng is not None else random.random
    captions = []
    for i in range(0, len(flattened_captions), 2):
        r = rand()
        c1 = flattened_captions[i].strip(".?, ")
        c2 = flattened_captions[i + 1].strip(".?, ")
        if r < 0.25:
            captions.append(f"{c1.capitalize()} and {c2}")
        elif r < 0.5:
            captions.append(f"{c2.capitalize()} and {c1}")
        elif r < 0.75:
            captions.append(c1.capitalize())
        else:
            captions.append(c2.capitalize())
    return captions


def generate_shoes_caption(flattened_captions: Sequence[str]) -> List[str]:
    """Strip + capitalize (`utils/utils.py:126-130`)."""
    return [c.strip(".?, ").capitalize() for c in flattened_captions]


def caption_post_process(s: str) -> str:
    """Fashion200k caption cleanup (`dataloader/fashion200k_patch.py:52-54`)."""
    return (s.strip().replace(".", "dotmark").replace("?", "questionmark")
            .replace("&", "andmark").replace("*", "starmark"))


def get_different_word(source_caption: str, target_caption: str) -> tuple[str, str, str]:
    """First word unique to each caption -> "replace X with Y" modifier
    (`dataloader/fashion200k_patch.py:39-49`)."""
    source_words = source_caption.split()
    target_words = target_caption.split()
    source_word = source_words[-1] if source_words else ""
    for w in source_words:
        if w not in target_words:
            source_word = w
            break
    target_word = target_words[-1] if target_words else ""
    for w in target_words:
        if w not in source_words:
            target_word = w
            break
    return source_word, target_word, f"replace {source_word} with {target_word}"
