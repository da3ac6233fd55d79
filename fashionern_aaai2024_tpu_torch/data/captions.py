"""Train-time caption augmentation.

A copy of the train-side functions of `fashionern_aaai2024_tpu/data/captions.py`,
kept in the port so that it imports nothing of the JAX package. Exact
ports of the reference's text-side behavior: they define the training
distribution, so semantics are preserved verbatim (sources in each
function). The eval-side and Fashion200k helpers come with the dataset
classes and evaluators that call them (ROADMAP A9).
"""

from __future__ import annotations

import random
from typing import List, Sequence


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
