"""The CLIP BPE tokenizer under its JAX module path
(`fashionern_aaai2024_tpu/models/clip/tokenizer.py`): an alias of the
port's `tokenizer.py`, which lives outside `models/` so that a serving
host tokenizes without importing the model stack."""

import sys

from fashionern_aaai2024_tpu_torch import tokenizer as _tokenizer

sys.modules[__name__] = _tokenizer
