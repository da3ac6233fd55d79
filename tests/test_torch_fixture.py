"""The port's `tools/make_fixture.py` writes the JAX package's tree.

For every dataset layout, learnable on and off: the same file list, the
same JSON and text files, equal `.npy` arrays, equal decoded images, and
the same BPE table (learned by the port tokenizer's `write_bpe_table`).
Both makers run in one process: the Fashion200k maker seeds each patch
from `hash(path)`, which Python randomizes per process.
"""

import gzip
import json
import os

import numpy as np
import pytest
from PIL import Image

from fashionern_aaai2024_tpu.tools.make_fixture import make_fixture as jax_make_fixture
from fashionern_aaai2024_tpu_torch.tools.make_fixture import make_fixture


def _files(root: str) -> list[str]:
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.mark.parametrize("learnable", [False, True])
@pytest.mark.parametrize("dataset", ["fashioniq", "cirr", "shoes", "fashion200k"])
def test_port_fixture_is_the_jax_fixture(tmp_path, dataset, learnable):
    kw = dict(dim=16, patch_num=13, seed=5, learnable=learnable)
    if dataset != "fashion200k":
        kw.update(n_images=9, n_triplets=5)
    want = jax_make_fixture(str(tmp_path / "jax"), dataset, **kw)
    got = make_fixture(str(tmp_path / "port"), dataset, **kw)
    files = _files(want)
    assert _files(got) == files
    assert ("fixture_attrs.json" in files) == learnable
    for rel in files:
        a, b = os.path.join(got, rel), os.path.join(want, rel)
        if rel.endswith(".npy"):
            x, y = np.load(a), np.load(b)
            assert x.dtype == y.dtype and np.array_equal(x, y), rel
        elif rel.endswith((".png", ".jpg", ".jpeg")):
            assert np.array_equal(np.asarray(Image.open(a)), np.asarray(Image.open(b))), rel
        elif rel.endswith(".json"):
            assert json.load(open(a)) == json.load(open(b)), rel
        elif rel.endswith(".gz"):
            assert gzip.open(a).read() == gzip.open(b).read(), rel
        else:
            assert open(a, "rb").read() == open(b, "rb").read(), rel


def test_unsupported_sizing_flags_are_reported(tmp_path):
    with pytest.raises(ValueError, match="n-images"):
        make_fixture(str(tmp_path / "x"), "fashion200k", n_images=4)
    with pytest.raises(ValueError, match="n-queries"):
        make_fixture(str(tmp_path / "y"), "cirr", n_queries=4)
