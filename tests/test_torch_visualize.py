"""The port's HTML retrieval visualizer (`tools/visualize.py`) against the
JAX package's: the same page, byte for byte, for the same inputs
(tests/test_tools.py `TestVisualizer`, and cases of its own: a target
given by name, none, more results than k, a title that needs escaping)."""

import numpy as np
import pytest
from PIL import Image

from fashionern_aaai2024_tpu.tools.visualize import write_retrieval_html as jax_write
from fashionern_aaai2024_tpu_torch.tools.visualize import write_retrieval_html


@pytest.fixture
def images(tmp_path):
    g = np.random.default_rng(4)
    paths = []
    for i in range(6):
        p = tmp_path / f"v{i}.png"
        Image.fromarray((g.random((32 + 8 * i, 40, 3)) * 255).astype(np.uint8)).save(p)
        paths.append(str(p))
    return paths


def _queries(imgs):
    return [
        {"ref_image": imgs[0], "caption": "make it <red>", "results": imgs[1:],
         "target": imgs[2]},
        {"ref_image": imgs[1], "caption": "is \"longer\" & darker", "results": imgs[2:5],
         "target": "v4"},
        {"ref_image": imgs[5], "caption": "no target", "results": imgs[:2]},
    ]


@pytest.mark.parametrize("k,title", [(3, "Retrieval results"), (10, "top-k <b>&</b> hits")])
def test_page_equals_jax_byte_for_byte(tmp_path, images, k, title):
    got = write_retrieval_html(str(tmp_path / "port" / "out.html"), _queries(images), k=k,
                               title=title)
    want = jax_write(str(tmp_path / "jax" / "out.html"), _queries(images), k=k, title=title)
    with open(got, "rb") as f, open(want, "rb") as g:
        page = f.read()
        assert page == g.read()
    doc = page.decode()
    assert doc.count("data:image/jpeg;base64,") == 3 + min(k, 5) + min(k, 3) + 2
    assert doc.count('class="hit"') == 2
    assert "&lt;red&gt;" in doc  # the caption escaped


def test_html_output(tmp_path, images):
    """tests/test_tools.py `TestVisualizer.test_html_output`."""
    out = write_retrieval_html(str(tmp_path / "out.html"),
                               [{"ref_image": images[0], "caption": "make it <red>",
                                 "results": images[1:4], "target": images[2]}], k=3)
    doc = open(out).read()
    assert doc.count("data:image/jpeg;base64,") == 4
    assert 'class="hit"' in doc
    assert "&lt;red&gt;" in doc
