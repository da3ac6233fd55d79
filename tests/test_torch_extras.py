"""The port's remaining utilities (`utils/extras.py`) against the JAX
package's, on the CPU: `cutout` byte for byte on one PIL image per seed,
`EmaState` over three updates (a mapping and a module's parameters), the
two feature helpers at the fp32 tolerance, and the host seeding."""

import random

import numpy as np
import pytest
import torch
from PIL import Image

from fashionern_aaai2024_tpu.utils import extras as J
from fashionern_aaai2024_tpu_torch.utils import extras as T


def _image(seed: int, size=(37, 23)) -> Image.Image:
    g = np.random.default_rng(seed)
    return Image.fromarray(g.integers(0, 256, (size[1], size[0], 3), dtype=np.uint8))


@pytest.mark.parametrize("seed,factor", [(0, 0.5), (1, 0.3), (2, 0.9)])
def test_cutout_paints_the_bytes_jax_paints(seed, factor):
    """A non-square image, so that the reference's w / h swap shows."""
    want = J.cutout(_image(seed), factor, np.random.default_rng(seed + 10))
    got = T.cutout(_image(seed), factor, np.random.default_rng(seed + 10))
    assert got.tobytes() == want.tobytes()
    assert got.tobytes() != _image(seed).tobytes()


@pytest.mark.parametrize("as_module", [False, True])
def test_ema_matches_jax_over_three_updates(as_module):
    rng = np.random.default_rng(3)
    shapes = {"weight": (4, 3), "bias": (4,)}
    init = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    steps = [{k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(3)]
    jema = J.EmaState.create(init, decay=0.9)
    module = torch.nn.Linear(3, 4)

    def params(values):
        if not as_module:
            return {k: torch.from_numpy(v) for k, v in values.items()}
        with torch.no_grad():
            for k, v in values.items():
                getattr(module, k).copy_(torch.from_numpy(v))
        return module

    tema = T.EmaState.create(params(init), decay=0.9)
    for step in steps:
        jema, tema = jema.update(step), tema.update(params(step))
        for k in shapes:
            np.testing.assert_array_equal(tema.params[k].numpy(), np.asarray(jema.params[k]))
            assert not tema.params[k].requires_grad
    reset = T.EmaState.create(params(init), decay=0.9).set(params(steps[0]))
    for k in shapes:
        np.testing.assert_array_equal(reset.params[k].numpy(),
                                      np.asarray(jema.set(steps[0]).params[k]))


def test_feature_helpers_match_jax():
    rng = np.random.default_rng(4)
    g, local = rng.standard_normal((3, 8)), rng.standard_normal((3, 5, 8))
    g, local = g.astype(np.float32), local.astype(np.float32)
    got = T.concat_global_local_feats(torch.from_numpy(g), torch.from_numpy(local))
    np.testing.assert_array_equal(got.numpy(), np.asarray(J.concat_global_local_feats(g, local)))
    img, txt = rng.standard_normal((2, 3, 8)).astype(np.float32)
    txt[0] = -img[0]                                     # a zero sum: the eps branch
    got = T.element_wise_sum(torch.from_numpy(img), torch.from_numpy(txt))
    np.testing.assert_allclose(got.numpy(), np.asarray(J.element_wise_sum(img, txt)),
                               atol=2e-5, rtol=0)


def test_setup_host_seed_seeds_the_host_generators():
    g = T.setup_host_seed(7)
    a = (random.random(), np.random.random(), torch.rand(()).item(), g.random())
    T.setup_host_seed(7)
    b = (random.random(), np.random.random(), torch.rand(()).item(),
         np.random.default_rng(7).random())
    assert a == b
    J.setup_host_seed(7)
    assert (random.random(), np.random.random()) == a[:2]
