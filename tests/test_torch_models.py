"""The port's modules against the JAX modules, with the same weights
(carried by the weight bridge) and the same numpy inputs, on the CPU in
fp32 at the module tolerance, atol 2e-5.

Also the serve precision policy: the port's ERN under
`apply_precision(..., "bf16")` against the JAX ERN under
`cli/main.py _cast_precision(..., "bf16")` fed fp32 inputs.
"""

import jax
import numpy as np
import pytest
import torch

from fashionern_aaai2024_tpu.cli.main import _cast_precision
from fashionern_aaai2024_tpu_torch.models.composed import apply_precision
from torch_port_helpers import CTX, D, PATCH_NUM, both_models, small_config, to_np

torch.set_num_threads(2)
ATOL = 2e-5


@pytest.fixture(scope="module", params=["quick_gelu", "gelu"])
def models(request):
    return both_models(small_config, activation=request.param)


def _close(want, got):
    np.testing.assert_allclose(to_np(got), np.asarray(want, np.float32), atol=ATOL, rtol=0)


def _ern_inputs(seed=0, b=3):
    g = np.random.default_rng(seed)
    f = np.float32
    return (g.standard_normal((b, D)).astype(f), g.standard_normal((b, PATCH_NUM, D)).astype(f),
            g.standard_normal((b, D)).astype(f), g.standard_normal((b, CTX, D)).astype(f))


def test_vit_tower_matches_jax(models):
    jm, v, tm = models
    img = np.random.default_rng(1).random((3, 32, 32, 3), dtype=np.float32)
    jg, jt = jm.apply(v, img, method=jm.encode_image)
    with torch.no_grad():
        tg, tt = tm.encode_image(torch.from_numpy(img))
    _close(jg, tg)
    _close(jt, tt)


def test_vit_tower_uint8_feed_matches_jax(models):
    jm, v, tm = models
    img = np.random.default_rng(2).integers(0, 256, (2, 32, 32, 3)).astype(np.uint8)
    jg, _ = jm.apply(v, img, method=jm.encode_image)
    with torch.no_grad():
        tg, _ = tm.encode_image(torch.from_numpy(img))
    _close(jg, tg)


def test_text_tower_matches_jax(models):
    jm, v, tm = models
    ids = np.random.default_rng(3).integers(1, 99, (3, CTX)).astype(np.int32)
    ids[0, 5:] = 0  # a padded caption: the global feature sits at the argmax
    jg, js = jm.apply(v, ids, method=jm.encode_text)
    with torch.no_grad():
        tg, ts = tm.encode_text(torch.from_numpy(ids))
    _close(jg, tg)
    _close(js, ts)


def test_ern_index_matches_jax(models):
    jm, v, tm = models
    rf, rp, _, _ = _ern_inputs(4)
    want = jm.apply(v, rf, rp, method=jm.index)
    with torch.no_grad():
        got = tm.index(torch.from_numpy(rf), torch.from_numpy(rp))
    _close(want, got)


def test_ern_query_matches_jax(models):
    jm, v, tm = models
    args = _ern_inputs(5)
    want = jm.apply(v, *args, method=jm.query)
    with torch.no_grad():
        got = tm.query(*map(torch.from_numpy, args))
    _close(want, got)


@pytest.mark.parametrize("method", ["index", "query"])
def test_bf16_ern_policy_matches_jax(method):
    """bf16-rounded ERN weights computing in fp32 on both sides."""
    jm, v, tm = both_models(small_config, seed=1)
    vb = _cast_precision(jax.tree_util.tree_map(jax.numpy.asarray, v), "bf16")
    apply_precision(tm, "bf16")
    assert tm.clip.visual.proj.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in tm.ern.parameters())
    args = _ern_inputs(6)
    if method == "index":
        args = args[:2]
    want = jm.apply(vb, *args, method=getattr(jm, method))
    with torch.no_grad():
        got = getattr(tm, method)(*map(torch.from_numpy, args))
    assert np.asarray(want).dtype == np.float32
    _close(want, got)


def test_bf16_towers_track_fp32_towers():
    """Under the bf16 policy the towers run in bf16 end to end (the image
    feed is cast at entry) and stay close to the fp32 towers."""
    _, _, tm = both_models(small_config, seed=2)
    img = torch.from_numpy(np.random.default_rng(7).random((4, 32, 32, 3), dtype=np.float32))
    with torch.no_grad():
        g32, _ = tm.encode_image(img)
        apply_precision(tm, "bf16")
        g16, _ = tm.encode_image(img)
    assert g16.dtype == torch.bfloat16
    cos = torch.nn.functional.cosine_similarity(g16.float(), g32, dim=-1)
    assert cos.min() > 0.99
