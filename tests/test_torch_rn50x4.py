"""The RN50x4 serve slice of the port against the JAX package, on the CPU
in fp32, at the small ResNet config of tests/test_clip.py (image 64, base
width 16, one bottleneck a stage, an attention pool of 8 heads of 64).

  * the modified-ResNet tower (global and tokens) against the JAX
    `ModifiedResNet` at 2e-5, with BatchNorm statistics away from (0, 1);
  * `fold_batchnorm` against the JAX fold at 2e-5, and the folded tower's
    forward against the unfolded one;
  * the weight bridge for a ResNet CLIP: port state_dict ->
    `clip_variables_from_torch` gives the JAX variables back leaf for
    leaf, `batch_stats` included;
  * the slice end to end: `InferenceAPI` + `RetrievalService` against the
    JAX service at 2e-4 (`tests/test_e2e_parity.py:147`) with identical
    result names, the pattern of tests/test_torch_serve.py;
  * the seeded weights of runs without a checkpoint: calibrated
    BatchNorm statistics keep the activations O(1) at RN50x4's depth.
"""

import flax
import jax
import numpy as np
import pytest
import torch

from fashionern_aaai2024_tpu.data.loader import Loader
from fashionern_aaai2024_tpu.models.clip import config as jax_config
from fashionern_aaai2024_tpu.models.clip.convert import clip_variables_from_torch
from fashionern_aaai2024_tpu.models.clip.resnet import fold_batchnorm as jax_fold
from fashionern_aaai2024_tpu.retrieval import evaluate as JE
from fashionern_aaai2024_tpu.retrieval.server import RetrievalService as JaxService
from fashionern_aaai2024_tpu_torch.models import convert
from fashionern_aaai2024_tpu_torch.models.clip import config as torch_config
from fashionern_aaai2024_tpu_torch.models.clip.resnet import (
    ModifiedResNet,
    calibrate_batchnorm_,
    fold_batchnorm,
)
from fashionern_aaai2024_tpu_torch.models.composed import (
    ComposedCIRModel,
    apply_precision,
    random_init_,
)
from fashionern_aaai2024_tpu_torch.retrieval.evaluate import InferenceAPI
from fashionern_aaai2024_tpu_torch.retrieval.server import RetrievalService
from torch_port_helpers import (
    CTX,
    D,
    PATCH_NUM,
    crc_tokenizer,
    jax_model_and_variables,
    port_model,
    resnet_config,
)

torch.set_num_threads(2)

IMAGE = 64
QUERIES = [("img3", "make it red"), ("img0", "longer sleeves"), ("img5", "in blue"),
           ("img11", "more formal and darker")]


def _with_bn_stats(variables, seed: int = 5):
    """The CLIP tower's BatchNorm statistics replaced by means ~ N(0, 0.3)
    and variances in [0.5, 2], so that no BN is near the identity."""
    g = np.random.default_rng(seed)
    stats = flax.traverse_util.flatten_dict(variables["batch_stats"]["clip"])
    stats = {k: (0.5 + 1.5 * g.random(v.shape) if k[-1] == "var"
                 else 0.3 * g.standard_normal(v.shape)).astype(np.float32)
             for k, v in stats.items()}
    out = dict(variables)
    out["batch_stats"] = dict(variables["batch_stats"],
                              clip=flax.traverse_util.unflatten_dict(stats))
    return out


@pytest.fixture(scope="module")
def models():
    jm, variables = jax_model_and_variables(resnet_config(jax_config), seed=2)
    variables = _with_bn_stats(variables)
    return jm, variables, port_model(resnet_config(torch_config), variables)


def _images(n: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((n, IMAGE, IMAGE, 3)).astype(np.float32)


def test_resnet_tower_matches_jax(models):
    jm, variables, tm = models
    x = _images(3)
    want_g, want_t = jm.apply(variables, x, method=jm.encode_image)
    with torch.no_grad():
        got_g, got_t = tm.encode_image(torch.from_numpy(x))
    assert got_t.shape == (3, (IMAGE // 32) ** 2 + 1, D)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), atol=2e-5, rtol=0)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), atol=2e-5, rtol=0)


def test_fold_batchnorm_matches_jax_fold(models):
    """The port's fold of the bridged weights equals the bridge of the JAX
    fold, leaf for leaf at 2e-5, and the folded tower computes what the
    unfolded one does (the JAX test's 1e-4)."""
    jm, variables, tm = models
    want = convert.state_dict_from_variables(jax_fold(variables), resnet_config(torch_config))
    folded = port_model(resnet_config(torch_config), variables)
    fold_batchnorm(folded.clip.visual)
    got = folded.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].float().numpy(), v.float().numpy(), atol=2e-5,
                                   rtol=0, err_msg=k)
    x = torch.from_numpy(_images(2, seed=1))
    with torch.no_grad():
        for a, b in zip(folded.encode_image(x), tm.encode_image(x)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4, rtol=1e-4)


def test_resnet_bridge_round_trip_is_exact(models):
    _, variables, tm = models
    sd = {k[len("clip."):]: v for k, v in tm.state_dict().items() if k.startswith("clip.")}
    back = clip_variables_from_torch(sd, resnet_config(jax_config), strict=True)
    want = {"params": variables["params"]["clip"],
            "batch_stats": variables["batch_stats"]["clip"]}
    leaves_w, tree_w = jax.tree_util.tree_flatten(want)
    leaves_g, tree_g = jax.tree_util.tree_flatten(back)
    assert tree_w == tree_g
    for a, b in zip(leaves_w, leaves_g):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


def test_resnet_keys_are_the_open_clip_keys(models):
    """strict=True raises on any key the JAX converter does not consume,
    a missing key raises KeyError: the port's `clip.` keys are the ones it
    reads (the BN step counters aside, which it ignores)."""
    _, _, tm = models
    sd = {k[len("clip."):]: v for k, v in tm.state_dict().items() if k.startswith("clip.")}
    cfg = resnet_config(jax_config)
    clip_variables_from_torch(sd, cfg, strict=True)
    with pytest.raises(KeyError):
        clip_variables_from_torch({k: v for k, v in sd.items()
                                   if k != "visual.layer2.0.downsample.1.running_mean"}, cfg)
    with pytest.raises(ValueError, match="not consumed"):
        clip_variables_from_torch(dict(sd, **{"visual.layer1.0.extra": torch.zeros(1)}), cfg)
    for key in ("visual.layer1.0.downsample.0.weight", "visual.layer4.0.bn3.running_var",
                "visual.attnpool.positional_embedding", "visual.attnpool.c_proj.weight"):
        assert key in sd


def _items(n=12, seed=1):
    g = np.random.default_rng(seed)
    return [{"name": f"img{i}", "image": g.standard_normal((IMAGE, IMAGE, 3)).astype(np.float32),
             "patch": g.standard_normal((PATCH_NUM, D)).astype(np.float32)}
            for i in range(n)]


@pytest.fixture(scope="module")
def services(models):
    jm, variables, tm = models
    jax_api = JE.InferenceAPI(jm, variables, batch_size=8, context_length=CTX,
                              tokenizer=crc_tokenizer)
    jax_service = JaxService(jax_api, Loader(_items(), 8, num_workers=0), warmup=False)
    api = InferenceAPI(tm, tokenizer=crc_tokenizer, device="cpu", batch_size=8,
                       context_length=CTX)
    return jax_service, RetrievalService(api, Loader(_items(), 8, num_workers=0))


def _check(jax_results, port_results):
    assert len(jax_results) == len(port_results)
    for jr, pr in zip(jax_results, port_results):
        assert [r["name"] for r in pr] == [r["name"] for r in jr]
        np.testing.assert_allclose([r["score"] for r in pr], [r["score"] for r in jr],
                                   atol=2e-4, rtol=0)


@pytest.mark.parametrize("q", range(len(QUERIES)))
def test_rn_single_query_matches_jax_service(services, q):
    jax_service, port_service = services
    ref, caption = QUERIES[q]
    want, _ = jax_service.query([ref], [caption], k=5)
    got, _ = port_service.query([ref], [caption], k=5)
    _check(want, got)


def test_rn_batch_query_matches_jax_service(services):
    jax_service, port_service = services
    refs, caps = zip(*QUERIES)
    want, _ = jax_service.query(list(refs), list(caps), k=12)
    got, _ = port_service.query(list(refs), list(caps), k=12)
    _check(want, got)


def test_rn_gallery_features_match_jax_service(services):
    jax_service, port_service = services
    assert port_service.gallery.names == jax_service.gallery.names
    np.testing.assert_allclose(port_service.gallery.features.numpy(),
                               np.asarray(jax_service.gallery.features, np.float32),
                               atol=2e-5, rtol=0)
    np.testing.assert_allclose(port_service.gallery.local_features.numpy(),
                               np.asarray(jax_service.gallery.local_features, np.float32),
                               atol=0, rtol=0)
    np.testing.assert_allclose(port_service.index.features.numpy(),
                               np.asarray(jax_service._initial_refined), atol=2e-5, rtol=0)


def _activation_spread(tower: ModifiedResNet, images: torch.Tensor) -> list[float]:
    """Standard deviation of each stage's output."""
    spread = []
    hooks = [getattr(tower, f"layer{i + 1}").register_forward_hook(
        lambda m, a, out: spread.append(out.float().std().item())) for i in range(4)]
    with torch.no_grad():
        tower(images)
    for h in hooks:
        h.remove()
    return spread


@pytest.mark.parametrize("image_seed", [3, 4, 6, 7])
def test_seeded_weights_keep_activations_of_order_one(image_seed):
    """At RN50x4's depth (stages 4-6-10-6), the seeded weights keep every
    stage's output and the embedding O(1) on images other than the ones
    the BN statistics were calibrated on."""
    def seeded():
        return random_init_(ComposedCIRModel(cfg, patch_num=PATCH_NUM),
                            torch.Generator().manual_seed(0)).clip.visual

    cfg = resnet_config(torch_config, layers=(4, 6, 10, 6))
    tower = seeded()
    images = torch.from_numpy(_images(2, seed=image_seed))
    spread = _activation_spread(tower, images)
    assert all(0.2 < s < 5 for s in spread), spread
    with torch.no_grad():
        glob, tokens = tower(images)
    assert torch.isfinite(tokens).all()
    assert 0.5 < glob.norm(dim=-1).min() and glob.norm(dim=-1).max() < 50
    # the same seed gives the same statistics
    torch.testing.assert_close(seeded().layer3[9].bn2.running_var,
                               tower.layer3[9].bn2.running_var, rtol=0, atol=0)


def test_calibrated_statistics_are_what_each_batchnorm_meets():
    tower = ModifiedResNet(resnet_config(torch_config).vision)
    random_init_(tower, torch.Generator().manual_seed(1))
    images = torch.from_numpy(_images(4, seed=4))
    calibrate_batchnorm_(tower, images)
    seen = []
    hook = tower.layer2[0].bn2.register_forward_hook(lambda m, a, out: seen.append(a[0]))
    with torch.no_grad():
        tower(images)
    hook.remove()
    x = seen[0]
    bn = tower.layer2[0].bn2
    torch.testing.assert_close(bn.running_mean, x.mean(dim=(0, 2, 3)), rtol=0, atol=1e-6)
    var = x.var(dim=(0, 2, 3), unbiased=False).mean()
    torch.testing.assert_close(bn.running_var, var.expand(bn.running_var.shape),
                               rtol=1e-5, atol=1e-6)


def test_bf16_policy_casts_the_resnet_and_its_statistics():
    model = random_init_(ComposedCIRModel(resnet_config(torch_config), patch_num=PATCH_NUM),
                         torch.Generator().manual_seed(2))
    apply_precision(model, "bf16")
    visual = model.clip.visual
    for name, t in list(visual.named_parameters()) + list(visual.named_buffers()):
        want = torch.long if name.endswith("num_batches_tracked") else torch.bfloat16
        assert t.dtype == want, name
    assert visual.conv1.weight.is_contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        glob, tokens = model.encode_image(torch.from_numpy(_images(2)))
    assert glob.dtype == torch.bfloat16 and torch.isfinite(tokens.float()).all()
