"""Shared pieces of the PyTorch-port parity tests (tests/test_torch_*.py):
small configurations that exist in both packages, JAX-initialized
weights, and a deterministic tokenizer."""

import zlib

import jax
import numpy as np
import torch

from fashionern_aaai2024_tpu.models import composed as jax_composed
from fashionern_aaai2024_tpu.models.clip import config as jax_config
from fashionern_aaai2024_tpu_torch.models import composed as torch_composed
from fashionern_aaai2024_tpu_torch.models import convert
from fashionern_aaai2024_tpu_torch.models.clip import config as torch_config

D = 24           # joint feature dim of the small configs
CTX = 16         # text context of the small configs
PATCH_NUM = 13


def small_config(module, width: int = 128, heads: int = 2, text_width: int = 128,
                 text_heads: int = 2, activation: str = "quick_gelu"):
    """2 layers, image 32, patch 16; dh = 64 at the defaults."""
    return module.CLIPConfig(
        name="port-test",
        vision=module.VisionConfig(kind="vit", image_size=32, embed_dim=D, width=width,
                                   layers=2, heads=heads, patch_size=16),
        text=module.TextConfig(vocab_size=100, context_length=CTX, width=text_width,
                               heads=text_heads, layers=2, embed_dim=D),
        activation=activation,
    )


def tiny_config(module):
    """`tests/test_server.py` TINY."""
    return small_config(module, width=64, heads=4, text_width=32, text_heads=4,
                        activation="gelu")


def resnet_config(module, layers=(1, 1, 1, 1), activation: str = "quick_gelu"):
    """`tests/test_clip.py` RN_SMALL: a modified ResNet at image 64, base
    width 16, one bottleneck a stage, an attention pool of 8 heads of 64;
    the text tower of `tiny_config`."""
    return module.CLIPConfig(
        name="port-rn-test",
        vision=module.VisionConfig(kind="resnet", image_size=64, embed_dim=D, width=16,
                                   layers=layers, heads=8),
        text=module.TextConfig(vocab_size=100, context_length=CTX, width=32, heads=4,
                               layers=2, embed_dim=D),
        activation=activation,
    )


def jax_model_and_variables(cfg, seed: int = 0):
    model = jax_composed.ComposedCIRModel(cfg, patch_num=PATCH_NUM)
    rng = jax.random.PRNGKey(seed)
    v = cfg.vision
    z = np.zeros
    variables = model.init(
        {"params": rng, "dropout": rng},
        z((2, v.image_size, v.image_size, 3), np.float32),
        z((2, v.image_size, v.image_size, 3), np.float32),
        z((2, CTX), np.int32), z((2, PATCH_NUM, D), np.float32),
        z((2, PATCH_NUM, D), np.float32),
        deterministic=False, method=model.train_forward,
    )
    return model, jax.tree_util.tree_map(np.asarray, variables)


def port_model(torch_cfg, variables) -> torch_composed.ComposedCIRModel:
    """The port's model with the JAX variables carried by the bridge."""
    model = torch_composed.ComposedCIRModel(torch_cfg, patch_num=PATCH_NUM)
    model.load_state_dict(convert.state_dict_from_variables(variables, torch_cfg),
                          strict=True)
    return model.eval()


def both_models(cfg_fn=small_config, seed: int = 0, **kw):
    jm, variables = jax_model_and_variables(cfg_fn(jax_config, **kw), seed)
    tm = port_model(cfg_fn(torch_config, **kw), variables)
    return jm, variables, tm


def crc_tokenizer(texts, context_length=CTX):
    """Word ids from zlib.crc32 (stable across processes, unlike hash())."""
    out = np.zeros((len(texts), context_length), np.int32)
    for i, t in enumerate(texts):
        ids = [zlib.crc32(w.encode()) % 97 + 1 for w in t.split()][:context_length]
        out[i, :len(ids)] = ids
    return out


def to_np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().cpu().numpy()
    return np.asarray(t, np.float32)
