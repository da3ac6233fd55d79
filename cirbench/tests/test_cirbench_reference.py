"""The plain reference against the port's plain CPU path, at the fixture
sizes on one set of seeded weights (the benchmark's own draw), fp32.

This test imports both the reference and the port; the reference itself
imports nothing of the port (`test_cirbench_spec.py`)."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from cirbench import captions, program, reference, weights
from cirbench.reference import bpe as ref_bpe
from cirbench.reference import clip, ern
from cirbench.tests.fixture import FIXTURES
from fashionern_aaai2024_tpu_torch.tokenizer import SimpleTokenizer

TOL = dict(rtol=2e-4, atol=2e-5)


def config(name: str) -> dict:
    return json.loads((FIXTURES / "cirbench" / "configs" / f"{name}.json").read_text())


def fp32_model(cfg: dict, seed: int):
    """The port's model in fp32 with the benchmark's weights, and the same
    weights under the reference's names."""
    from fashionern_aaai2024_tpu_torch.models.composed import ComposedCIRModel

    model = ComposedCIRModel(program.clip_config(cfg), patch_num=cfg["patch_num"]).eval()
    drawn = weights.draw(weights.layout_of(model.state_dict()), seed, "cpu")
    model.load_state_dict(drawn)
    return model, {k.removeprefix("clip."): v for k, v in drawn.items()}


def inputs(cfg: dict, n: int, seed: int):
    g = torch.Generator().manual_seed(seed)
    side, d = cfg["vision"]["image_size"], cfg["vision"]["embed_dim"]
    images = torch.randint(0, 256, (n, side, side, 3), generator=g, dtype=torch.uint8)
    patches = torch.randn((n, cfg["patch_num"], d), generator=g)
    return images, patches


@pytest.mark.parametrize("name", ["tiny-vit", "tiny-rn"])
def test_image_tower_and_index_match_the_port(name):
    cfg = config(name)
    model, W = fp32_model(cfg, 3)
    images, patches = inputs(cfg, 5, 4)
    with torch.no_grad():
        g, tokens = model.encode_image(images)
        tf = g / (torch.linalg.vector_norm(g, dim=-1, keepdim=True) + 1e-12)
        refined = model.index(tf, patches)
    want_g, want_tokens = clip.image_tower(clip.normalize_uint8(images), W, cfg)
    torch.testing.assert_close(want_g, g, **TOL)
    torch.testing.assert_close(want_tokens, tokens, **TOL)
    torch.testing.assert_close(ern.index(want_g, patches, W), refined, **TOL)
    got_g, got_r = reference.embed(images, patches, W, cfg, block=2)
    torch.testing.assert_close(got_g, g, **TOL)
    torch.testing.assert_close(got_r, refined, **TOL)


def test_query_tower_matches_the_port():
    cfg = config("tiny-vit")
    model, W = fp32_model(cfg, 5)
    images, patches = inputs(cfg, 4, 6)
    merges = captions.merges()
    bpe = ref_bpe.BPE(merges)
    caps = captions.captions(4, 9, (8, 30), bpe)
    ids = torch.as_tensor(SimpleTokenizer(merges=merges)(caps, cfg["text"]["context_length"]))
    with torch.no_grad():
        g, _ = model.encode_image(images)
        tg, ts = model.encode_text(ids.long(), visual_emb=patches)
        q = model.query(g, patches, tg, ts)
    want_tg, want_ts = clip.text_tower(ids, W, cfg)
    want_tg, want_ts = ern.enhanced_text(ids, want_ts, patches, W, cfg["tme_heads"])
    torch.testing.assert_close(want_tg, tg, **TOL)
    torch.testing.assert_close(want_ts, ts, **TOL)
    torch.testing.assert_close(reference.query(ids, g, patches, W, cfg), q, **TOL)


def test_tokenizer_ids_match_the_port():
    merges = captions.merges()
    bpe = ref_bpe.BPE(merges)
    caps = captions.captions(200, 12, (8, 30), bpe)
    np.testing.assert_array_equal(bpe.rows(caps, 77), SimpleTokenizer(merges=merges)(caps, 77))
    lengths = [len(bpe.encode(c)) + 2 for c in caps]
    assert min(lengths) >= 8 and max(lengths) <= 30


def test_served_weights_round_to_bf16_and_drop_the_clip_prefix():
    W = {"clip.visual.proj": torch.tensor([1.0 + 2 ** -12]), "ern.x": torch.tensor([3])}
    out = reference.served_weights(W, config("tiny-vit"))
    assert out["visual.proj"].item() == 1.0 and out["ern.x"].dtype == torch.int64
