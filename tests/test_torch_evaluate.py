"""The port's dataset evaluators against the JAX package's, on the CPU.

`evaluate_fiq_split` (both K lists), `evaluate_fiq`, `evaluate_shoes`,
`evaluate_fashion200k`, `evaluate_cirr` and `generate_cirr_submission`
of both packages on the same small-config weights (carried by the weight
bridge), the same in-memory items behind each package's `Loader`, and
the same tokenizer, after `tests/test_evaluate.py`'s patterns at a
gallery large enough that Recall@10 is not trivially 100. Recall dicts
and submissions equal; predictions within 2e-4, the end-to-end tolerance
of `tests/test_e2e_parity.py:147`. The metrics, the caption helpers and
the index's name ids and member scores against the JAX copies.
"""

import random

import numpy as np
import pytest
import torch

from fashionern_aaai2024_tpu.data import captions as JC
from fashionern_aaai2024_tpu.data.loader import Loader as JaxLoader
from fashionern_aaai2024_tpu.retrieval import engine as JEng
from fashionern_aaai2024_tpu.retrieval import evaluate as JE
from fashionern_aaai2024_tpu.retrieval import metrics as JM
from fashionern_aaai2024_tpu_torch.data import captions as TC
from fashionern_aaai2024_tpu_torch.data.loader import Loader
from fashionern_aaai2024_tpu_torch.retrieval import engine as TEng
from fashionern_aaai2024_tpu_torch.retrieval import evaluate as TE
from fashionern_aaai2024_tpu_torch.retrieval import metrics as TM
from torch_port_helpers import CTX, D, PATCH_NUM, both_models, crc_tokenizer, small_config

torch.set_num_threads(2)

N_GALLERY = 64
CAPS = ["is red", "has longer sleeves", "more formal", "is darker", "with a collar",
        "in blue and shorter"]


@pytest.fixture(scope="module")
def apis():
    jm, variables, tm = both_models(small_config)
    jax_api = JE.InferenceAPI(jm, variables, batch_size=8, context_length=CTX,
                              tokenizer=crc_tokenizer)
    port_api = TE.InferenceAPI(tm, tokenizer=crc_tokenizer, device="cpu", batch_size=8,
                               context_length=CTX)
    return jax_api, port_api


def _gallery(names, seed=7):
    g = np.random.default_rng(seed)
    return [{"name": n, "image": g.random((32, 32, 3), dtype=np.float32),
             "patch": g.standard_normal((PATCH_NUM, D), dtype=np.float32)} for n in names]


def _run(fn, apis, gallery, relative, **kw):
    """`fn` of each package over its own Loader of the same items."""
    jax_api, port_api = apis
    want = getattr(JE, fn)(jax_api, JaxLoader(gallery, 8, num_workers=0),
                           JaxLoader(relative, 8, num_workers=0), **kw)
    got = getattr(TE, fn)(port_api, Loader(gallery, 8, num_workers=0),
                          Loader(relative, 8, num_workers=0), **kw)
    return want, got


def _fiq_items(names, n, seed):
    g = np.random.default_rng(seed)
    return [{"ref_name": names[i], "tar_name": names[(5 * i + 3) % len(names)],
             "captions": [CAPS[i % 6], CAPS[(i + 2) % 6]],
             "ref_patch": g.standard_normal((PATCH_NUM, D)).astype(np.float32)}
            for i in range(n)]


@pytest.mark.parametrize("ks", [(10, 50), (1, 5, 10, 15, 20)])
def test_fiq_split_matches_jax(apis, ks):
    names = [f"img{i}" for i in range(N_GALLERY)]
    want, got = _run("evaluate_fiq_split", apis, _gallery(names), _fiq_items(names, 24, 11),
                     ks=ks)
    assert got == want
    assert 0.0 < got[f"recall_at{ks[-1]}"] < 100.0 or ks[-1] >= N_GALLERY


def test_evaluate_fiq_matches_jax(apis):
    jax_api, port_api = apis
    loaders = {}
    for i, dt in enumerate(("dress", "shirt", "toptee")):
        names = [f"{dt}{j}" for j in range(N_GALLERY)]
        loaders[dt] = (_gallery(names, seed=20 + i), _fiq_items(names, 16, seed=30 + i))
    want = JE.evaluate_fiq(jax_api, {dt: (JaxLoader(c, 8, num_workers=0),
                                          JaxLoader(r, 8, num_workers=0))
                                     for dt, (c, r) in loaders.items()})
    got = TE.evaluate_fiq(port_api, {dt: (Loader(c, 8, num_workers=0),
                                          Loader(r, 8, num_workers=0))
                                     for dt, (c, r) in loaders.items()})
    assert got == want
    assert set(got) == {"dress", "shirt", "toptee", "mean_recall_at10", "mean_recall_at50",
                        "avg"}


def _cirr_items(names, n, seed, pair_ids=False):
    g = np.random.default_rng(seed)
    items = []
    for i in range(n):
        members = [names[(3 * i + j) % len(names)] for j in range(6)]
        item = {"ref_name": members[0], "caption": CAPS[i % 6], "group_members": members,
                "ref_patch": g.standard_normal((PATCH_NUM, D)).astype(np.float32)}
        if pair_ids:
            item["pair_id"] = 1000 + i
        else:
            item["tar_name"] = members[1 + i % 5]
        items.append(item)
    return items


def test_cirr_matches_jax(apis):
    names = [f"img{i}" for i in range(N_GALLERY)]
    want, got = _run("evaluate_cirr", apis, _gallery(names, seed=8), _cirr_items(names, 20, 13))
    assert got == want
    assert got["group_recall_at3"] >= got["group_recall_at1"]


def test_cirr_submission_matches_jax(apis):
    names = [f"img{i}" for i in range(N_GALLERY)]
    want, got = _run("generate_cirr_submission", apis, _gallery(names, seed=9),
                     _cirr_items(names, 12, 21, pair_ids=True))
    assert got == want
    row = got["recall_submission"]["1000"]
    assert len(row) == 50 and names[0] not in row


def test_fashion200k_matches_jax(apis):
    # duplicated caption ids: retrieving any image of the target's caption is a hit
    captions = [f"{c} {k}" for c in ("red", "blue", "green", "white") for k in
                ("dress", "shirt", "skirt", "top")] * 4
    g = np.random.default_rng(14)
    relative = [{"ref_id": captions[i], "tar_id": captions[(i + 5) % 16],
                 "caption": f"replace {captions[i].split()[0]} with "
                            f"{captions[(i + 5) % 16].split()[0]}",
                 "ref_patch": g.standard_normal((PATCH_NUM, D)).astype(np.float32)}
                for i in range(12)]
    want, got = _run("evaluate_fashion200k", apis, _gallery(captions, seed=10), relative)
    assert got == want


def test_shoes_matches_jax(apis):
    names = [f"shoe{i}" for i in range(N_GALLERY)]
    g = np.random.default_rng(15)
    relative = [{"ref_name": names[i], "tar_name": names[(i + 7) % N_GALLERY],
                 "caption": CAPS[i % 6],
                 "ref_patch": g.standard_normal((PATCH_NUM, D)).astype(np.float32)}
                for i in range(20)]
    want, got = _run("evaluate_shoes", apis, _gallery(names, seed=11), relative)
    assert got == want


def test_predictions_and_index_match_jax(apis):
    """The query pass (predictions within 2e-4, collected keys equal) and
    the index's name ids, top-k ids, member scores and row lookups."""
    jax_api, port_api = apis
    names = [f"img{i % 40}" for i in range(N_GALLERY)]  # 24 duplicated names
    items = _gallery(names, seed=12)
    relative = _fiq_items(names, 16, 17)
    jg = JEng.embed_gallery(jax_api.gallery_encode_fn(), JaxLoader(items, 8, num_workers=0), 8)
    tg = TEng.embed_gallery(port_api.gallery_encode_fn(), Loader(items, 8, num_workers=0))
    want, jmeta = JE.generate_predictions(jax_api, JaxLoader(relative, 8, num_workers=0),
                                          JE.fiq_caption_fn, jg, collect=("tar_name",))
    got, tmeta = TE.generate_predictions(port_api, Loader(relative, 8, num_workers=0),
                                         TE.fiq_caption_fn, tg, collect=("tar_name",))
    assert tmeta == jmeta
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=0)
    jindex, jtop = JE._search_ids(jax_api, jg, want, 10)
    tindex, ttop = TE._search_ids(port_api, tg, got, 10)
    np.testing.assert_array_equal(ttop, jtop)
    np.testing.assert_array_equal(tindex.ids, jindex.ids)
    assert tindex.vocab == jindex.vocab
    assert TEng.names_to_ids(names)[1] == JEng.names_to_ids(names)[1]
    rows = np.random.default_rng(3).integers(0, N_GALLERY, (16, 6))
    np.testing.assert_allclose(tindex.scores_for(got, rows), jindex.scores_for(want, rows),
                               atol=2e-4, rtol=0)
    for n in ("img3", "img39", "img0"):
        assert tindex.row_of(n) == jindex.row_of(n)


def test_metrics_match_jax():
    g = np.random.default_rng(4)
    topk = np.stack([g.permutation(80)[:60] for _ in range(30)]).astype(np.int32)
    col = g.integers(0, 60, 30)
    target = topk[np.arange(30), col]
    ref = topk[np.arange(30), (col + 1 + g.integers(0, 59, 30)) % 60]  # never the target
    assert (TM.drop_reference(topk, ref, 50) == JM.drop_reference(topk, ref, 50)).all()
    for fn in ("fiq_metrics", "fashion200k_metrics", "val_protocol_metrics"):
        assert getattr(TM, fn)(topk, target) == getattr(JM, fn)(topk, target)
    members = np.stack([np.concatenate([[t, r], g.choice(
        [x for x in range(80) if x not in (t, r)], 4, replace=False)])
        for t, r in zip(target, ref)])
    scores = g.standard_normal(members.shape)
    assert (TM.subset_recall(scores, members, target, ref)
            == JM.subset_recall(scores, members, target, ref))
    assert (TM.cirr_metrics(topk, ref, target, scores, members)
            == JM.cirr_metrics(topk, ref, target, scores, members))
    vocab = {f"n{i}": i for i in range(10)}
    names = [f"n{i}" for i in (3, 1, 4, 1, 5)]
    np.testing.assert_array_equal(TM.names_to_id_array(names, vocab),
                                  JM.names_to_id_array(names, vocab))


def test_captions_match_jax():
    rng = random.Random(0)
    words = ["red", "blue", "dress", "shirt", "long", "short", "a", "with", "sleeves"]
    for _ in range(50):
        a = " ".join(rng.choice(words) for _ in range(rng.randint(0, 5)))
        b = " ".join(rng.choice(words) for _ in range(rng.randint(0, 5)))
        assert TC.join_fiq_captions(a + ".", " " + b) == JC.join_fiq_captions(a + ".", " " + b)
        assert TC.get_different_word(a, b) == JC.get_different_word(a, b)
        mark = f" {a}.? & * {b} "
        assert TC.caption_post_process(mark) == JC.caption_post_process(mark)
