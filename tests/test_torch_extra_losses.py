"""The port's ablation losses (`ops/extra_losses.py`) against the JAX
package's, on the CPU: each loss and its gradients (autograd against
`jax.grad`) at rtol 1e-5, with an atol of 1e-6 times the largest
gradient element (elements near zero carry the two frameworks' summation
order and nothing else); the text-relevance bank's rows and size over
three calls; `accuracy` with ties; the registry, whose "bbc" is the
port's `batch_based_classification_loss`.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fashionern_aaai2024_tpu.ops import extra_losses as J
from fashionern_aaai2024_tpu.ops.losses import batch_based_classification_loss as jax_bbc
from fashionern_aaai2024_tpu_torch.ops import extra_losses as T

RTOL = 1e-5


def _np(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _leaves(*arrays):
    return [torch.tensor(a, requires_grad=True) for a in arrays]


def _close_grads(got, want):
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL, atol=1e-6 * np.abs(w).max())


def _check(jax_fn, torch_fn, arrays, argnums, **kw):
    """Value and the gradients of `argnums` (positions in `arrays`)."""
    want, want_grads = jax.value_and_grad(
        lambda *a: jax_fn(*a, **kw), argnums=argnums)(*map(jnp.asarray, arrays))
    leaves = [torch.tensor(a, requires_grad=i in argnums) if np.issubdtype(a.dtype, np.floating)
              else torch.tensor(a) for i, a in enumerate(arrays)]
    got = torch_fn(*leaves, **kw)
    got.backward()
    assert got.item() == pytest.approx(float(want), rel=RTOL)
    _close_grads([leaves[i].grad for i in argnums], want_grads)


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(0)
    logits, labels = _np(rng, 8, 11, scale=3.0), rng.integers(0, 11, 8).astype(np.int64)
    _check(J.cross_entropy_loss, T.cross_entropy_loss, [logits, labels], (0,))


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("margins", [(1.0, 0.0), (0.7, 0.3)])
def test_rank_loss_matches_jax(weighted, margins):
    """The band (0.3, 0.7) ignores some rows: their mask is detached on
    both sides, so they add nothing to the gradient."""
    rng = np.random.default_rng(1)
    inputs, targets = _np(rng, 16, 2, scale=2.0), rng.integers(0, 2, 16).astype(np.int64)
    arrays = [inputs, targets]
    if weighted:
        arrays.append(np.array([0.3, 1.7], np.float32))
    _check(lambda x, t, *w: J.rank_loss(x, t, *margins, *w),
           lambda x, t, *w: T.rank_loss(x, t, *margins, *w), arrays, (0,))


def test_cyclip_matches_jax():
    rng = np.random.default_rng(2)
    img, txt = _np(rng, 6, 16, scale=0.3), _np(rng, 6, 16, scale=0.3)
    scale = np.array(T.LOGIT_SCALE_INIT, np.float32)
    _check(J.cyclip_loss, T.cyclip_loss, [img, txt, scale], (0, 1, 2))
    assert T.LOGIT_SCALE_INIT == J.LOGIT_SCALE_INIT


def test_text_relevance_bank_over_three_calls():
    """Loss and gradients at each call; the bank's rows (newest first,
    detached) and size after each, from an empty bank of 10 rows filled
    by batches of 4 (the third call overflows it)."""
    rng = np.random.default_rng(3)
    jbank = J.TextRelevanceBank.create(10, 8)
    tbank = T.TextRelevanceBank.create(10, 8, device="cpu")
    for step in range(3):
        img, txt = _np(rng, 4, 8), _np(rng, 4, 8)
        scale = np.array(2.0 + step, np.float32)

        def jax_loss(i, t, s, bank=jbank):
            return J.text_relevance_loss(bank, i, t, s)[0]

        want, want_grads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2))(img, txt, scale)
        jbank = J.text_relevance_loss(jbank, img, txt, scale)[1]
        leaves = _leaves(img, txt, scale)
        got, tbank = T.text_relevance_loss(tbank, *leaves)
        got.backward()
        assert got.item() == pytest.approx(float(want), rel=RTOL)
        _close_grads([t.grad for t in leaves], want_grads)
        assert tbank.size == int(jbank.size) == min(4 * (step + 1), 10)
        assert not tbank.query.requires_grad and not tbank.doc.requires_grad
        np.testing.assert_array_equal(tbank.query.numpy(), np.asarray(jbank.query))
        np.testing.assert_array_equal(tbank.doc.numpy(), np.asarray(jbank.doc))


def test_bank_is_made_on_the_card_by_default():
    """`create` without `device=` allocates on the card (JAX's on its
    default device); without a card it raises and never falls back to the
    CPU."""
    assert inspect.signature(T.TextRelevanceBank.create).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        bank = T.TextRelevanceBank.create(4, 2)
        assert bank.query.device.type == bank.doc.device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            T.TextRelevanceBank.create(4, 2)


def test_accuracy_takes_the_lower_index_on_ties():
    """Rows of equal logits: `lax.top_k` ranks the lower index first, and
    so does the port (a label past the first k tied columns misses)."""
    logits = np.array([[1.0, 1.0, 1.0, 0.0], [0.0, 2.0, 2.0, 2.0], [3.0, 1.0, 3.0, 3.0],
                       [0.5, 0.5, 0.5, 0.5]], np.float32)
    labels = np.array([2, 3, 3, 1], np.int64)
    topk = (1, 2, 3)
    want = [float(a) for a in J.accuracy(jnp.asarray(logits), jnp.asarray(labels), topk)]
    got = [a.item() for a in T.accuracy(torch.tensor(logits), torch.tensor(labels), topk)]
    assert got == want == [0.0, 25.0, 100.0]
    rng = np.random.default_rng(4)
    logits, labels = _np(rng, 32, 10), rng.integers(0, 10, 32)
    assert ([a.item() for a in T.accuracy(torch.tensor(logits), torch.tensor(labels), (1, 5))]
            == [float(a) for a in J.accuracy(logits, labels, (1, 5))])


def test_text_generation_loss_calls_the_model_as_jax_does():
    """The caller's LM gets the caption as input and labels and the fusion
    embedding as one encoder hidden state [B, 1, d]."""
    calls = []

    def model(**kw):
        calls.append(kw)
        return kw["encoder_hidden_states"].sum() + kw["labels"].sum()

    ids = np.array([[3, 4, 0], [5, 0, 0]], np.int64)
    emb = np.arange(6, dtype=np.float32).reshape(2, 3)
    text = {"input_ids": ids, "attention_mask": (ids > 0).astype(np.int64)}
    want = J.text_generation_loss(model, text, jnp.asarray(emb))
    got = T.text_generation_loss(model, {k: torch.tensor(v) for k, v in text.items()},
                                 torch.tensor(emb))
    assert float(got) == float(want) == 27.0
    jax_call, port_call = calls
    assert set(jax_call) == set(port_call)
    assert tuple(port_call["encoder_hidden_states"].shape) == (2, 1, 3)
    assert port_call["token_type_ids"] is None


def test_registry_and_bbc():
    assert sorted(T.LOSS_REGISTRY) == sorted(J.LOSS_REGISTRY)
    for name, spec in T.LOSS_REGISTRY.items():
        assert (spec.name, spec.stateful, spec.notes) == (
            J.LOSS_REGISTRY[name].name, J.LOSS_REGISTRY[name].stateful,
            J.LOSS_REGISTRY[name].notes)
    with pytest.raises(ValueError) as got:
        T.get_loss("bogus")
    with pytest.raises(ValueError) as want:
        J.get_loss("bogus")
    assert str(got.value) == str(want.value)
    rng = np.random.default_rng(5)
    pred, tar = _np(rng, 12, 24, scale=0.2), _np(rng, 12, 24, scale=0.2)
    _check(jax_bbc, T.get_loss("bbc").fn, [pred, tar], (0, 1))
