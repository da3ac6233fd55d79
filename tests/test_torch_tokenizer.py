"""The port's CLIP BPE tokenizer against the JAX package's, on the CPU.

Ids on `tests/fixtures/bpe_captions.txt` with a table written by the JAX
`tools/make_fixture.py write_bpe_table` (native core and Python path);
the merges the port learns against JAX's; truncation and padding; a
Unicode corpus and a fuzz of the split against JAX's `regex` pattern;
the native core's fallback flags; the port's tokenizer with `regex` made
unimportable; the table search and its error; `InferenceAPI` and
`Trainer` with `tokenizer=None`. All exact.
"""

import gzip
import os
import random
import string
import subprocess
import sys

import numpy as np
import pytest
import regex
import torch

from fashionern_aaai2024_tpu.models.clip import tokenizer as JT
from fashionern_aaai2024_tpu.tools.make_fixture import write_bpe_table as jax_write_bpe_table
from fashionern_aaai2024_tpu_torch.models.clip import tokenizer as TT
from fashionern_aaai2024_tpu_torch.native.tokenizer import NativeBPE

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "bpe_captions.txt")


def _captions() -> list[str]:
    with open(FIXTURE, encoding="utf-8") as f:
        return [ln.rstrip("\n") for ln in f if ln.strip() and not ln.startswith("#")]


# letters of several scripts, No / Nl numerics, combining marks, HTML
# entities, special-token literals (any case, long s), other whitespace
UNICODE_CORPUS = [
    "café crème brûlée", "naïve façade", "Ελληνικά γράμματα", "Кириллица и латиница",
    "中文字符 and 日本語のテキスト", "한국어 문장", "x² + y³ = z⁴", "chapter Ⅻ and Ⅳ",
    "½ price ¾ off", "é combining acute", "aͅb and ͅ", "emoji 👗👠 dress",
    "tab\u3000ideographic\u2003em space", "nbsp\u00a0here", "rec\u001esep\u001funit",
    "a&amp;b &lt;tag&gt; &quot;q&quot;", "&#39;s and &amp;amp;", "<|startoftext|> hi",
    "<|EndOfText|> end", "<|ſtartoftext|>", "it'ſ and it'S and IT'LL",
    "Ⅷ'd ²'ll", "dots...!?', «quotes» — dash", "Ünïcödé ÅSTRÖM", "ǅ titlecase ǈ",
    "٣٤ arabic-indic digits ٥", "ⅰⅱⅲ roman small", "\u2028line\u2029para",
]


@pytest.fixture(scope="module")
def table(tmp_path_factory):
    """A table written by the JAX package from the fixture captions."""
    root = tmp_path_factory.mktemp("bpe")
    return jax_write_bpe_table(str(root), _captions() + UNICODE_CORPUS, n_merges=400)


@pytest.fixture(scope="module")
def pair(table):
    return JT.SimpleTokenizer(bpe_path=table), TT.SimpleTokenizer(bpe_path=table)


@pytest.mark.parametrize("path", ["native", "python"])
def test_ids_match_jax_on_the_fixture_captions(pair, path):
    jax_tok, port_tok = pair
    caps = _captions()
    want = jax_tok(caps, 77)
    got = port_tok(caps, 77) if path == "native" else port_tok.python_ids(caps, 77)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert (got[:, 0] == port_tok.sot_token).all()


@pytest.mark.parametrize("n_merges", [64, 400])
def test_learned_merges_match_jax(tmp_path, n_merges):
    caps = _captions()
    path = jax_write_bpe_table(str(tmp_path), caps, n_merges=n_merges)
    assert TT.learn_merges(caps, n_merges) == TT.read_merges(path)
    (tmp_path / "port").mkdir()
    port_path = TT.write_bpe_table(str(tmp_path / "port"), caps, n_merges=n_merges)
    with gzip.open(path, "rt") as a, gzip.open(port_path, "rt") as b:
        assert a.read() == b.read()


def test_truncation_and_padding(pair):
    jax_tok, port_tok = pair
    texts = ["is red", "x " * 200, "a" * 500, "", "has a floral print and longer sleeves"]
    for ctx in (77, 16, 5):
        got = port_tok(texts, ctx)
        np.testing.assert_array_equal(got, jax_tok(texts, ctx))
        np.testing.assert_array_equal(port_tok.python_ids(texts, ctx), got)
        assert got.shape == (len(texts), ctx)
        assert got[1, -1] == port_tok.eot_token and got[2, -1] == port_tok.eot_token
        short = port_tok(["is red"], ctx)[0]
        n = int(np.count_nonzero(short))
        assert short[n - 1] == port_tok.eot_token and not short[n:].any()
    np.testing.assert_array_equal(port_tok("is red", 77), port_tok(["is red"], 77))
    assert port_tok([], 77).shape == (0, 77)


def test_unicode_corpus_matches_jax(pair):
    """The stdlib split against JAX's `regex` pattern, and the ids (each
    of these rows takes the Python path) against JAX's."""
    jax_tok, port_tok = pair
    for text in UNICODE_CORPUS:
        clean = JT.whitespace_clean(JT.basic_clean(text)).lower()
        assert TT.whitespace_clean(TT.basic_clean(text)).lower() == clean, text
        assert TT._split(clean) == regex.findall(JT._PAT, clean), text
    np.testing.assert_array_equal(port_tok(UNICODE_CORPUS, 77), jax_tok(UNICODE_CORPUS, 77))
    assert port_tok.decode(port_tok.encode("café crème")) == "café crème "


def test_split_fuzz_matches_regex():
    """Random strings over letters, numbers, marks, punctuation, symbols
    and every kind of whitespace the two definitions of \\s disagree on."""
    pool = (string.ascii_letters + string.digits + string.punctuation + " \t\n'"
            + "éüßçÆøĳ\u017f\u0301\u0308\u0345²³¹⁴½ⅫⅰⅣ٣٤〇一二中日한ΩωЖж"
            + "\u00a0\u1680\u2000\u2003\u200a\u200b\u2028\u2029\u202f\u205f\u3000\u0085"
            + "\u001c\u001d\u001e\u001f\u00ad\ufeff"
            + "«»—–…‘’“”€£¥©®™°±×÷§¶•·👗")
    rng = random.Random(11)
    for _ in range(2000):
        text = "".join(rng.choice(pool) for _ in range(rng.randint(0, 40)))
        if rng.random() < 0.2:
            text += rng.choice(["<|startoftext|>", "<|endoftext|>", "'s", "'ll", "'ſ"])
        assert TT.whitespace_clean(text) == JT.whitespace_clean(text), repr(text)
        low = text.lower()
        assert TT._split(low) == regex.findall(JT._PAT, low), repr(text)


def test_native_flags_what_it_does_not_cover(pair):
    _, port_tok = pair
    _, flags = NativeBPE(port_tok._merges).encode_batch(
        ["plain ascii", "a&b", "café", "<|endoftext|>", "x\u001ey"], 16)
    assert flags.tolist() == [False, True, True, True, True]


def test_ascii_fuzz_native_equals_python(pair):
    _, port_tok = pair
    rng = random.Random(7)
    alphabet = string.ascii_letters + string.digits + string.punctuation + "  '"
    fuzz = ["".join(rng.choice(alphabet) for _ in range(rng.randint(0, 60)))
            for _ in range(500)]
    np.testing.assert_array_equal(port_tok(fuzz, 77), port_tok.python_ids(fuzz, 77))


def test_tokenizer_runs_without_regex(pair, table):
    """The port does not depend on `regex`: it never imports it."""
    _, port_tok = pair
    texts = _captions()[:8] + UNICODE_CORPUS[:8]
    code = ("import sys, json\n"
            "sys.modules['regex'] = None\n"
            "from fashionern_aaai2024_tpu_torch.models.clip.tokenizer import SimpleTokenizer\n"
            f"tok = SimpleTokenizer(bpe_path={table!r})\n"
            f"print(json.dumps(tok({texts!r}, 77).tolist()))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=os.path.dirname(os.path.dirname(__file__)))
    assert out.returncode == 0, out.stderr
    np.testing.assert_array_equal(np.array(eval(out.stdout)), port_tok(texts, 77))


def test_missing_table_raises_naming_the_ways_to_give_one(monkeypatch):
    monkeypatch.setattr(TT, "default_bpe_path", lambda: None)
    with pytest.raises(FileNotFoundError) as err:
        TT.SimpleTokenizer()
    for word in ("bpe_path=", "merges=", "FASHIONERN_BPE_PATH"):
        assert word in str(err.value)


def test_table_search_and_default_tokenize(monkeypatch, tmp_path, table):
    monkeypatch.setenv("FASHIONERN_BPE_PATH", table)
    assert TT.default_bpe_path() == table
    TT._default_tokenizer.cache_clear()
    try:
        np.testing.assert_array_equal(TT.tokenize(["is red"], 16),
                                      TT.SimpleTokenizer(bpe_path=table)(["is red"], 16))
    finally:
        TT._default_tokenizer.cache_clear()
    monkeypatch.delenv("FASHIONERN_BPE_PATH")
    monkeypatch.setenv("HF_HOME", str(tmp_path))
    hub = tmp_path / "hub" / "models--x" / "snapshots" / "abc"
    hub.mkdir(parents=True)
    (hub / TT.BPE_FILENAME).write_bytes(open(table, "rb").read())
    if TT.default_bpe_path() is not None:  # an installed open_clip / clip comes first
        assert TT.default_bpe_path().endswith(TT.BPE_FILENAME)


def test_api_and_trainer_default_to_the_port_tokenizer(monkeypatch, tmp_path, table):
    """`tokenizer=None`: the port's `tokenize`, which finds the table at
    the first call, or raises FileNotFoundError there when there is none."""
    from fashionern_aaai2024_tpu_torch.models.clip import config as torch_config
    from fashionern_aaai2024_tpu_torch.models.composed import ComposedCIRModel
    from fashionern_aaai2024_tpu_torch.retrieval.evaluate import InferenceAPI
    from fashionern_aaai2024_tpu_torch.train.trainer import DatasetPlugin, TrainConfig, Trainer
    from torch_port_helpers import small_config

    model = ComposedCIRModel(small_config(torch_config))
    TT._default_tokenizer.cache_clear()
    monkeypatch.setattr(TT, "default_bpe_path", lambda: None)
    api = InferenceAPI(model, device="cpu", context_length=16)
    with pytest.raises(FileNotFoundError):
        api.tokenize(["is red"])
    monkeypatch.setattr(TT, "default_bpe_path", lambda: table)
    TT._default_tokenizer.cache_clear()
    try:
        np.testing.assert_array_equal(api.tokenize(["is red"]),
                                      TT.SimpleTokenizer(bpe_path=table)(["is red"], 16))
        trainer = Trainer(TrainConfig(batch_size=2, num_workers=0, ckpt_dir=str(tmp_path)),
                          device="cpu", model=model, train_dataset=[{}] * 4,
                          plugin=DatasetPlugin("x", lambda c: None, lambda b, r: []))
        assert trainer.tokenizer is TT.tokenize
    finally:
        TT._default_tokenizer.cache_clear()
    assert torch.is_tensor(next(model.parameters()))
