"""The port's launch path on the CPU (`ops/common.py`): the operand checks
every wrapper runs before a launch, the bound entry table, and the
arguments B11 (`layer_norm`), B12 (`combiner_apply`), the GEMM
(`launch_gemm`, fp32 and bf16) and B4 (`bbc_rowloss`) hand to their C
entry points, recorded by a fake card instead of launched. The kernels
themselves are held on the card (`tests/test_torch_cuda.py`)."""

import numpy as np
import pytest
import torch

from fashionern_aaai2024_tpu_torch.models.ern.fusion import CombinerSimple
from fashionern_aaai2024_tpu_torch.ops import combiner as Cb
from fashionern_aaai2024_tpu_torch.ops import common
from fashionern_aaai2024_tpu_torch.ops import layernorm as LN
from fashionern_aaai2024_tpu_torch.ops import losses as L


def _t(*shape, dtype=torch.float32, seed=0):
    g = np.random.default_rng(seed)
    return torch.tensor(g.standard_normal(shape), dtype=dtype)


def test_operand_check_passes_and_names_the_device():
    x, w = _t(4, 8), _t(8)
    assert common.check_cuda_operands("op", x, w) == x.get_device() == -1


@pytest.mark.parametrize("fault,error,match", [
    ("mixed dtype", TypeError, "mixed dtypes"),
    ("unsupported dtype", TypeError, "not supported"),
    ("not contiguous", ValueError, "not contiguous"),
    ("requires grad", RuntimeError, "requires grad"),
])
def test_operand_check_raises(fault, error, match):
    """One pass over the operands still raises each fault with its
    message, on any operand, not only the first."""
    x, w = _t(4, 8), _t(8)
    if fault == "mixed dtype":
        w = w.bfloat16()
    elif fault == "unsupported dtype":
        x, w = x.half(), w.half()
    elif fault == "not contiguous":
        w = _t(8, 2)[:, 0]
    else:
        w = w.requires_grad_()
    with pytest.raises(error, match=match):
        common.check_cuda_operands("op", x, w)


def test_operand_check_allows_grad_operands_without_grad_mode():
    w = _t(8).requires_grad_()
    with torch.no_grad():
        common.check_cuda_operands("op", _t(4, 8), w)
    with pytest.raises(RuntimeError, match="requires grad"):
        common.check_no_grad("op", None, w)


def test_dispatch_rule():
    assert common.is_cuda(_t(2)) is False
    with pytest.raises(ValueError, match="meta"):
        common.is_cuda(torch.zeros(2, device="meta"))


def test_launch_calls_the_bound_entry_and_raises_its_error(monkeypatch):
    """A launch goes through the table bound once (no library load a
    call) and turns a nonzero cudaError_t into an exception."""
    calls = []

    def entry(*args):
        calls.append(args)
        return 700 if args[0] == "fail" else 0

    def no_load():
        raise AssertionError("the library is loaded once, not per launch")

    monkeypatch.setattr(common, "_ENTRY", {"fern_layernorm": entry})
    monkeypatch.setattr(common.LIBRARY, "load", no_load)
    common.launch("fern_layernorm", "ok", 1)
    with pytest.raises(RuntimeError, match="fern_layernorm: CUDA error 700"):
        common.launch("fern_layernorm", "fail")
    assert calls == [("ok", 1), ("fail",)]


@pytest.fixture
def fake_card(monkeypatch):
    """Every tensor counts as a CUDA tensor of a 132-SM card, and every
    launch is recorded (name, arguments) instead of run."""
    calls = []
    monkeypatch.setattr(common, "is_cuda", lambda t: True)
    monkeypatch.setattr(common, "stream_of", lambda t: 0)
    monkeypatch.setattr(common, "sm_count", lambda device: 132)
    monkeypatch.setattr(common, "launch", lambda name, *args: calls.append((name, args)))
    return calls


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_norm_launches_over_flat_rows(fake_card, dtype):
    """B11 hands the kernel the rows of x [..., W] as one flat buffer
    (no view), with a fresh output of x's shape, and counts the launch."""
    x, w, b = _t(2, 5, 24, dtype=dtype), _t(24, dtype=dtype), _t(24, dtype=dtype)
    n = LN.layer_norm.launches
    y = LN.layer_norm(x, w, b, 1e-5)
    (name, args), = fake_card
    assert name == "fern_layernorm" and LN.layer_norm.launches == n + 1
    assert args[:3] == (x.data_ptr(), w.data_ptr(), b.data_ptr())
    assert args[3] == y.data_ptr() and y.shape == x.shape and y.dtype == dtype
    assert args[4:8] == (10, 24, 1e-5, common.DTYPE_CODES[dtype])
    with pytest.raises(ValueError, match="for width 24"):
        LN.layer_norm(x, w[:8], b, 1e-5)


def _combiner(d: int, dtype=torch.float32) -> CombinerSimple:
    return CombinerSimple(d).to(dtype).eval()


@pytest.mark.parametrize("m,d,splits", [(3, 16, 1), (1, 64, 2)])
def test_combiner_fp32_launches(fake_card, m, d, splits):
    """B12 in fp32: both projections in one 3xTF32 launch into the two
    halves of the concat buffer, the hidden product (with its bias and
    ReLU, or split over K into partials that the gate kernel sums, as
    `hidden_k_slice` plans), then the gate kernel: three launches, on
    128-wide tiles without the K-tile fold."""
    module = _combiner(d)
    image, text = _t(m, d, seed=1), _t(m, d, seed=2)
    wt, bt, wi, bi, wh, bh, wo, bo = Cb._weights(module)
    p, hd = 4 * d, 8 * d
    with torch.no_grad():
        out = Cb.combiner_apply(image, text, module)
    assert [c[0] for c in fake_card] == ["fern_gemm_tf32", "fern_gemm_tf32",
                                         "fern_combiner_gate"]
    (_, proj), (_, hidden), (_, gate) = fake_card
    relu = common.ACT_CODES["relu"]
    assert proj[:7] == (*(t.data_ptr() for t in (text, wt, bt, image, wi, bi)), None)
    assert proj[8:17] == (2, m, p, d, 2 * p, relu, 32 * -(-d // 32), 128, 0)
    cat = proj[7]
    k_per = Cb.hidden_k_slice(m, hd, 2 * p, 132)
    assert -(-2 * p // k_per) == splits
    assert hidden[0] == cat and hidden[1] == wh.data_ptr() and hidden[3:7] == (None,) * 4
    assert hidden[7] == cat + 4 * m * 2 * p
    assert hidden[8:17] == (1, m, hd, 2 * p, hd, relu if splits == 1 else 0, k_per, 128, 0)
    assert hidden[2] == (bh.data_ptr() if splits == 1 else None)
    h, hp = (hidden[7], None) if splits == 1 else (None, hidden[7])
    assert gate[:2] == (h, hp) and (splits == 1 or gate[2] == splits)
    assert gate[3:9] == (bh.data_ptr(), wo.data_ptr(), bo.data_ptr(), text.data_ptr(),
                         image.data_ptr(), out.data_ptr())
    assert gate[9:12] == (m, d, hd)


def test_combiner_takes_an_empty_batch(fake_card):
    """M = 0 plans one K slice and launches on zero rows (each C entry
    returns at once) instead of dividing by zero tiles."""
    module = _combiner(16)
    with torch.no_grad():
        out = Cb.combiner_apply(torch.zeros(0, 16), torch.zeros(0, 16), module)
    assert out.shape == (0, 16)
    assert [c[0] for c in fake_card] == ["fern_gemm_tf32", "fern_gemm_tf32",
                                         "fern_combiner_gate"]
    assert fake_card[1][1][9] == 0 and fake_card[1][1][14] == 8 * 16


def test_combiner_refuses_what_the_kernels_cannot_take(fake_card):
    """d not a multiple of 8, and an operand that does not start on a
    16-byte boundary (TMA's rule), raise before any launch."""
    with torch.no_grad():
        with pytest.raises(ValueError, match="multiples of 8"):
            Cb.combiner_apply(_t(2, 12), _t(2, 12), _combiner(12))
        flat = _t(2 * 16 + 1)
        with pytest.raises(ValueError, match="16 bytes"):
            Cb.combiner_apply(flat[1:].view(2, 16), _t(2, 16), _combiner(16))
    assert not fake_card


# (M, N, tile the rule picks on 132 SMs): B7's query projection at b = 1
# (91 rows; d = 640 and 512) and b = 32 (2,912 rows), the text towers'
# products at b = 1 (77 rows), the ViT-B-16 gallery batch (6,304 rows);
# a tie of waves x cost keeps the wider tile (2,912 x 1,536, 6,304 x 768)
F32_TILE_CASES = [(91, 1920, 32), (91, 1536, 32), (2912, 1920, 128), (2912, 1536, 128),
                  (77, 1536, 32), (77, 512, 32), (77, 2048, 32), (6304, 2304, 128),
                  (6304, 768, 128)]


@pytest.mark.parametrize("m,n,tile", F32_TILE_CASES)
def test_fp32_gemm_launches_the_3xtf32_entry_with_the_rules_tile(fake_card, m, n, tile):
    """fp32 `launch_gemm` reaches `fern_gemm_tf32` (one problem, no K
    split: k_per covers K in whole 32-deep K tiles, each K tile folded
    into the sum) with `f32_tile`'s width, its bias, residual, activation
    and a fresh output; a forced width goes through as it is."""
    k = 640
    a, w, b, res = _t(m, k), _t(n, k, seed=1), _t(n, seed=2), _t(m, n, seed=3)
    assert common.f32_tile(m, n, 132) == tile
    forced = 128 if tile != 128 else 64
    out = common.launch_gemm(a, w, b, residual=res, activation="quick_gelu")
    common._gemm(a, w, None, None, None, None, forced)
    (name, args), (name2, args2) = fake_card
    assert name == name2 == "fern_gemm_tf32"
    assert args[:8] == (a.data_ptr(), w.data_ptr(), b.data_ptr(), None, None, None,
                        res.data_ptr(), out.data_ptr())
    assert args[8:17] == (1, m, n, k, n, common.ACT_CODES["quick_gelu"], k, tile, 1)
    assert args2[2] is None and args2[6] is None and args2[13] == 0
    assert args2[15:17] == (forced, 1)


def test_fp32_gemm_tile_rule_counts_waves():
    """`f32_tile` takes the width whose waves of tiles, each at its cost
    relative to a 128-wide tile, take least time, and the wider of two
    that tie: never a narrower one when the 128-wide tiles already fill
    as few waves."""
    costs = dict(common._F32_TILES)
    for sms in (1, 78, 132):
        for m in (1, 77, 91, 128, 129, 1000, 2464, 2912, 6304):
            for n in (512, 768, 1536, 1920, 2304, 3072):
                rows = -(-m // 128)
                time = {bn: -(-(rows * -(-n // bn)) // sms) * c for bn, c in costs.items()}
                tile = common.f32_tile(m, n, sms)
                assert time[tile] == min(time.values())
                assert all(time[bn] > time[tile] for bn in costs if bn > tile)


@pytest.mark.parametrize("dtype", [torch.bfloat16])
def test_bf16_gemm_launches_the_bf16_entry(fake_card, dtype):
    """bf16 `launch_gemm` stays on `fern_gemm`, tile 0 (the kernel's own
    rule)."""
    a, w = _t(77, 512, dtype=dtype), _t(1536, 512, dtype=dtype, seed=1)
    out = common.launch_gemm(a, w, None)
    (name, args), = fake_card
    assert name == "fern_gemm" and args[4] == out.data_ptr()
    assert args[5:12] == (77, 1536, 512, 1536, 0, common.DTYPE_CODES[dtype], 0)


@pytest.mark.parametrize("b,d", [(13, 24), (1024, 512), (129, 513), (1000, 30)])
def test_bbc_rowloss_launch_pads_d_to_a_multiple_of_4(fake_card, b, d):
    """B4 hands its C entry d % 4 == 0 (TMA's 16-byte row stride): a d that
    is not goes through zero-padded copies of both operands; an aligned d
    goes through the operands themselves. The split plan is the
    wrapper's."""
    pred, tar = _t(b, d, seed=4), _t(b, d, seed=5)
    n0 = L.bbc_rowloss.launches
    L.bbc_rowloss(pred, tar)
    (name, args), = fake_card
    assert name == "fern_bbc_rowloss" and L.bbc_rowloss.launches == n0 + 1
    width = d + -d % 4
    assert args[6:9] == (b, width, L.TEMPERATURE)
    assert args[9:11] == L.split_plan(b, 132)
    if width == d:
        assert args[:2] == (pred.data_ptr(), tar.data_ptr())
    else:
        assert pred.data_ptr() not in args[:2] and tar.data_ptr() not in args[:2]
