"""The split of a trace's device work by layer marks (`trace.split_layers`)."""

from __future__ import annotations

import pytest

from cirbench.trace import MARK_KERNEL, OUTSIDE, split_layers

MARK = f"void {MARK_KERNEL}(long)"


def test_work_between_a_layers_marks_is_that_layers_whatever_launched_it():
    # (start us, end us, name, stream): a tower call, then a refine call,
    # with work outside both and a copy on another stream
    device = [(0, 5, "cast", 7), (10, 11, MARK, 7), (12, 40, "gemm", 7), (40, 60, "attn", 7),
              (61, 62, MARK, 7), (62, 70, "cast", 7), (70, 71, MARK, 7), (71, 80, "refine", 7),
              (81, 82, MARK, 7), (15, 45, "Memcpy HtoD", 9)]
    labels = [("tower", True), ("tower", False), ("refine", True), ("refine", False)]
    seconds, count = split_layers(device, labels)
    assert count == {"tower": 1, "refine": 1}
    assert seconds["tower"] == pytest.approx(48e-6)
    assert seconds["refine"] == pytest.approx(9e-6)
    assert seconds[OUTSIDE] == pytest.approx(13e-6)


def test_nested_layers_give_their_work_to_the_innermost():
    device = [(0, 1, MARK, 3), (1, 3, "a", 3), (3, 4, MARK, 3), (4, 9, "b", 3), (9, 10, MARK, 3),
              (10, 12, "c", 3), (12, 13, MARK, 3)]
    labels = [("outer", True), ("inner", True), ("inner", False), ("outer", False)]
    seconds, _ = split_layers(device, labels)
    assert seconds == pytest.approx({"outer": 4e-6, "inner": 5e-6, OUTSIDE: 0.0})


@pytest.mark.parametrize("labels", [[("tower", True)],
                                    [("tower", True), ("refine", False)], []])
def test_marks_that_do_not_match_their_labels_give_nothing(labels):
    device = [(0, 1, MARK, 1), (2, 3, "gemm", 1), (4, 5, MARK, 1)]
    assert split_layers(device, labels) is None


def test_marks_on_two_streams_give_nothing():
    device = [(0, 1, MARK, 1), (2, 3, "gemm", 1), (4, 5, MARK, 2)]
    assert split_layers(device, [("tower", True), ("tower", False)]) is None
