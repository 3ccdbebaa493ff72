"""The yardstick's arithmetic against hand values."""

import pytest

from fbench import roofline


def test_k4_pass_1080p():
    ms, by = roofline.k4_pass_bound_ms(1920 * 1080)
    # 44 B x 2,073,600 px = 91.24 MB at 3.35 TB/s
    assert by == "bytes"
    assert ms == pytest.approx(91.2384e6 / 3.35e12 * 1e3)
    assert round(ms, 4) == 0.0272


def test_k2_counts_by_hand():
    counts = dict(tree="bvh4", node_visits=10.0, leaf_visits=2.0,
                  shaded_hits=1.0, textured_hits=1.0, sampled_hits=1.0,
                  table_bytes=0)
    ops = 100 * (10 * 86 + 2 * 472 + 109 + (13 * 208 + 90) + (264 + 36))
    ms, by = roofline.k2_bound_ms(100, counts)
    assert by == "operations"
    assert ms == pytest.approx(ops / 67e12 * 1e3)
    binary = dict(counts, tree="binary")
    ops2 = 100 * (10 * 44 + 2 * 59 + 109 + (13 * 208 + 90) + (264 + 36))
    assert roofline.k2_bound_ms(100, binary)[0] == pytest.approx(
        ops2 / 67e12 * 1e3)


def test_bound_takes_the_larger():
    assert roofline.bound_ms(3.35e9, 0)[1] == "bytes"
    assert roofline.bound_ms(0, 67e9) == (pytest.approx(1.0), "operations")
    assert roofline.bound_ms(3.35e9, 0, share=0.5)[0] == pytest.approx(2.0)
