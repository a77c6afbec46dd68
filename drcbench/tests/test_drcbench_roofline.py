"""The counts of work depend on the job's shapes only, and the bound is the
larger of the bytes' and the operations' times."""

import pytest

from drcbench.core import roofline


def test_bound_takes_the_larger():
    t, by = roofline.bound(3.35e12, 1.0)
    assert by == "bytes" and t == pytest.approx(1.0)
    t, by = roofline.bound(1.0, 67e12)
    assert by == "operations" and t == pytest.approx(1.0)


def test_rans_lanes_work_counts_sizes():
    streams = [{"symbols": 100, "table_entries": 10, "payload_bytes": 70},
               {"symbols": 50, "table_entries": 4, "payload_bytes": 33}]
    nbytes, ops = roofline.rans_lanes_work(streams)
    assert nbytes == 4 * 150 + 4 * 14 + 103
    assert ops == roofline.RANS_OPS_PER_SYMBOL * 150
    # the same sizes are the same work, whatever else a stream carries
    other = [dict(s, precision=20, h={"x": 1}) for s in streams]
    assert roofline.rans_lanes_work(other) == (nbytes, ops)


def test_normal_encode_work_counts_sizes():
    nbytes, ops = roofline.normal_encode_work(meshes=2, vertices=16,
                                              faces=18)
    assert nbytes == 2 * 16 * 33 + 3 * 18 * 12
    assert ops == 2 * (3 * 18 * roofline.RING_OPS_PER_ENTRY
                       + 16 * roofline.NORMAL_OPS_PER_VERTEX)
    assert roofline.normal_encode_work(4, 16, 18)[0] > nbytes
