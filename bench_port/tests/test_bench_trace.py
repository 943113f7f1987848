"""Idle share, busy time and gap labels on synthetic traces, a window
that holds a stall among them."""

import pytest

from bench_port import trace
from bench_port.metrics._common import idle


def _trace():
    # two streams overlap in [1, 2]; a stall from 4 to 7 s while the host
    # sits in "bench.wait"; short launch gaps between 7 and 8
    dev = [("kA", 0.0, 2.0), ("kB", 1.0, 3.0), ("kC", 3.0, 4.0),
           ("kA", 7.0, 7.5), ("kA", 7.50005, 8.0)]
    host = [("bench.window_step", 0.0, 10.0), ("bench.wait", 4.0, 7.0),
            ("aten::copy_", 5.0, 5.2)]
    return trace.Trace(10.0, dev, host)


def test_busy_is_the_union_over_streams():
    tr = _trace()
    assert trace.busy_s(tr) == pytest.approx(4.0 + 0.99995)
    assert trace.idle_gaps(tr)[0] == (4.0, 7.0)


def test_idle_share_counts_the_stall():
    ctx = {"kind": "offline", "trace": _trace(), "window_s": 10.0}
    assert idle(ctx, "offline") == pytest.approx(100 * (1 - 4.99995 / 10))
    assert idle(ctx, "train") is None


def test_gaps_are_labelled_by_the_innermost_host_event():
    got = dict(trace.gaps_by_host(_trace()))
    assert got["bench.wait"] == pytest.approx(3.0)
    assert got["bench.window_step"] == pytest.approx(2.0)   # 8 .. 10 s
    assert got["gaps under 0.1 ms"] == pytest.approx(5e-5)


def test_top_ops_and_kernel_names():
    ops = dict(trace.top_ops(_trace()))
    assert ops["kA"] == pytest.approx(2.0 + 0.5 + 0.49995)
    assert trace.kernel_base(
        "void loftr::(anonymous namespace)::bf::dual_softmax_bf16<4, 8, 2, "
        "1>(__nv_bfloat16 const*, float*)") == "dual_softmax_bf16"
    assert trace.kernel_base("loftr::(anonymous namespace)::kv_partial_bf16"
                             "(__nv_bfloat16 const*)") == "kv_partial_bf16"
