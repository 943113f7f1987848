"""The OT cell's pieces on the CPU: kernel E's copied counts equal
``chip_smoke.py``'s at its shapes, the new readers read only kernel E's
kernels and only in an OT cell, and nothing new loads JAX."""
import json
import os
import subprocess
import sys

import pytest

from bench_port import core, trace
from bench_port.counts import kernels as K
from bench_port.counts.model_flops import pair_forward
from bench_port.counts.sinkhorn import pair_forward_ot, sinkhorn

sys.path.insert(0, os.path.dirname(core.HERE))
import chip_smoke  # noqa: E402

READERS = core.metric_readers()
C, L = 256, 4800


@pytest.mark.parametrize("B,prefilter,want_ms", [(1, False, 0.0477),
                                                 (1, True, 0.0596),
                                                 (8, False, 0.3817)])
def test_kernel_e_matches_chip_smoke(B, prefilter, want_ms):
    # chip_smoke.py :956-957
    flops, nbytes = sinkhorn(B, L, L, prefilter=prefilter)
    assert flops == (3 + 1 + prefilter) * 2 * B * L * L * C
    assert nbytes == B * (2 * L * C * 2 + L * 9 + L * 5)
    ms, by = chip_smoke.bound_ms(flops, nbytes, chip_smoke.PEAK_BF16_FLOPS)
    assert by == "operations"
    assert K.bound_s(flops, nbytes) * 1e3 == pytest.approx(ms)
    assert ms == pytest.approx(want_ms, abs=5e-5)


def test_ot_forward_counts_one_product_more_an_iteration():
    Lc = 105 * 105
    extra = pair_forward_ot(840, 840, 2048) - pair_forward(840, 840, 2048)
    assert extra == 3 * 2 * Lc * Lc * C
    assert pair_forward_ot(840, 840, 2048) / 1e9 == pytest.approx(1969.8,
                                                                  abs=0.1)


E_NAMES = [
    "void loftr::(anonymous namespace)::bf::sinkhorn_bf16<2, 4, 3, 0>"
    "(__nv_bfloat16 const*, float*)",
    "void loftr::(anonymous namespace)::bin_kernel(float const*, int)",
    "void loftr::(anonymous namespace)::u_combine_kernel(float const*)",
    "void loftr::(anonymous namespace)::v_combine_kernel(float const*)",
    "void loftr::(anonymous namespace)::row_best_kernel(float const*)",
    "void loftr::(anonymous namespace)::col_best_kernel(float const*)",
    "void loftr::(anonymous namespace)::ot_tile_kernel<float, 0>"
    "(float const*)"]
B_NAMES = [
    "void loftr::(anonymous namespace)::bf::dual_softmax_bf16<2, 4, 3, 0>"
    "(__nv_bfloat16 const*)",
    "void loftr::(anonymous namespace)::tile_kernel<float, 1>(float const*)",
    "void loftr::(anonymous namespace)::best_combine_kernel(float const*)"]


def _ctx(cfg_name, sinkhorn_launches, dual_launches, seconds_each=1e-3):
    names = E_NAMES + B_NAMES + ["void at::native::elementwise_kernel<128>"]
    dev = [(n, 0.01 * k, 0.01 * k + seconds_each) for k, n in
           enumerate(names)]
    cfg = core.load_json("configs", cfg_name + ".json")
    return {"kind": "offline", "trace": trace.Trace(1.0, dev, []),
            "launches": {"sinkhorn": sinkhorn_launches,
                         "dual_softmax": dual_launches},
            "rate": 80.0, "window_s": 1.0, "cfg": cfg, "B": 4,
            "L": 11025, "S": 11025, "K": 2048, "H": 840, "W": 840}


def test_sinkhorn_roofline_reads_kernel_e_by_base_name():
    ctx = _ctx("outdoor_ot", 2, 0)
    f, b = sinkhorn(4, 11025, 11025)
    want = 100.0 * K.bound_s(2 * f, 2 * b) / (len(E_NAMES) * 1e-3)
    assert READERS["sinkhorn_roofline"].read(ctx) == pytest.approx(want)
    # kernel B's reader takes none of E's kernels: its own base names only
    got_b = trace.device_seconds(ctx["trace"], lambda n: trace.kernel_base(
        n) in READERS["dual_softmax_roofline"].KERNELS)
    assert got_b == pytest.approx(len(B_NAMES) * 1e-3)


def test_ot_readers_are_silent_in_a_dual_softmax_cell():
    ctx = _ctx("outdoor_ds", 0, 2)
    assert READERS["sinkhorn_roofline"].read(ctx) is None
    assert READERS["mfu.match_ot"].read(ctx) is None
    assert READERS["mfu.match"].read(ctx) is not None
    ctx = _ctx("outdoor_ot", 2, 0)
    assert READERS["dual_softmax_roofline"].read(ctx) is None
    train = dict(ctx, kind="train")
    assert READERS["sinkhorn_roofline"].read(train) is None
    assert READERS["mfu.match_ot"].read(train) is None


def test_mfu_match_ot_counts_the_sinkhorn_products():
    ctx = _ctx("outdoor_ot", 2, 0)
    want = 100.0 * pair_forward_ot(840, 840, 2048) * 80.0 / 989e12
    assert READERS["mfu.match_ot"].read(ctx) == pytest.approx(want)


def test_the_new_files_load_no_forbidden_module():
    code = (
        "import sys, json\n"
        "from bench_port import control_ot, core\n"
        "from bench_port.generators import offline_ot\n"
        "from bench_port.reference import loftr_ot_plain\n"
        "from bench_port.counts import sinkhorn\n"
        "core.metric_readers()\n"
        "core.load_cell('outdoor_ot.match_ot_b4')\n"
        "print(json.dumps(core.forbidden_loaded(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code],
                         cwd=os.path.dirname(core.HERE),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
