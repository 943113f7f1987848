"""The plain reference against the port's plain path at a tiny size, both
in float32: what decides ``correct`` follows the program exactly where
neither rounds differently."""
from bench_port.tests._tiny import run_cpu, tiny_cell


def test_match_reference_follows_the_port_in_float32():
    out = run_cpu(tiny_cell("outdoor_ds.match_b4", "float32"))
    got = {c.name: c.value for c in out.checks}
    assert out.correct
    assert got["odd"] == 0 and got["illegal"] == 0 and got["kpt0_px"] == 0
    assert got["fine_outside"] == 0
    assert got["mconf"] < 1e-3 and out.readings["fine_px"] < 1e-3
    assert out.readings["count"] == 0 and out.readings["matches"] > 0


def test_train_reference_follows_the_port_in_float32():
    out = run_cpu(tiny_cell("outdoor_ds.train_b4", "float32"))
    got = {c.name: c.value for c in out.checks}
    assert out.correct
    # the first step agrees to rounding; Adam's first update is lr * sign,
    # so elements whose gradient is near zero flip and later steps part a
    # little more
    assert out.readings["loss_step1"] < 1e-5 and got["loss_c1"] < 1e-5
    assert got["gnorm1"] < 1e-4 and out.readings["grad"] < 1e-4
    assert got["grad_median"] < 1e-5 and got["delta_median"] < 1e-2
    assert out.readings["loss_c"] < 5e-3 and out.readings["delta"] < 2e-2
