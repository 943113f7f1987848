"""PyTorch port: the serving subsystem (``loftr_tpu_torch.serve``) against
the JAX package's, on tests/test_serve.py's tiny ``SMALL`` model: bucket
selection, preprocessing (bit for bit), micro-batching results against
direct model calls of both frameworks, flush and rung behaviour, the
saturation gate and the starvation bound, cancelled futures, errors, stats
and the once-per-batch result fetch."""
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loftr_tpu import LoFTR as JaxLoFTR
from loftr_tpu import MatchInput as JaxMatchInput
from loftr_tpu import get_config as jax_get_config
from loftr_tpu.serve import preprocess_to_bucket as jax_preprocess
from loftr_tpu.serve.service import _to_gray as jax_to_gray
from loftr_tpu_torch import LoFTR, MatchInput
from loftr_tpu_torch.serve import (MatchingService, pick_bucket,
                                   preprocess_to_bucket)
from loftr_tpu_torch.serve.service import _safe_resolve, _to_gray
from loftr_tpu_torch.utils.weights import state_dict_from_jax

# tests/test_serve.py:17-28
SMALL = {
    "loftr": {
        "dtype": "float32",
        "backbone": {"initial_dim": 8, "block_dims": (8, 12, 16)},
        "coarse": {"d_model": 16, "nhead": 2,
                   "layer_names": ("self", "cross")},
        "fine": {"d_model": 8, "nhead": 2,
                 "layer_names": ("self", "cross"), "window_size": 5},
        "match_coarse": {"max_matches": 16, "use_pallas": False},
    }
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    """JAX's seeded init of SMALL (as tests/test_serve.py) and its port
    state dict."""
    model = JaxLoFTR(jax_get_config("default", SMALL).loftr)
    inp = JaxMatchInput(image0=jnp.zeros((1, 64, 64, 1), jnp.float32),
                        image1=jnp.zeros((1, 64, 64, 1), jnp.float32))
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), inp)
    variables = jax.tree.map(np.asarray, dict(variables))
    return variables, state_dict_from_jax(variables), model


def _service(weights, **kw):
    defaults = dict(preset="default", dtype="float32", use_pallas=False,
                    overrides=SMALL, buckets=((64, 64), (96, 96)),
                    batch_sizes=(1, 2, 4), flush_ms=20.0, device="cpu")
    defaults.update(kw)
    return MatchingService(weights[1], **defaults)


def _jax_direct(weights, img0, img1):
    """JAX's direct single-pair forward on the padded float inputs."""
    variables, _, model = weights
    inp = JaxMatchInput(
        image0=jnp.asarray(img0)[None, :, :, None],
        image1=jnp.asarray(img1)[None, :, :, None],
        mask0=jnp.ones((1, 8, 8), bool), mask1=jnp.ones((1, 8, 8), bool),
        scale0=jnp.ones((1, 2)), scale1=jnp.ones((1, 2)))
    out = jax.jit(model.apply)(variables, inp)
    valid = np.asarray(out.valid)[0]
    return (np.asarray(out.mkpts0_f)[0][valid],
            np.asarray(out.mkpts1_f)[0][valid])


def _port_direct(weights, svc, img0, img1):
    """The port's direct single-pair forward of the service's config, in a
    thread of its own as the service's forwards are (a CPU thread's
    intra-op thread count sets its summation order)."""
    model = LoFTR(svc.config.loftr)
    model.load_state_dict(weights[1])
    res = []

    def run():
        with torch.inference_mode():
            out = model.eval()(MatchInput(
                image0=torch.from_numpy(img0)[None, :, :, None],
                image1=torch.from_numpy(img1)[None, :, :, None]))
        valid = out.valid[0].numpy()
        res.extend((out.mkpts0_f[0].numpy()[valid],
                    out.mkpts1_f[0].numpy()[valid],
                    out.coarse.mconf[0].numpy()[valid]))

    th = threading.Thread(target=run)
    th.start()
    th.join()
    return res


def test_pick_bucket():
    buckets = ((64, 64), (96, 128))
    assert pick_bucket(buckets, [(60, 60), (64, 64)]) == (64, 64)
    assert pick_bucket(buckets, [(60, 100)]) == (96, 128)
    assert pick_bucket(buckets, [(500, 500)]) == (96, 128)


def test_preprocess_to_bucket_geometry():
    img = np.random.RandomState(0).rand(48, 56).astype(np.float32)
    padded, mask, scale = preprocess_to_bucket(img, (64, 64))
    assert padded.shape == (64, 64) and mask.shape == (8, 8)
    np.testing.assert_allclose(scale, [1.0, 1.0])
    assert mask[:48 // 8, :56 // 8].all()
    assert not mask[48 // 8:, :].any() and not mask[:, 56 // 8:].any()
    np.testing.assert_allclose(padded[:48, :56], img)
    assert (padded[48:, :] == 0).all()
    big = np.random.RandomState(1).rand(128, 160).astype(np.float32)
    padded, mask, scale = preprocess_to_bucket(big, (64, 64))
    assert padded.shape == (64, 64) and (scale >= 1.0).all()


@pytest.mark.parametrize("shape,dtype,bucket", [
    ((48, 56), np.float32, (64, 64)), ((128, 160), np.float32, (64, 64)),
    ((130, 97), np.uint8, (96, 96)), ((480, 640), np.uint8, (480, 640)),
    ((700, 1000), np.uint8, (480, 640)), ((33, 200), np.float32, (96, 128))])
def test_preprocess_matches_jax_bit_for_bit(shape, dtype, bucket):
    r = np.random.RandomState(sum(shape))
    img = (r.rand(*shape) * (255 if dtype == np.uint8 else 1)).astype(dtype)
    got = preprocess_to_bucket(img, bucket)
    want = jax_preprocess(img, bucket)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("wire", [np.float32, np.uint8])
def test_to_gray_matches_jax_bit_for_bit(wire):
    r = np.random.RandomState(3)
    f_rgb = r.rand(16, 16, 3).astype(np.float32)
    for img in (f_rgb, np.round(f_rgb * 255).astype(np.uint8),
                (r.rand(16, 16) * 255).astype(np.uint8),
                r.rand(16, 16, 1).astype(np.float32),
                r.rand(16, 16).astype(np.float64)):
        got, want = _to_gray(img, wire), jax_to_gray(img, wire)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_service_matches_direct_call(weights):
    """float32 wire: exact against the port's direct call, and within
    tests/test_serve.py's bar of JAX's."""
    svc = _service(weights, wire_dtype="float32")
    rng = np.random.RandomState(3)
    img0 = rng.rand(64, 64).astype(np.float32)
    img1 = rng.rand(64, 64).astype(np.float32)
    with svc:
        res = svc.match(img0, img1)
    k0, k1, conf = _port_direct(weights, svc, img0, img1)
    np.testing.assert_array_equal(res["mkpts0"], k0)
    np.testing.assert_array_equal(res["mkpts1"], k1)
    np.testing.assert_array_equal(res["mconf"], conf)
    j0, j1 = _jax_direct(weights, img0, img1)
    np.testing.assert_allclose(res["mkpts0"], j0, atol=1e-4)
    np.testing.assert_allclose(res["mkpts1"], j1, atol=1e-4)


def test_service_uint8_wire_matches_direct_call(weights):
    """uint8 wire: the /255 on the device equals the host division."""
    svc = _service(weights)
    rng = np.random.RandomState(4)
    img0 = rng.randint(0, 255, (64, 64), dtype=np.uint8)
    img1 = rng.randint(0, 255, (64, 64), dtype=np.uint8)
    with svc:
        res = svc.match(img0, img1)
    f0 = img0.astype(np.float32) / 255.0
    f1 = img1.astype(np.float32) / 255.0
    k0, k1, _ = _port_direct(weights, svc, f0, f1)
    np.testing.assert_array_equal(res["mkpts0"], k0)
    np.testing.assert_array_equal(res["mkpts1"], k1)
    j0, j1 = _jax_direct(weights, f0, f1)
    np.testing.assert_allclose(res["mkpts0"], j0, atol=1e-4)
    np.testing.assert_allclose(res["mkpts1"], j1, atol=1e-4)


def test_service_batches_and_pads(weights):
    svc = _service(weights, flush_ms=50.0)
    rng = np.random.RandomState(5)
    imgs = [(rng.rand(64, 64).astype(np.float32),
             rng.rand(64, 64).astype(np.float32)) for _ in range(3)]
    with svc:
        futs = [svc.submit(a, b) for a, b in imgs]
        results = [f.result(timeout=120) for f in futs]
    for r in results:
        assert r["mkpts0"].shape == r["mkpts1"].shape
        assert r["mkpts0"].ndim == 2 and r["mkpts0"].shape[1] == 2
    snap = svc.stats.snapshot()
    assert snap["requests"] == 3
    assert 1 <= snap["batches"] <= 3
    assert snap["latency_ms_p50"] is not None


def test_service_mixed_buckets_and_min_conf(weights):
    svc = _service(weights)
    rng = np.random.RandomState(7)
    small = rng.rand(60, 60).astype(np.float32)
    large = rng.rand(90, 90).astype(np.float32)
    with svc:
        f_small = svc.submit(small, small)
        f_large = svc.submit(large, large)
        f_conf = svc.submit(small, small, min_conf=2.0)  # > any conf
        r_small, r_large = f_small.result(120), f_large.result(120)
        r_conf = f_conf.result(120)
    assert r_small["mkpts0"].dtype == np.float32
    assert r_large["mkpts0"].shape[1] == 2
    assert r_conf["mkpts0"].shape[0] == 0


def test_service_rejects_after_close(weights):
    svc = _service(weights)
    svc.close()
    with pytest.raises(RuntimeError):
        svc.submit(np.zeros((64, 64), np.float32),
                   np.zeros((64, 64), np.float32))


def test_service_mesh_splits_rows_over_devices(weights):
    """tests/test_serve.py's mesh test on two CPU "devices": one replica
    each, every batch's rows split between them, rungs rounded up to
    multiples of 2; the matches within that test's 1e-3 px of the direct
    single-pair call; interleave packing.  A mesh without a 'data' axis
    raises."""
    svc = _service(weights, mesh={"data": ["cpu", "cpu"]}, flush_ms=40.0,
                   wire_dtype="float32")
    assert svc.batch_sizes == (2, 4)
    assert svc.config.loftr.batch_packing == "interleave"
    assert len(svc._models) == 2 and svc._models[0] is not svc._models[1]
    shards = []
    orig = svc._finish

    def finish(host, event):
        shards.append([tuple(h.shape) for h in host])
        return orig(host, event)

    svc._finish = finish
    rng = np.random.RandomState(11)
    imgs = [(rng.rand(64, 64).astype(np.float32),
             rng.rand(64, 64).astype(np.float32)) for _ in range(6)]
    with svc:
        futs = [svc.submit(a, b) for a, b in imgs]
        meshed = [f.result(timeout=120) for f in futs]
    for (a, b), r in zip(imgs, meshed):
        k0, k1, conf = _port_direct(weights, svc, a, b)
        np.testing.assert_allclose(r["mkpts0"], k0, atol=1e-3)
        np.testing.assert_allclose(r["mkpts1"], k1, atol=1e-3)
        np.testing.assert_allclose(r["mconf"], conf, atol=1e-5)
    snap = svc.stats.snapshot()
    assert snap["requests"] == 6 and len(shards) == snap["batches"]
    for sh in shards:              # two equal shards of [rows, K, 6]
        assert len(sh) == 2 and sh[0] == sh[1] and sh[0][2] == 6
    with pytest.raises(ValueError, match="'data' axis"):
        _service(weights, mesh={"model": ["cpu"]})


def test_inline_and_pipelined_stacking_agree(weights):
    rng = np.random.RandomState(21)
    pairs = [(rng.rand(64, 64).astype(np.float32),
              rng.rand(64, 64).astype(np.float32)) for _ in range(5)]
    results = {}
    for workers in (0, 2):
        svc = _service(weights, stack_workers=workers, wire_dtype="float32")
        with svc:
            futs = [svc.submit(a, b) for a, b in pairs]
            results[workers] = [f.result(timeout=120) for f in futs]
        snap = svc.stats.snapshot()
        assert snap["requests"] == 5
        for phase in ("stack", "place", "dispatch", "fetch"):
            assert phase in snap["phase_ms_mean"]
    for r0, r2 in zip(results[0], results[2]):
        np.testing.assert_allclose(r0["mkpts0"], r2["mkpts0"], atol=1e-5)
        np.testing.assert_allclose(r0["mkpts1"], r2["mkpts1"], atol=1e-5)


def _slow(svc, seconds):
    orig = svc._launch

    def slow(inp):
        time.sleep(seconds)
        return orig(inp)

    svc._launch = slow


def test_saturated_pipeline_holds_partial_rungs(weights):
    svc = _service(weights, stack_workers=2, wire_dtype="float32",
                   flush_ms=5.0, batch_sizes=(1, 2, 4))
    _slow(svc, 0.15)
    rng = np.random.RandomState(7)
    pairs = [(rng.rand(64, 64).astype(np.float32),
              rng.rand(64, 64).astype(np.float32)) for _ in range(16)]
    with svc:
        futs = []
        for a, b in pairs:
            futs.append(svc.submit(a, b))
            time.sleep(0.003)
        for f in futs:
            f.result(timeout=300)
    snap = svc.stats.snapshot()
    assert snap["requests"] == 16
    assert snap["batches"] <= 9, snap
    assert snap["batch_hist"].get(4, 0) >= 2, snap


def test_cancelled_future_does_not_kill_completer(weights):
    svc = _service(weights, stack_workers=2, wire_dtype="float32",
                   flush_ms=5.0)
    _slow(svc, 0.2)
    img = np.random.RandomState(11).rand(64, 64).astype(np.float32)
    with svc:
        doomed = svc.submit(img, img)
        assert doomed.cancel()
        ok = [svc.submit(img, img) for _ in range(3)]
        for f in ok:
            assert f.result(timeout=120)["mkpts0"].ndim == 2
        with svc._lock:
            assert svc._busy == 0, svc._busy


def test_starved_bucket_flushes_within_max_hold(weights):
    svc = _service(weights, stack_workers=2, wire_dtype="float32",
                   flush_ms=5.0, batch_sizes=(1, 2, 4), max_hold_ms=50.0)
    svc.warmup()
    _slow(svc, 0.25)
    rng = np.random.RandomState(13)
    a = rng.rand(64, 64).astype(np.float32)
    b = rng.rand(96, 96).astype(np.float32)
    flood = []

    def feeder():
        for _ in range(10):
            flood.extend(svc.submit(a, a) for _ in range(4))
            time.sleep(0.3)

    with svc:
        th = threading.Thread(target=feeder)
        th.start()
        time.sleep(0.15)
        t0 = time.perf_counter()
        svc.submit(b, b).result(timeout=120)
        lone_latency = time.perf_counter() - t0
        th.join()
        for f in flood:
            f.result(timeout=120)
    assert lone_latency < 2.0, lone_latency


def test_to_gray_value_ranges():
    rng = np.random.RandomState(9)
    f_rgb = rng.rand(16, 16, 3).astype(np.float32)
    u_rgb = np.round(f_rgb * 255.0).astype(np.uint8)
    u_gray = (rng.rand(16, 16) * 255).astype(np.uint8)
    gf = _to_gray(f_rgb, np.float32)
    gu = _to_gray(u_rgb, np.float32)
    assert gf.dtype == np.float32 and 0.0 <= gu.min() and gu.max() <= 1.0
    np.testing.assert_allclose(gu, gf, atol=2.5 / 255.0)
    wu = _to_gray(u_rgb, np.uint8)
    wf = _to_gray(f_rgb, np.uint8)
    assert wu.dtype == np.uint8
    assert int(np.sum(wu == 255)) < wu.size // 10
    assert np.abs(wu.astype(int) - wf.astype(int)).max() <= 2
    np.testing.assert_array_equal(_to_gray(u_gray, np.uint8), u_gray)


def test_service_uint8_and_rgb_inputs(weights):
    svc = _service(weights)
    rng = np.random.RandomState(9)
    u8 = (rng.rand(64, 64) * 255).astype(np.uint8)
    rgb = (rng.rand(64, 64, 3) * 255).astype(np.uint8)
    gray_of_rgb = np.clip(np.round(
        rgb @ np.asarray([0.114, 0.587, 0.299], np.float32)), 0, 255
    ).astype(np.uint8)
    with svc:
        r = svc.match(u8, rgb)
        r_gray = svc.match(u8, gray_of_rgb)
    assert r["mkpts0"].shape[1] == 2
    assert r["mkpts0"].shape == r_gray["mkpts0"].shape
    np.testing.assert_allclose(r["mkpts1"], r_gray["mkpts1"], atol=1e-5)


def test_results_are_fetched_once_per_batch(weights):
    """One packed result copy a batch ([rung, K, 6]: valid, mconf, mkpts0,
    mkpts1), read once by the completer."""
    svc = _service(weights, flush_ms=30.0)
    fetched = []
    orig = svc._finish

    def finish(host, event):
        fetched.append(tuple(host.shape))
        return orig(host, event)

    svc._finish = finish
    rng = np.random.RandomState(17)
    pairs = [(rng.rand(64, 64).astype(np.float32),
              rng.rand(64, 64).astype(np.float32)) for _ in range(6)]
    with svc:
        for f in [svc.submit(a, b) for a, b in pairs]:
            f.result(timeout=120)
    snap = svc.stats.snapshot()
    assert len(fetched) == snap["batches"] >= 2
    assert all(s[0] in (1, 2, 4) and s[2] == 6 for s in fetched)


def test_failing_forward_fails_its_group_and_the_service_goes_on(weights):
    svc = _service(weights, flush_ms=30.0, wire_dtype="float32")
    orig = svc._launch
    calls = []

    def launch(inp):
        calls.append(inp.image0.shape[0])
        if len(calls) == 1:
            raise RuntimeError("kernel rejected the shape")
        return orig(inp)

    svc._launch = launch
    img = np.random.RandomState(19).rand(64, 64).astype(np.float32)
    with svc:
        bad = [svc.submit(img, img) for _ in range(2)]
        for f in bad:
            with pytest.raises(RuntimeError, match="kernel rejected"):
                f.result(timeout=120)
        assert svc.match(img, img)["mkpts0"].ndim == 2
    with svc._lock:
        assert svc._busy == 0


def test_safe_resolve_drops_only_invalid_state():
    from concurrent.futures import Future
    f = Future()
    assert f.cancel()
    _safe_resolve(f, {"x": 1})              # cancelled: dropped
    g = Future()

    class Boom(Exception):
        pass

    def bad_set(_):
        raise Boom()

    g.set_result = bad_set
    with pytest.raises(Boom):
        _safe_resolve(g, {"x": 1})
