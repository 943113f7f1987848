"""PyTorch port: the inference slice in bfloat16 against the JAX package.

The small config of tests/test_torch_slice.py with ``dtype="bfloat16"``.
The JAX side runs with ``use_pallas`` on, its Pallas kernels in interpret
mode (with it off, XLA on the CPU rejects the bf16 x bf16 -> f32 dot),
jitted (the same outputs as op by op, in a third of the time); the port
runs its kernel modules' plain versions on the CPU.

The two frameworks round to bf16 at the same places, but they sum in other
orders: about 2e-5 of a bf16 convolution's outputs on the CPU, and 5e-4 of
a coarse layer's, land one ulp apart, and each such flip moves the
roundings downstream of it, so that by the backbone's output 1e-4 to 2e-1
of the entries differ by an ulp, and ``mconf`` by up to a few percent
(1-3.5 ulps where only the coarse layers flipped).  So the slice is held
to JAX in two ways:

- from JAX bf16's coarse-transformer output and fine maps (matching, the
  fine windows, the fine stage), at bars that follow from bf16's
  resolution: the valid matches are the same set, except slots whose
  ``mconf`` lies within one bf16 ulp of another valid slot's (their order,
  and so which of them the top-K keeps, may flip); ``mconf`` agrees within
  one bf16 ulp on the matches both hold; the mean ``expec_f`` error to JAX
  bf16 is no larger than JAX bf16's own error to JAX float32 (the noise
  floor of bf16 itself);
- from the images, at that noise floor: the backbone maps, the coarse
  features and ``mconf`` no further from JAX bf16 than JAX bf16 is from
  JAX float32; ``expec_f`` within twice that distance (two perturbations
  of bf16's size, the flips and the roundings; the ratio read 0.3-1.4 over
  these cases).

``indoor_ot`` scales the last coarse LayerNorm as
tests/test_torch_slice_ot.py does, so some cells beat the dustbin.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loftr_tpu import LoFTR as JaxLoFTR, MatchInput as JaxMatchInput
from loftr_tpu import get_config as jax_get_config
from loftr_tpu_torch import LoFTR, MatchInput, get_config
from loftr_tpu_torch.utils.weights import state_dict_from_jax

from test_torch_slice import _inputs, _over


def _config_over(preset, dtype, prefilter, use_pallas=True):
    over = _over(use_pallas)
    over["loftr"]["dtype"] = dtype
    if preset == "indoor_ot":
        over["loftr"]["match_coarse"]["skh_prefilter"] = prefilter
    return over


@functools.lru_cache(maxsize=None)
def _variables(preset):
    """One seeded JAX init a preset (the parameter tree does not depend on
    the image size or on ``use_pallas``, so a small input without kernels
    makes it quickly)."""
    small = JaxMatchInput(image0=jnp.zeros((1, 32, 32, 1)),
                          image1=jnp.zeros((1, 32, 32, 1)))
    jm = JaxLoFTR(jax_get_config(preset, _config_over(
        preset, "float32", False, use_pallas=False)).loftr)
    v = jax.tree.map(np.asarray, dict(jax.jit(jm.init)(
        jax.random.PRNGKey(0), small)))
    if preset == "indoor_ot":
        ln = v["params"]["loftr_coarse"]["layer_1"]["norm2"]
        ln["scale"] = np.full_like(ln["scale"], 6.0)
    return v


class _Fixed(torch.nn.Module):
    """Stands in for the port's backbone: returns given maps."""

    def __init__(self, maps):
        super().__init__()
        self.maps = maps

    def forward(self, x, dtype):
        return self.maps


def _run(preset, B, seed, masked, prefilter):
    """JAX float32 and bf16 (each with its backbone maps and coarse
    features), the port in bf16 from the images, and the port in bf16 from
    JAX bf16's coarse features and fine maps."""
    i0, i1, kw = _inputs(B, seed, masked)
    jinp = JaxMatchInput(image0=jnp.asarray(i0), image1=jnp.asarray(i1),
                         **{k: jnp.asarray(v) for k, v in kw.items()})
    v = _variables(preset)

    def apply(dtype):
        jm = JaxLoFTR(jax_get_config(preset, _config_over(
            preset, dtype, prefilter)).loftr)
        out, state = jax.jit(functools.partial(
            jm.apply, mutable=["intermediates"],
            capture_intermediates=lambda mdl, _: mdl.name in (
                "backbone", "loftr_coarse")))(v, jinp)
        im = state["intermediates"]
        return (out, im["backbone"]["__call__"][0],
                im["loftr_coarse"]["__call__"][0])
    want32, maps32, coarse32 = apply("float32")
    want16, maps16, coarse16 = apply("bfloat16")

    model = LoFTR(get_config(preset, _config_over(
        preset, "bfloat16", prefilter)).loftr).eval()
    model.load_state_dict(state_dict_from_jax(v))
    tinp = MatchInput(image0=torch.from_numpy(i0), image1=torch.from_numpy(i1),
                      **{k: torch.from_numpy(x) for k, x in kw.items()})

    def bf16(x):
        return torch.from_numpy(np.asarray(x, np.float32)).bfloat16()
    with torch.no_grad():
        got = model(tinp)
        port_maps = model.backbone(torch.cat([tinp.image0, tinp.image1]),
                                   torch.bfloat16)
        f = model.coarse(model.extract(tinp))
        # from here on, JAX bf16's fine maps and coarse features
        model.backbone = _Fixed(tuple(bf16(m) for m in maps16))
        model.coarse = lambda f, train=False: f._replace(
            feat_c0=bf16(coarse16[0]), feat_c1=bf16(coarse16[1]))
        got_shared = model(tinp)
    return dict(want32=want32, want16=want16, got=got, got_shared=got_shared,
                stages32=(*maps32, *coarse32), stages16=(*maps16, *coarse16),
                port_stages=(*port_maps, f.feat_c0, f.feat_c1))


def _bf16_ulp(x):
    """One bf16 ulp at each |x| (8 significant bits)."""
    x = np.abs(np.asarray(x, np.float64))
    return np.exp2(np.floor(np.log2(np.maximum(x, 1e-38))) - 7)


def _fields(out):
    def np_(t):
        return (t.float().numpy() if isinstance(t, torch.Tensor)
                else np.asarray(t, np.float32))
    return (np_(out.valid).astype(bool), np_(out.coarse.i_ids).astype(int),
            np_(out.coarse.j_ids).astype(int), np_(out.coarse.mconf),
            np_(out.expec_f))


def _matches(f, b):
    valid, i, j, conf, _ = f
    return {(int(i[b, s]), int(j[b, s])): float(conf[b, s])
            for s in np.flatnonzero(valid[b])}


def _near_tie(conf_by_match, m):
    """Whether match m's mconf lies within one bf16 ulp of another's."""
    c = conf_by_match[m]
    return any(abs(c - o) <= _bf16_ulp(c) for k, o in conf_by_match.items()
               if k != m)


def _same_slots(a, b):
    return a[0] & b[0] & (a[1] == b[1]) & (a[2] == b[2])


def _mconf_err(a, b, B):
    """Mean |mconf| difference over the matches both hold."""
    d = [abs(ma[m] - mb[m]) for ma, mb in
         ((_matches(a, k), _matches(b, k)) for k in range(B))
         for m in set(ma) & set(mb)]
    return float(np.mean(d)), len(d)


CASES = [("indoor_ds", 1, 0, False, False), ("indoor_ds", 1, 3, False, False),
         ("indoor_ds", 2, 2, True, False), ("indoor_ot", 1, 1, False, False),
         ("indoor_ot", 1, 4, False, True), ("indoor_ot", 2, 2, True, True)]


@pytest.mark.parametrize("preset,B,seed,masked,prefilter", CASES)
def test_bf16_slice_matches_jax(preset, B, seed, masked, prefilter):
    r = _run(preset, B, seed, masked, prefilter)
    f32, f16 = _fields(r["want32"]), _fields(r["want16"])
    assert f16[0].sum() > 0

    # from JAX bf16's coarse features and fine maps: bf16-resolution bars
    g = _fields(r["got_shared"])
    assert g[0].sum() == f16[0].sum()
    for b in range(B):
        gm, wm = _matches(g, b), _matches(f16, b)
        for m in set(gm) ^ set(wm):
            assert _near_tie(gm if m in gm else wm, m), (b, m)
        for m in set(gm) & set(wm):
            assert abs(gm[m] - wm[m]) <= _bf16_ulp(wm[m]), (b, m)
    both = _same_slots(g, f16) & _same_slots(f16, f32)
    assert both.sum() > 0
    floor_e = np.abs(f16[4][both] - f32[4][both]).mean()
    assert np.isfinite(g[4][g[0]]).all()
    assert np.abs(g[4][both] - f16[4][both]).mean() <= floor_e

    # from the images: the noise floor of bf16
    for p, w16, w32 in zip(r["port_stages"], r["stages16"], r["stages32"]):
        w16 = np.asarray(w16, np.float32)
        err = np.abs(p.float().numpy() - w16).mean()
        assert err <= np.abs(w16 - np.asarray(w32, np.float32)).mean()
    g = _fields(r["got"])
    err_c, n_c = _mconf_err(g, f16, B)
    floor_c, _ = _mconf_err(f16, f32, B)
    assert n_c > 0 and err_c <= floor_c, (err_c, floor_c)
    both = _same_slots(g, f16) & _same_slots(f16, f32)
    assert np.isfinite(g[4][g[0]]).all()
    assert np.abs(g[4][both] - f16[4][both]).mean() <= \
        2 * np.abs(f16[4][both] - f32[4][both]).mean()
