"""PyTorch port: two rules of the JAX matcher that the port follows.

- ``coarse.fused_heads`` applies to the plain coarse stack in eval as well
  as in training (``loftr_tpu/models/matcher.py``, the plain coarse branch);
  ``fine.fused_heads`` applies in training only.
- ``match_pair(use_pallas=False)`` switches off the matcher and fine-stage
  kernels and leaves ``coarse.use_pallas`` as it is (``loftr_tpu/api.py``).

Both against the JAX package on the small config of test_torch_slice.py.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loftr_tpu import LoFTR as JaxLoFTR, MatchInput as JaxMatchInput
from loftr_tpu import get_config as jax_get_config
from loftr_tpu.api import _jitted as jax_match_pair_model
from loftr_tpu_torch import LoFTR, MatchInput, get_config
from loftr_tpu_torch.api import match_pair
from loftr_tpu_torch.models import matcher as TM
from loftr_tpu_torch.models import transformer as TT
from loftr_tpu_torch.utils.weights import state_dict_from_jax

from test_torch_slice import _inputs, _over, assert_slice_equal


def _both(over, seed, masked=False):
    """The JAX forward and the port model (eval, float32, the JAX init)."""
    i0, i1, kw = _inputs(1, seed, masked)
    jm = JaxLoFTR(jax_get_config("indoor_ds", over).loftr)
    jinp = JaxMatchInput(image0=jnp.asarray(i0), image1=jnp.asarray(i1),
                         **{k: jnp.asarray(v) for k, v in kw.items()})
    v = jm.init(jax.random.PRNGKey(seed), jinp)
    model = LoFTR(get_config("indoor_ds", over).loftr)
    model.load_state_dict(state_dict_from_jax(
        jax.tree.map(np.asarray, dict(v))))
    return jm.apply(v, jinp), model.eval(), (i0, i1, kw)


def _fused_heads_over():
    over = copy.deepcopy(_over(False))
    over["loftr"]["coarse"]["fused_heads"] = True
    over["loftr"]["fine"]["fused_heads"] = True
    return over


def _count_fused_heads(monkeypatch):
    """Token counts of the queries that reach the fused-heads attention."""
    seen = []
    real = TT.linear_attention_fused_heads

    def spy(q, *a, **k):
        seen.append(q.shape[1])
        return real(q, *a, **k)
    monkeypatch.setattr(TT, "linear_attention_fused_heads", spy)
    return seen


def test_coarse_fused_heads_apply_in_eval_fine_in_training_only(monkeypatch):
    seen = _count_fused_heads(monkeypatch)
    model = LoFTR(get_config("indoor_ds", _fused_heads_over()).loftr).eval()
    i0, i1, _ = _inputs(1, 3, False)
    with torch.no_grad():
        model(MatchInput(image0=torch.from_numpy(i0),
                         image1=torch.from_numpy(i1)))
    # 64x64 images: 64 coarse tokens, 25-token fine windows; one packed
    # self call and two cross calls of the coarse stack, none of the fine
    assert seen == [64, 64, 64]


@pytest.mark.parametrize("masked", [False, True])
def test_slice_with_coarse_fused_heads_matches_jax(masked):
    want, model, (i0, i1, kw) = _both(_fused_heads_over(), 7, masked)
    with torch.no_grad():
        got = model(MatchInput(image0=torch.from_numpy(i0),
                               image1=torch.from_numpy(i1),
                               **{k: torch.from_numpy(v)
                                  for k, v in kw.items()}))
    assert int(np.asarray(want.valid).sum()) > 0
    assert_slice_equal(got, want)


def test_match_pair_without_pallas_keeps_the_coarse_kernel(monkeypatch):
    # the JAX rule, read from the model its match_pair builds
    jm, _ = jax_match_pair_model("indoor_ds", "float32", (64, 64), (64, 64),
                                 False, "batch", (128, 196, 256))
    assert jm.config.coarse.use_pallas
    assert not jm.config.match_coarse.use_pallas
    assert not jm.config.fine.use_pallas
    # the port's match_pair with the same switches, against the JAX forward
    over = copy.deepcopy(_over(True))
    over["loftr"]["match_coarse"]["use_pallas"] = False
    over["loftr"]["fine"]["use_pallas"] = False
    want, model, (i0, i1, _) = _both(over, 5)
    model.config = get_config("indoor_ds", _over(True)).loftr
    calls = []
    real = TM.fused_coarse_forward
    monkeypatch.setattr(TM, "fused_coarse_forward",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    out = match_pair(i0[0, :, :, 0], i1[0, :, :, 0], model, dtype="float32",
                     use_pallas=False)
    assert calls == [1]
    keep = np.asarray(want.valid)[0]
    assert keep.any()
    order = np.argsort(-np.asarray(want.coarse.mconf)[0][keep], kind="stable")
    np.testing.assert_allclose(out["mconf"],
                               np.asarray(want.coarse.mconf)[0][keep][order],
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(out["mkpts1"],
                               np.asarray(want.mkpts1_f)[0][keep][order],
                               atol=1e-3)
    np.testing.assert_allclose(out["mkpts0"],
                               np.asarray(want.mkpts0_f)[0][keep][order],
                               atol=1e-4)
