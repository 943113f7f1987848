"""Shared inputs for the PyTorch port's training tests: one seeded numpy
batch, handed to the JAX package and to the port."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from loftr_tpu.structs import MatchInput as JaxMatchInput
from loftr_tpu_torch.structs import MatchInput

# the tiny model of tests/test_pallas_loss.py
TINY = {
    "backbone": {"initial_dim": 8, "block_dims": (8, 12, 16)},
    "coarse": {"d_model": 16, "nhead": 2, "layer_names": ("self", "cross")},
    "fine": {"d_model": 8, "nhead": 2, "layer_names": ("self", "cross")},
    "match_coarse": {"train_matches": 8, "train_pad_num_gt_min": 2},
}


def _rot(rng, angle):
    axis = rng.randn(3)
    axis /= np.linalg.norm(axis)
    kx = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                   [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * kx + (1 - np.cos(angle)) * kx @ kx


def train_batch(B=2, H=64, W=64, seed=0, moved=False, masked=False):
    """A dict of numpy arrays: images, depth in [1, 3], pinhole K, identity
    pose (or, with ``moved``, a small rigid motion), optionally padding
    masks and resize scales."""
    rng = np.random.RandomState(seed)
    K = np.array([[[40.0, 0, W / 2], [0, 40.0, H / 2], [0, 0, 1]]] * B,
                 np.float32)
    T = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    if moved:
        for b in range(B):
            T[b, :3, :3] = _rot(rng, 0.05)
            T[b, :3, 3] = rng.randn(3) * 0.05
    out = dict(
        image0=rng.rand(B, H, W, 1).astype(np.float32),
        image1=rng.rand(B, H, W, 1).astype(np.float32),
        depth0=(rng.rand(B, H, W) * 2 + 1).astype(np.float32),
        depth1=(rng.rand(B, H, W) * 2 + 1).astype(np.float32),
        T_0to1=T, T_1to0=np.linalg.inv(T).astype(np.float32), K0=K, K1=K)
    if moved:
        # smooth depth so the depth-consistency and loop-back tests pass
        # for many cells
        out["depth0"] = np.full((B, H, W), 2.0, np.float32)
        out["depth1"] = np.full((B, H, W), 2.0, np.float32)
    if masked:
        m0 = np.zeros((B, H // 8, W // 8), bool)
        m1 = np.zeros((B, H // 8, W // 8), bool)
        m0[:, :H // 8 - 2, :W // 8 - 1] = True
        m1[:, :H // 8 - 1, :W // 8 - 2] = True
        out.update(mask0=m0, mask1=m1,
                   scale0=np.full((B, 2), 1.0, np.float32),
                   scale1=np.full((B, 2), 1.0, np.float32))
    return out


def to_jax(batch):
    return JaxMatchInput(**{k: jnp.asarray(v) for k, v in batch.items()})


def to_torch(batch):
    return MatchInput(**{k: torch.from_numpy(np.ascontiguousarray(v))
                         for k, v in batch.items()})


def jax_select_noise(rng, B, L, k_train, sampling):
    """The uniform arrays loftr_tpu.ops.matching.select_train_matches draws
    from ``rng``, by the port's names: the same split / uniform calls."""
    rng_pred, rng_gt_sel, rng_gt_pick = jax.random.split(rng, 3)
    u = lambda k, shape, lo=0.0, hi=1.0: np.array(
        jax.random.uniform(k, shape, minval=lo, maxval=hi))
    out = {"gt_sel": u(rng_gt_sel, (B, L), 0.1, 1.0),
           "gt_pick": u(rng_gt_pick, (B, k_train))}
    if sampling == "global_replacement":
        rng_quota, rng_shuffle, rng_pick = jax.random.split(rng_pred, 3)
        out.update(quota=u(rng_quota, (B,)),
                   shuffle=u(rng_shuffle, (B, L), 0.1, 1.0),
                   pick=u(rng_pick, (B, k_train)))
    else:
        out["pred"] = u(rng_pred, (B, L), 0.1, 1.0)
    return {k: torch.from_numpy(v) for k, v in out.items()}
