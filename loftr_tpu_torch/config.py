"""Typed configuration tree for the PyTorch/CUDA port.

A copy of ``loftr_tpu.config`` (the port never imports the JAX package):
the same frozen dataclasses, field names, defaults and named presets, so a
preset here equals its JAX counterpart field by field.  Fields that only
steer TPU code paths (``winograd``, ``win_pack``,
``loss.force_pallas_cpu``) are kept as inert fields for that comparison.
``coarse.seq_axis`` names the axis of the ambient mesh
(``parallel/mesh.py``) over which the plain coarse stack shards its tokens
(``parallel/seq_attention.py``).

``use_pallas`` keeps its name: in the port it selects the hand-written
CUDA kernel module (``ops/kernels/``) instead of the plain PyTorch path
(``loss.use_pallas``: the fused focal loss; ``fine.use_pallas_train``: the
hybrid fine stage in training).

Precedence: defaults -> preset -> nested-dict overrides, last wins
(``Config.replaced``), as in the reference's yacs merge order.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Mapping


def _merge_dataclass(obj, overrides: Mapping[str, Any]):
    """Recursively apply a nested dict of overrides to a (frozen) dataclass."""
    updates = {}
    for key, value in overrides.items():
        if not hasattr(obj, key):
            raise KeyError(f"{type(obj).__name__} has no config field {key!r}")
        current = getattr(obj, key)
        if dataclasses.is_dataclass(current) and isinstance(value, Mapping):
            updates[key] = _merge_dataclass(current, value)
        else:
            updates[key] = value
    return dataclasses.replace(obj, **updates)


@dataclass(frozen=True)
class BackboneConfig:
    initial_dim: int = 128
    block_dims: tuple = (128, 196, 256)
    resolution: tuple = (8, 2)
    norm: str = "batch"
    winograd: bool = False


@dataclass(frozen=True)
class AttentionConfig:
    """One LocalFeatureTransformer stack (coarse or fine)."""
    d_model: int = 256
    d_ffn: int = 256
    nhead: int = 8
    layer_names: tuple = ("self", "cross") * 4
    attention: str = "linear"
    temp_bug_fix: bool = True
    fused_heads: bool = False
    # coarse stack only: run each layer through the CUDA coarse-layer kernel
    use_pallas: bool = True
    seq_axis: str | None = None


@dataclass(frozen=True)
class MatchCoarseConfig:
    thr: float = 0.2
    border_rm: int = 2
    match_type: str = "dual_softmax"  # ['dual_softmax', 'sinkhorn']
    dsmax_temperature: float = 0.1
    skh_iters: int = 3
    skh_init_bin_score: float = 1.0
    skh_prefilter: bool = False
    train_coarse_percent: float = 0.2
    train_pad_num_gt_min: int = 200
    sparse_spvs: bool = True
    max_matches: int = 1024           # inference top-K capacity per pair
    train_matches: int = 0
    train_sampling: str = "per_pair"
    # inference: dual-softmax + mutual-nearest through the CUDA kernel
    use_pallas: bool = True


@dataclass(frozen=True)
class FineConfig:
    window_size: int = 5
    concat_coarse_feat: bool = True
    d_model: int = 128
    d_ffn: int = 128
    nhead: int = 8
    layer_names: tuple = ("self", "cross")
    attention: str = "linear"
    # inference: fine transformer + soft-argmax through the CUDA kernel
    use_pallas: bool = True
    use_pallas_train: bool = False
    gather: str = "auto"
    fused_heads: bool = True
    win_pack: int = 1


@dataclass(frozen=True)
class LossConfig:
    coarse_type: str = "focal"  # ['focal', 'cross_entropy']
    coarse_weight: float = 1.0
    focal_alpha: float = 0.25
    focal_gamma: float = 2.0
    pos_weight: float = 1.0
    neg_weight: float = 1.0
    fine_type: str = "l2_with_std"  # ['l2_with_std', 'l2']
    fine_weight: float = 1.0
    fine_correct_thr: float = 1.0
    use_pallas: bool = True
    force_pallas_cpu: bool = False


@dataclass(frozen=True)
class ModelConfig:
    backbone: BackboneConfig = field(default_factory=BackboneConfig)
    coarse: AttentionConfig = field(default_factory=AttentionConfig)
    match_coarse: MatchCoarseConfig = field(default_factory=MatchCoarseConfig)
    fine: FineConfig = field(default_factory=FineConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    # compute dtype for the network body; parameters stay float32
    dtype: str = "float32"
    # two-image packing of the same-shape fast paths (ops/packing.py)
    batch_packing: str = "concat"


@dataclass(frozen=True)
class DatasetConfig:
    trainval_data_source: str | None = None
    train_data_root: str | None = None
    train_npz_root: str | None = None
    train_list_path: str | None = None
    train_intrinsic_path: str | None = None
    val_data_root: str | None = None
    val_npz_root: str | None = None
    val_list_path: str | None = None
    val_intrinsic_path: str | None = None
    test_data_source: str | None = None
    test_data_root: str | None = None
    test_npz_root: str | None = None
    test_list_path: str | None = None
    test_intrinsic_path: str | None = None
    min_overlap_score_train: float = 0.4
    min_overlap_score_test: float = 0.0
    augmentation_type: str | None = None
    mgdpt_img_resize: int = 640
    mgdpt_img_pad: bool = True
    mgdpt_depth_pad: bool = True
    mgdpt_df: int = 8


@dataclass(frozen=True)
class TrainerConfig:
    canonical_bs: int = 64
    canonical_lr: float = 6e-3
    optimizer: str = "adamw"  # ['adam', 'adamw']
    adam_decay: float = 0.0
    adamw_decay: float = 0.1
    warmup_type: str = "linear"  # ['linear', 'constant']
    warmup_ratio: float = 0.0
    warmup_step: int = 4800
    scheduler: str = "MultiStepLR"
    scheduler_interval: str = "epoch"  # ['epoch', 'step']
    mslr_milestones: tuple = (3, 6, 9, 12)
    mslr_gamma: float = 0.5
    cosa_tmax: int = 30
    elr_gamma: float = 0.999992
    epi_err_thr: float = 5e-4
    ransac_pixel_thr: float = 0.5
    ransac_conf: float = 0.99999
    ransac_max_iters: int = 10000
    pose_estimation_method: str = "RANSAC"
    data_sampler: str = "scene_balance"
    n_samples_per_subset: int = 200
    sb_subset_sample_replacement: bool = True
    sb_subset_shuffle: bool = True
    sb_repeat: int = 1
    gradient_clipping: float = 0.5
    seed: int = 66
    max_epochs: int = 30
    steps_per_epoch: int = 0
    accum_steps: int = 1


@dataclass(frozen=True)
class Config:
    loftr: ModelConfig = field(default_factory=ModelConfig)
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    trainer: TrainerConfig = field(default_factory=TrainerConfig)

    def replaced(self, overrides: Mapping[str, Any] | None = None, **kw) -> "Config":
        """Return a new Config with nested-dict overrides applied (last wins)."""
        cfg = self
        if overrides:
            cfg = _merge_dataclass(cfg, overrides)
        if kw:
            cfg = _merge_dataclass(cfg, kw)
        return cfg

    def scaled_lr(self, world_size: int, batch_size_per_device: int) -> tuple:
        """Linear LR scaling rule (the reference's train.py:70-77); the
        effective batch includes gradient accumulation.
        Returns (true_lr, warmup_step_scaled)."""
        true_bs = (world_size * batch_size_per_device
                   * max(1, self.trainer.accum_steps))
        scaling = true_bs / self.trainer.canonical_bs
        return self.trainer.canonical_lr * scaling, int(
            self.trainer.warmup_step / max(scaling, 1e-12))


# ---------------------------------------------------------------------------
# Named presets (the reference's configs/loftr/*).
# ---------------------------------------------------------------------------

def default_config() -> Config:
    return Config()


def indoor_ds() -> Config:
    """configs/loftr/indoor/loftr_ds_dense.py: dense spvs, dual-softmax."""
    return Config().replaced({
        "loftr": {"match_coarse": {"sparse_spvs": False}},
    })


def indoor_ot() -> Config:
    """configs/loftr/indoor/loftr_ot_dense.py: dense spvs, sinkhorn."""
    return Config().replaced({
        "loftr": {"match_coarse": {"match_type": "sinkhorn",
                                   "sparse_spvs": False}},
    })


def outdoor_ds() -> Config:
    """configs/loftr/outdoor/loftr_ds_dense.py: lr 8e-3, train pct 0.3."""
    return Config().replaced({
        "loftr": {"match_coarse": {"sparse_spvs": False,
                                   "train_coarse_percent": 0.3}},
        "trainer": {"canonical_lr": 8e-3},
    })


def outdoor_ot() -> Config:
    return outdoor_ds().replaced({
        "loftr": {"match_coarse": {"match_type": "sinkhorn"}},
    })


def scannet_eval(border_rm: int = 0) -> Config:
    """configs/loftr/indoor/scannet/loftr_ds_eval.py (BORDER_RM=0)."""
    return indoor_ds().replaced({
        "loftr": {"match_coarse": {"border_rm": border_rm}},
    })


def indoor_ds_buggy_pos_enc() -> Config:
    """configs/loftr/indoor/buggy_pos_enc/loftr_ds.py: TEMP_BUG_FIX=False."""
    return indoor_ds().replaced({
        "loftr": {"coarse": {"temp_bug_fix": False}},
    })


def indoor_ot_buggy_pos_enc() -> Config:
    """configs/loftr/indoor/buggy_pos_enc/loftr_ot.py."""
    return indoor_ot().replaced({
        "loftr": {"coarse": {"temp_bug_fix": False}},
    })


def indoor_ds_turbo() -> Config:
    """Trimmed architecture (not checkpoint-compatible with released
    weights): a 128-wide middle backbone stage and K=512."""
    return indoor_ds().replaced({
        "loftr": {
            "backbone": {"block_dims": (128, 128, 256)},
            "match_coarse": {"max_matches": 512},
        },
    })


PRESETS = {
    "default": default_config,
    "indoor_ds": indoor_ds,
    "indoor_ot": indoor_ot,
    "outdoor_ds": outdoor_ds,
    "outdoor_ot": outdoor_ot,
    "scannet_eval": scannet_eval,
    "indoor_ds_buggy_pos_enc": indoor_ds_buggy_pos_enc,
    "indoor_ot_buggy_pos_enc": indoor_ot_buggy_pos_enc,
    "indoor_ds_turbo": indoor_ds_turbo,
}


def get_config(name: str = "default", overrides: Mapping[str, Any] | None = None,
               ) -> Config:
    cfg = PRESETS[name]()
    if overrides:
        cfg = cfg.replaced(overrides)
    return cfg


def load_config_file(path: str) -> dict:
    """Read one nested-override dict from a .json / .yaml / .yml file.

    The file may name a base preset with a top-level ``"preset": "<name>"``
    key, which :func:`get_config_from_files` consumes.
    """
    import json

    with open(path) as f:
        if path.endswith((".yaml", ".yml")):
            import yaml
            data = yaml.safe_load(f)
        elif path.endswith(".json"):
            data = json.load(f)
        else:
            raise ValueError(f"unknown config format: {path} "
                             "(expected .json/.yaml/.yml)")
    if not isinstance(data, Mapping):
        raise ValueError(f"{path}: top level must be a mapping")
    return dict(data)


def get_config_from_files(*paths: str, preset: str | None = None,
                          overrides: Mapping[str, Any] | None = None,
                          fallback: str = "default") -> Config:
    """Multi-file config with the reference's merge precedence
    (train.py:63-65; configs/data/base.py:1-4): preset defaults, then each
    file in argument order (later files win), then ``overrides`` last.

    A file may set ``preset: <name>`` to select the base preset (the last
    file that names one wins); the ``preset`` argument wins over files.
    """
    dicts = [load_config_file(p) for p in paths]
    base = preset
    if base is None:
        for d in dicts:
            base = d.get("preset", base)
    cfg = PRESETS[base or fallback]()
    for d in dicts:
        d = {k: v for k, v in d.items() if k != "preset"}
        if d:
            cfg = cfg.replaced(d)
    if overrides:
        cfg = cfg.replaced(overrides)
    return cfg
