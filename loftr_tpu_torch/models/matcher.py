"""LoFTR matcher: the coarse-to-fine pipeline on PyTorch.

Same stage order as ``loftr_tpu.models.matcher.LoFTR`` (the reference's
loftr.py:29-75):
  [1] ResNet-FPN backbone, (8, 2) or (16, 4), with batch, group or folded
      norm (both images in one call when their shapes agree)
  [2] position encoding + flatten to [B, L, C]
  [3] coarse transformer (self/cross x4)          -> coarse-layer kernel
      (``coarse.attention="full"``: softmax attention on the plain stack;
      ``coarse.seq_axis``: the plain stack token-sharded over a mesh axis)
  [4] dual-softmax + mutual-nearest candidates    -> dual-softmax kernel
      (``match_type="sinkhorn"``: Sinkhorn OT with the learned dustbin score
      ``coarse_matching.bin_score``                -> Sinkhorn kernel)
      then static top-K selection (K = min(max_matches, L)), or in training
      the random selection with GT padding (K = train_coarse_percent * L)
  [5] 5x5 fine windows at the matches + coarse-context concat
  [6]+[7] fine transformer + soft-argmax          -> fine-stage kernel
      (``fine.attention="full"``: softmax attention on the plain stack)
The ``use_pallas`` switches of ``cfg.coarse``, ``cfg.match_coarse`` and
``cfg.fine`` choose the kernel module (True) or the plain PyTorch path at
inference.  A kernel module runs its CUDA kernel on CUDA tensors and its
plain version on CPU tensors.

Training (``forward(inp, train=True, ...)`` on a module in ``train()``
mode) runs the plain, differentiable coarse transformer, BatchNorm on batch
statistics, the unfold window gather and the plain fine transformer with
fused heads (or, with ``fine.use_pallas_train``, the hybrid fine stage).
With the fused focal loss (``loss.use_pallas`` with dual-softmax, dense
supervision and the focal loss) the candidates come from the dual-softmax
kernel module without autograd, no [B, L, S] matrix is formed, and the
result carries the coarse features for the loss; otherwise the
differentiable ``dual_softmax_conf`` is returned in ``conf_matrix``.  OT
training always takes the plain ``sinkhorn_conf`` (and, with sparse
supervision, returns the assignment with its dustbins in
``conf_matrix_with_bin``).

Submodule names follow the reference state_dict (``backbone``,
``loftr_coarse``, ``coarse_matching``, ``fine_preprocess``, ``loftr_fine``).
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch
import torch.nn as nn

from loftr_tpu_torch.config import ModelConfig
from loftr_tpu_torch.models.backbone import build_backbone
from loftr_tpu_torch.models.fused_coarse import fused_coarse_forward
from loftr_tpu_torch.models.fused_fine import fused_fine_forward
from loftr_tpu_torch.models.position_encoding import add_position_encoding
from loftr_tpu_torch.models.transformer import (LocalFeatureTransformer,
                                                apply_linear)
from loftr_tpu_torch.ops import matching as M
from loftr_tpu_torch.ops.fine_match import fine_kpts, fine_match
from loftr_tpu_torch.ops.packing import pack_rows, unpack_rows
from loftr_tpu_torch.ops.windows import (gather_fine_windows,
                                         gather_fine_windows_direct)
from loftr_tpu_torch.structs import CoarseMatches, MatchInput, MatchResult
from loftr_tpu_torch.utils.profiler import span

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _stage(name: str):
    """Run the decorated stage method inside ``span(name)``, so every
    caller's trace shows the stage."""
    def wrap(fn):
        @functools.wraps(fn)
        def staged(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return staged
    return wrap


class FinePreprocess(nn.Module):
    """Coarse-context projection and merge (the reference's
    fine_preprocess.py)."""

    def __init__(self, d_coarse: int, d_fine: int):
        super().__init__()
        self.down_proj = nn.Linear(d_coarse, d_fine, bias=True)
        self.merge_feat = nn.Linear(2 * d_fine, d_fine, bias=True)


class CoarseMatching(nn.Module):
    """Holds the learned dustbin score of the Sinkhorn matcher (the
    reference's ``coarse_matching.bin_score``)."""

    def __init__(self, init_bin_score: float):
        super().__init__()
        self.bin_score = nn.Parameter(
            torch.tensor(float(init_bin_score), dtype=torch.float32))


class Features(NamedTuple):
    feat_c0: torch.Tensor              # [B, L, C] after position encoding
    feat_c1: torch.Tensor              # [B, S, C]
    feat_f0: torch.Tensor              # [B, Hf, Wf, Cf]
    feat_f1: torch.Tensor
    mask_c0: Optional[torch.Tensor]    # [B, L]
    mask_c1: Optional[torch.Tensor]


class LoFTR(nn.Module):
    """Detector-free matcher.  Call with a MatchInput; returns MatchResult."""

    def __init__(self, config: ModelConfig):
        super().__init__()
        self.config = config
        bb = config.backbone
        self.backbone = build_backbone(bb.resolution, bb.initial_dim,
                                       bb.block_dims, bb.norm)
        c, f = config.coarse, config.fine
        self.loftr_coarse = LocalFeatureTransformer(
            c.d_model, c.nhead, c.layer_names, c.attention,
            fused_heads=c.fused_heads, fused_heads_eval=True)
        mc = config.match_coarse
        if mc.match_type == "sinkhorn":
            self.coarse_matching = CoarseMatching(mc.skh_init_bin_score)
        elif mc.match_type != "dual_softmax":
            raise NotImplementedError(mc.match_type)
        if f.concat_coarse_feat:
            self.fine_preprocess = FinePreprocess(c.d_model, f.d_model)
        self.loftr_fine = LocalFeatureTransformer(
            f.d_model, f.nhead, f.layer_names, f.attention,
            fused_heads=f.fused_heads)

    @property
    def dtype(self) -> torch.dtype:
        return DTYPES[self.config.dtype]

    # -- stages, in order (separate so a caller can time each one; each
    #    runs in its ``loftr.<stage>`` span) --------------------------------

    @_stage("loftr.extract")
    def extract(self, inp: MatchInput) -> Features:
        """[1] backbone + [2] position encoding and flatten."""
        cfg = self.config
        pk = cfg.batch_packing
        dt = self.dtype
        B = inp.image0.shape[0]
        if inp.image0.shape == inp.image1.shape:
            feat_c, feat_f = self.backbone(
                pack_rows(inp.image0, inp.image1, pk), dt)
            feat_c0, feat_c1 = unpack_rows(feat_c, pk)
            feat_f0, feat_f1 = unpack_rows(feat_f, pk)
        else:
            feat_c0, feat_f0 = self.backbone(inp.image0, dt)
            feat_c1, feat_f1 = self.backbone(inp.image1, dt)
        tbf = cfg.coarse.temp_bug_fix
        feat_c0 = add_position_encoding(feat_c0, tbf)
        feat_c1 = add_position_encoding(feat_c1, tbf)
        feat_c0 = feat_c0.reshape(B, -1, feat_c0.shape[-1])
        feat_c1 = feat_c1.reshape(B, -1, feat_c1.shape[-1])
        mask_c0 = None if inp.mask0 is None else inp.mask0.reshape(B, -1)
        mask_c1 = None if inp.mask1 is None else inp.mask1.reshape(B, -1)
        return Features(feat_c0, feat_c1, feat_f0.contiguous(),
                        feat_f1.contiguous(), mask_c0, mask_c1)

    @_stage("loftr.coarse")
    def coarse(self, f: Features, train: bool = False) -> Features:
        """[3] coarse transformer.  The kernel is inference only and
        computes linear attention: with ``coarse.attention == "full"`` the
        configured function is softmax attention, which the plain stack
        computes (the JAX matcher's gate, ``loftr_tpu/models/matcher.py``).
        With ``coarse.seq_axis`` the plain stack runs with its tokens
        sharded over that axis of the ambient mesh
        (``parallel/seq_attention.py``), in training and inference."""
        cfg = self.config
        if cfg.coarse.seq_axis is not None:
            # token-sharded plain stack over the ambient mesh's axis; it
            # takes precedence over the kernel, as in the JAX matcher
            from loftr_tpu_torch.parallel.mesh import current_mesh
            from loftr_tpu_torch.parallel.seq_attention import \
                sharded_coarse_stack
            mesh = current_mesh()
            if mesh is None or cfg.coarse.seq_axis not in mesh.shape:
                raise ValueError(
                    f"coarse.seq_axis={cfg.coarse.seq_axis!r} needs an "
                    "ambient mesh with that axis (with mesh: ...)")
            c0, c1 = sharded_coarse_stack(
                self.loftr_coarse, f.feat_c0, f.feat_c1, f.mask_c0,
                f.mask_c1, cfg.batch_packing,
                mesh.group(cfg.coarse.seq_axis))
        elif (cfg.coarse.use_pallas and not train
                and cfg.coarse.attention == "linear"):
            c0, c1 = fused_coarse_forward(self.loftr_coarse, f.feat_c0,
                                          f.feat_c1, f.mask_c0, f.mask_c1,
                                          cfg.batch_packing)
        else:
            c0, c1 = self.loftr_coarse(f.feat_c0, f.feat_c1, f.mask_c0,
                                       f.mask_c1, cfg.batch_packing)
        return f._replace(feat_c0=c0, feat_c1=c1)

    def fused_loss(self, train: bool) -> bool:
        """Whether a training forward feeds the fused focal loss: no conf
        matrix, candidates from the kernel module, features returned."""
        cfg = self.config
        mc = cfg.match_coarse
        return (train and cfg.loss.use_pallas
                and mc.match_type == "dual_softmax" and not mc.sparse_spvs
                and cfg.loss.coarse_type == "focal")

    @_stage("loftr.match")
    def match(self, f: Features, inp: MatchInput, train: bool = False,
              generator: Optional[torch.Generator] = None,
              gt_j: Optional[torch.Tensor] = None,
              gt_valid: Optional[torch.Tensor] = None,
              noise: Optional[dict] = None):
        """[4] coarse matching + selection.  Returns (matches, conf or
        None, conf_with_bin or None)."""
        cfg = self.config
        mc = cfg.match_coarse
        hw0_c, hw1_c = self._coarse_hw(inp)
        conf = conf_with_bin = None
        ot = mc.match_type == "sinkhorn"
        if self.fused_loss(train) or (mc.use_pallas and not train):
            f0 = f.feat_c0.detach().contiguous()
            f1 = f.feat_c1.detach().contiguous()
            with torch.no_grad():
                if ot:
                    cand = M.kernel_sinkhorn_candidates(
                        f0, f1, self.coarse_matching.bin_score, mc.skh_iters,
                        mc.thr, mc.border_rm, hw0_c, hw1_c, inp.mask0,
                        inp.mask1, prefilter=mc.skh_prefilter)
                else:
                    cand = M.kernel_mutual_nearest_candidates(
                        f0, f1, mc.dsmax_temperature, mc.thr, mc.border_rm,
                        hw0_c, hw1_c, inp.mask0, inp.mask1)
        else:
            if ot:
                conf, assign = M.sinkhorn_conf(
                    f.feat_c0, f.feat_c1, self.coarse_matching.bin_score,
                    mc.skh_iters, f.mask_c0, f.mask_c1,
                    prefilter=(not train) and mc.skh_prefilter)
                if mc.sparse_spvs:
                    conf_with_bin = assign
            else:
                conf = M.dual_softmax_conf(f.feat_c0, f.feat_c1,
                                           mc.dsmax_temperature, f.mask_c0,
                                           f.mask_c1)
            with torch.no_grad():
                cand = M.mutual_nearest_candidates(
                    conf.detach(), mc.thr, mc.border_rm, hw0_c, hw1_c,
                    inp.mask0, inp.mask1)
        L, S = f.feat_c0.shape[1], f.feat_c1.shape[1]
        if not train:
            return (M.topk_matches(cand, min(mc.max_matches, L)), conf,
                    conf_with_bin)
        if gt_j is None or gt_valid is None:
            raise ValueError("training selection needs the coarse "
                             "supervision (gt_j, gt_valid)")
        if generator is None and noise is None:
            raise ValueError("training selection needs a generator (or "
                             "pre-drawn noise)")
        k_train = mc.train_matches or int(mc.train_coarse_percent * max(L, S))
        # the static k_train stays the capacity; under masks the slots
        # beyond the mask-aware budget are masked out of the losses
        budget = None
        if inp.mask0 is not None:
            budget = M.mask_match_budget(inp.mask0, inp.mask1,
                                         mc.train_coarse_percent)
        with torch.no_grad():
            matches = M.select_train_matches(
                cand, gt_j, gt_valid, generator, k_train,
                mc.train_pad_num_gt_min, budget=budget,
                sampling=mc.train_sampling, noise=noise)
        return matches, conf, conf_with_bin

    def fine_windows(self, f: Features, matches: CoarseMatches,
                     inp: MatchInput, train: bool = False):
        """[5] fine windows at the matches, merged with the coarse context.
        Returns (win0, win1), each [B, K, W*W, C_fine]."""
        cfg = self.config
        pk = cfg.batch_packing
        hw0_c, hw1_c = self._coarse_hw(inp)
        W = cfg.fine.window_size
        stride = f.feat_f0.shape[1] // hw0_c[0]
        gmode = cfg.fine.gather
        if gmode == "auto":
            gmode = "unfold" if train else "direct"
        gather = (gather_fine_windows_direct if gmode == "direct"
                  else gather_fine_windows)
        win0 = gather(f.feat_f0, matches.i_ids, hw0_c, W, stride)
        win1 = gather(f.feat_f1, matches.j_ids, hw1_c, W, stride)
        B, K, ww, d_f = win0.shape
        if cfg.fine.concat_coarse_feat:
            d_c = f.feat_c0.shape[-1]
            c0 = torch.gather(f.feat_c0, 1, matches.i_ids.long()[:, :, None]
                              .expand(B, K, d_c))
            c1 = torch.gather(f.feat_c1, 1, matches.j_ids.long()[:, :, None]
                              .expand(B, K, d_c))
            fp = self.fine_preprocess
            cwin = apply_linear(fp.down_proj, pack_rows(c0, c1, pk))
            c0w, c1w = unpack_rows(cwin, pk)
            win0 = apply_linear(fp.merge_feat, torch.cat(
                [win0, c0w[:, :, None, :].expand(B, K, ww, d_f)], dim=-1))
            win1 = apply_linear(fp.merge_feat, torch.cat(
                [win1, c1w[:, :, None, :].expand(B, K, ww, d_f)], dim=-1))
        return win0, win1

    @_stage("loftr.fine")
    def fine(self, f: Features, matches: CoarseMatches, inp: MatchInput,
             train: bool = False) -> torch.Tensor:
        """[5] fine windows + coarse context, [6]+[7] fine stage.
        Returns expec_f [B, K, 3] float32.  The kernel computes linear
        attention: with ``fine.attention == "full"`` the configured
        function is softmax attention, which the plain stack computes (the
        JAX matcher's gate)."""
        cfg = self.config
        win0, win1 = self.fine_windows(f, matches, inp, train)
        B, K, ww, d_f = win0.shape
        if cfg.fine.attention == "linear" and (
                cfg.fine.use_pallas_train if train else cfg.fine.use_pallas):
            # raises for a topology other than the kernel's ('self', 'cross')
            return fused_fine_forward(self.loftr_fine, win0, win1,
                                      trainable=train)
        f0, f1 = self.loftr_fine(win0.reshape(B * K, ww, d_f),
                                 win1.reshape(B * K, ww, d_f),
                                 batch_packing=cfg.batch_packing)
        return fine_match(f0.reshape(B, K, ww, d_f),
                          f1.reshape(B, K, ww, d_f))

    def _coarse_hw(self, inp: MatchInput):
        r = self.config.backbone.resolution[0]
        _, H0, W0, _ = inp.image0.shape
        _, H1, W1, _ = inp.image1.shape
        return (H0 // r, W0 // r), (H1 // r, W1 // r)

    def forward(self, inp: MatchInput, train: bool = False,
                generator: Optional[torch.Generator] = None,
                gt_j: Optional[torch.Tensor] = None,
                gt_valid: Optional[torch.Tensor] = None,
                noise: Optional[dict] = None) -> MatchResult:
        """Inference (``train=False``, module in ``eval()``) runs without
        autograd.  Training (``train=True``, module in ``train()``) carries
        the graph, takes the coarse supervision ``gt_j``/``gt_valid`` and a
        ``generator`` on the inputs' device (or the pre-drawn ``noise`` of
        ``ops.matching.draw_select_noise``) for the match selection."""
        if train != self.training:
            raise ValueError(
                f"forward(train={train}) on a module in "
                f"{'train' if self.training else 'eval'}() mode: BatchNorm "
                "follows the module's mode, so set it with .train()/.eval()")
        cfg = self.config
        res_c, res_f = cfg.backbone.resolution
        hw0_c, hw1_c = self._coarse_hw(inp)
        with torch.set_grad_enabled(train and torch.is_grad_enabled()):
            feats = self.coarse(self.extract(inp), train)
            matches, conf, conf_with_bin = self.match(
                feats, inp, train, generator, gt_j, gt_valid, noise)
            mkpts0_c, mkpts1_c = M.matches_to_kpts(
                matches, hw0_c, hw1_c, res_c, inp.scale0, inp.scale1)
            expec_f = self.fine(feats, matches, inp, train)
            mkpts0_f, mkpts1_f = fine_kpts(expec_f.detach(), mkpts0_c,
                                           mkpts1_c, cfg.fine.window_size,
                                           res_f, inp.scale1)
        fused = self.fused_loss(train)
        return MatchResult(coarse=matches, mkpts0_c=mkpts0_c,
                           mkpts1_c=mkpts1_c, mkpts0_f=mkpts0_f,
                           mkpts1_f=mkpts1_f, expec_f=expec_f,
                           conf_matrix=conf,
                           conf_matrix_with_bin=conf_with_bin,
                           feat_c0=feats.feat_c0 if fused else None,
                           feat_c1=feats.feat_c1 if fused else None)
