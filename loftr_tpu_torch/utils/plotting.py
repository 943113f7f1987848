"""Match visualization (matplotlib, host-side); a copy of
``loftr_tpu.utils.plotting`` reading the port's MatchResult.

The reference's src/utils/plotting.py: side-by-side image pair with match
lines colored by epipolar error (green=good, red=bad), dynamic alpha by
match count, precision/recall annotations, on the static-shape MatchResult
(validity masks select real matches).  Tensors may lie on any device.
"""
from __future__ import annotations

import bisect
from typing import List, Optional, Sequence

import numpy as np
import torch

import matplotlib
matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402


def dynamic_alpha(n_matches: int,
                  milestones=(0, 300, 1000, 2000),
                  alphas=(1.0, 0.8, 0.4, 0.2)) -> float:
    """plotting.py:136-147."""
    if n_matches == 0:
        return 1.0
    milestones = list(milestones)
    alphas = list(alphas)
    ranges = list(zip(alphas, alphas[1:] + [None]))
    loc = bisect.bisect_right(milestones, n_matches) - 1
    lo, hi = ranges[loc]
    if hi is None:
        return lo
    return hi + (milestones[loc + 1] - n_matches) / (
        milestones[loc + 1] - milestones[loc]) * (lo - hi)


def error_colormap(err: np.ndarray, thr: float, alpha: float = 1.0
                   ) -> np.ndarray:
    """Red->green RGBA by error (plotting.py:150-154)."""
    assert 0 < alpha <= 1.0
    x = 1 - np.clip(err / (thr * 2), 0, 1)
    return np.clip(np.stack(
        [2 - x * 2, x * 2, np.zeros_like(x), np.ones_like(x) * alpha], -1),
        0, 1)


def make_matching_figure(img0: np.ndarray, img1: np.ndarray,
                         mkpts0: np.ndarray, mkpts1: np.ndarray,
                         color: np.ndarray,
                         text: Sequence[str] = (), dpi: int = 75,
                         path: Optional[str] = None):
    """Side-by-side pair with match lines (plotting.py:20-65)."""
    fig, axes = plt.subplots(1, 2, figsize=(10, 6), dpi=dpi)
    axes[0].imshow(img0, cmap="gray")
    axes[1].imshow(img1, cmap="gray")
    for ax in axes:
        ax.get_yaxis().set_ticks([])
        ax.get_xaxis().set_ticks([])
        for spine in ax.spines.values():
            spine.set_visible(False)
    plt.tight_layout(pad=1)

    if len(mkpts0) > 0:
        fig.canvas.draw()
        tf = fig.transFigure.inverted()
        fk0 = tf.transform(axes[0].transData.transform(mkpts0))
        fk1 = tf.transform(axes[1].transData.transform(mkpts1))
        fig.lines = [
            matplotlib.lines.Line2D((fk0[i, 0], fk1[i, 0]),
                                    (fk0[i, 1], fk1[i, 1]),
                                    transform=fig.transFigure,
                                    c=color[i], linewidth=1)
            for i in range(len(mkpts0))]
        axes[0].scatter(mkpts0[:, 0], mkpts0[:, 1], c=color, s=4)
        axes[1].scatter(mkpts1[:, 0], mkpts1[:, 1], c=color, s=4)

    txt_color = "k" if img0[:100, :200].mean() > 200 else "w"
    fig.text(0.01, 0.99, "\n".join(text), transform=fig.axes[0].transAxes,
             fontsize=15, va="top", ha="left", color=txt_color)
    if path:
        plt.savefig(str(path), bbox_inches="tight", pad_inches=0)
        plt.close(fig)
        return None
    return fig


def _np(x) -> np.ndarray:
    """A tensor (any device, bool kept, floats as float32) or an array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x if x.dtype == torch.bool else x.float()).numpy()
    return np.asarray(x)


def make_matching_figures(result, inp, epi_errs: Optional[np.ndarray] = None,
                          conf_thr: float = 5e-4,
                          n_gt_matches: Optional[int] = None,
                          alpha="dynamic") -> List:
    """Per-pair evaluation figures from a MatchResult
    (plotting.py:68-133 semantics on static shapes).

    epi_errs: [B, K] (optional; grey matches if absent).
    conf_thr: 5e-4 ScanNet / 1e-4 MegaDepth (plotting.py:7-15).
    """
    figures = []
    valid = _np(result.valid)
    kpts0 = _np(result.mkpts0_f)
    kpts1 = _np(result.mkpts1_f)
    img0 = _np(inp.image0)[..., 0]
    img1 = _np(inp.image1)[..., 0]
    scale0 = None if inp.scale0 is None else _np(inp.scale0)
    scale1 = None if inp.scale1 is None else _np(inp.scale1)

    for b in range(valid.shape[0]):
        v = valid[b]
        k0, k1 = kpts0[b][v], kpts1[b][v]
        if scale0 is not None:  # visualize on the resized image
            k0 = k0 / scale0[b]
            k1 = k1 / scale1[b]
        text = [f"#Matches {len(k0)}"]
        if epi_errs is not None:
            errs = np.asarray(epi_errs)[b][v]
            correct = errs < conf_thr
            precision = float(np.mean(correct)) if len(correct) else 0.0
            text.append(f"Precision({conf_thr:.2e}) "
                        f"({100 * precision:.1f}%): "
                        f"{int(correct.sum())}/{len(k0)}")
            if n_gt_matches:
                recall = int(correct.sum()) / n_gt_matches
                text.append(f"Recall({conf_thr:.2e}) "
                            f"({100 * recall:.1f}%): "
                            f"{int(correct.sum())}/{n_gt_matches}")
            a = dynamic_alpha(len(k0)) if alpha == "dynamic" else alpha
            color = error_colormap(errs, conf_thr, alpha=a)
        else:
            a = dynamic_alpha(len(k0)) if alpha == "dynamic" else alpha
            color = np.tile([0.2, 0.6, 1.0, a], (len(k0), 1))
        img0b = np.round(img0[b] * 255).astype(np.int32)
        img1b = np.round(img1[b] * 255).astype(np.int32)
        figures.append(make_matching_figure(img0b, img1b, k0, k1, color,
                                            text=text))
    return figures
