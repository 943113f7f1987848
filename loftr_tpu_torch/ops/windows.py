"""Fine-level window extraction (``loftr_tpu.ops.windows``): the direct
gather of the K selected windows (inference) and the unfold gather, which
builds all L windows from strided slices and gathers K rows (training: its
backward is dense slice-adds instead of scatter-adds).

Window geometry matches the reference's F.unfold(kernel=W, stride=stride,
padding=W//2): the window for coarse cell (y, x) starts at fine-map pixel
(y*stride - W//2, x*stride - W//2); out-of-bounds taps are zero.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def gather_fine_windows_direct(feat_f: torch.Tensor, cell_ids: torch.Tensor,
                               hw_c: tuple, window: int, stride: int
                               ) -> torch.Tensor:
    """feat_f: [B, Hf, Wf, C]; cell_ids: [B, K] flat coarse ids.
    Returns [B, K, W*W, C]."""
    b, _, _, c = feat_f.shape
    k = cell_ids.shape[1]
    wc = hw_c[1]
    rad = window // 2
    fp = F.pad(feat_f, (0, 0, rad, rad, rad, rad))   # pad W then H by rad
    ids = cell_ids.long()
    cy = (ids // wc) * stride                         # start, padded coords
    cx = (ids % wc) * stride
    off = torch.arange(window, device=feat_f.device)
    ys = (cy[:, :, None] + off)[:, :, :, None]        # [B, K, W, 1]
    xs = (cx[:, :, None] + off)[:, :, None, :]        # [B, K, 1, W]
    bi = torch.arange(b, device=feat_f.device)[:, None, None, None]
    win = fp[bi, ys, xs]                              # [B, K, W, W, C]
    return win.reshape(b, k, window * window, c)


def gather_fine_windows(feat_f: torch.Tensor, cell_ids: torch.Tensor,
                        hw_c: tuple, window: int, stride: int
                        ) -> torch.Tensor:
    """Same output as :func:`gather_fine_windows_direct`, by W*W shifted
    strided slices stacked to [B, L, W*W*C] rows and one row gather."""
    b, _, _, c = feat_f.shape
    k = cell_ids.shape[1]
    hc, wc = hw_c
    rad = window // 2
    fp = F.pad(feat_f, (0, 0, rad, rad + stride, rad, rad + stride))
    taps = []
    for dy in range(window):
        for dx in range(window):
            # tap (dy, dx) of cell (y, x) reads fp[y*stride + dy, x*stride + dx]
            taps.append(fp[:, dy:dy + (hc - 1) * stride + 1:stride,
                           dx:dx + (wc - 1) * stride + 1:stride, :])
    allwin = torch.stack(taps, dim=3)                 # [B, hc, wc, WW, C]
    allwin = allwin.reshape(b, hc * wc, window * window * c)
    rows = torch.gather(allwin, 1, cell_ids.long()[:, :, None].expand(
        b, k, window * window * c))
    return rows.reshape(b, k, window * window, c)
