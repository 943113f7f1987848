"""Plain float32 LoFTR: the benchmark's reference for what the port computes.

A frozen, functional copy of the published LoFTR forward (zju3dv/LoFTR,
``src/loftr``): ResNet-FPN (8, 2) backbone, sinusoidal position encoding,
the linear-attention coarse transformer, dual-softmax coarse matching with
mutual-nearest selection and a static top-K, 5x5 fine windows merged with
the coarse context, the fine transformer and the soft-argmax.  Parameters
are a flat dict of tensors named as the reference ``state_dict`` names
them, at the published widths (196 channels, never the port's 256-channel
padding); BatchNorm runs on its running statistics in eval mode (the
function that folding preserves) or on batch statistics in training.

It imports no JAX and nothing of ``loftr_tpu_torch``.  ``quant="fp8"``
rounds both operands of every convolution and matrix product to
float8-e4m3 (a per-tensor scale to its largest value, 448) with float32
accumulation: the control, one precision below the bfloat16 the
configurations state.  Call :func:`strict_float32` before use on a GPU, so
no product runs in TF32.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

INF = 1e9
FP8_MAX = 448.0


def strict_float32() -> None:
    """No TF32 anywhere: float32 products in float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ------------------------------------------------------------- parameters

def param_spec(widths: dict) -> List[Tuple[str, tuple, str]]:
    """(name, shape, kind) of every tensor of the model at ``widths``
    (``initial_dim``, ``block_dims``, ``d_coarse``, ``n_coarse_layers``,
    ``d_fine``, ``n_fine_layers``).  Kinds: conv, linear, bias, bn_w,
    bn_b, bn_mean, bn_var, bn_count, ln_w, ln_b."""
    d0, d1, d2 = widths["block_dims"]
    c0 = widths["initial_dim"]
    spec = []

    def conv(name, cin, cout, k):
        spec.append((name + ".weight", (cout, cin, k, k), "conv"))

    def bn(name, c):
        spec.extend([(name + ".weight", (c,), "bn_w"),
                     (name + ".bias", (c,), "bn_b"),
                     (name + ".running_mean", (c,), "bn_mean"),
                     (name + ".running_var", (c,), "bn_var"),
                     (name + ".num_batches_tracked", (), "bn_count")])

    def block(name, cin, cout, stride):
        conv(name + ".conv1", cin, cout, 3)
        conv(name + ".conv2", cout, cout, 3)
        bn(name + ".bn1", cout)
        bn(name + ".bn2", cout)
        if stride != 1:
            conv(name + ".downsample.0", cin, cout, 1)
            bn(name + ".downsample.1", cout)

    b = "backbone."
    conv(b + "conv1", 1, c0, 7)
    bn(b + "bn1", c0)
    for stage, (cin, cout, stride) in enumerate(
            [(c0, d0, 1), (d0, d1, 2), (d1, d2, 2)], start=1):
        block(f"{b}layer{stage}.0", cin, cout, stride)
        block(f"{b}layer{stage}.1", cout, cout, 1)
    conv(b + "layer3_outconv", d2, d2, 1)
    conv(b + "layer2_outconv", d1, d2, 1)
    conv(b + "layer2_outconv2.0", d2, d2, 3)
    bn(b + "layer2_outconv2.1", d2)
    conv(b + "layer2_outconv2.3", d2, d1, 3)
    conv(b + "layer1_outconv", d0, d1, 1)
    conv(b + "layer1_outconv2.0", d1, d1, 3)
    bn(b + "layer1_outconv2.1", d1)
    conv(b + "layer1_outconv2.3", d1, d0, 3)

    def encoder(prefix, n, d):
        for i in range(n):
            p = f"{prefix}.layers.{i}."
            for m in ("q_proj", "k_proj", "v_proj", "merge"):
                spec.append((p + m + ".weight", (d, d), "linear"))
            spec.append((p + "mlp.0.weight", (2 * d, 2 * d), "linear"))
            spec.append((p + "mlp.2.weight", (d, 2 * d), "linear"))
            for m in ("norm1", "norm2"):
                spec.extend([(p + m + ".weight", (d,), "ln_w"),
                             (p + m + ".bias", (d,), "ln_b")])

    dc, df = widths["d_coarse"], widths["d_fine"]
    encoder("loftr_coarse", widths["n_coarse_layers"], dc)
    spec.extend([("fine_preprocess.down_proj.weight", (df, dc), "linear"),
                 ("fine_preprocess.down_proj.bias", (df,), "bias"),
                 ("fine_preprocess.merge_feat.weight", (df, 2 * df),
                  "linear"),
                 ("fine_preprocess.merge_feat.bias", (df,), "bias")])
    encoder("loftr_fine", widths["n_fine_layers"], df)
    return spec


# ------------------------------------------------------------ primitives

def _q8(x: torch.Tensor) -> torch.Tensor:
    """float8-e4m3 round trip with a per-tensor scale to the largest
    value; the gradient passes straight through."""
    amax = x.detach().abs().amax().clamp_min(1e-30).float()
    s = FP8_MAX / amax
    q = (x.float() * s).to(torch.float8_e4m3fn).float() / s
    return x + (q - x).detach()


class Plain:
    """The functional model over a parameter dict ``p``.  ``quant``: None
    (float32) or ``"fp8"`` (the control)."""

    def __init__(self, p: Dict[str, torch.Tensor], widths: dict,
                 quant: Optional[str] = None, train: bool = False):
        self.p = p
        self.w = widths
        self.q = _q8 if quant == "fp8" else (lambda t: t)
        self.train = train

    # -- products
    def conv(self, name, x, stride=1):
        w = self.p[name + ".weight"]
        k = w.shape[-1]
        return F.conv2d(self.q(x), self.q(w), None, stride, (k - 1) // 2)

    def linear(self, name, x, bias=False):
        w = self.p[name + ".weight"]
        y = self.q(x) @ self.q(w).t()
        if bias:
            y = y + self.p[name + ".bias"]
        return y

    def mm(self, eq, a, b):
        return torch.einsum(eq, self.q(a), self.q(b))

    # -- backbone
    def bn(self, name, x):
        w, b = self.p[name + ".weight"], self.p[name + ".bias"]
        if self.train:
            mean = x.mean(dim=(0, 2, 3))
            var = (x * x).mean(dim=(0, 2, 3)) - mean * mean
            var = var.clamp_min(0.0)
        else:
            mean = self.p[name + ".running_mean"]
            var = self.p[name + ".running_var"]
        inv = w * torch.rsqrt(var + 1e-5)
        return (x - mean[None, :, None, None]) * inv[None, :, None, None] \
            + b[None, :, None, None]

    def block(self, name, x, stride):
        y = F.relu(self.bn(name + ".bn1", self.conv(name + ".conv1", x,
                                                    stride)))
        y = self.bn(name + ".bn2", self.conv(name + ".conv2", y))
        if stride != 1:
            x = self.bn(name + ".downsample.1",
                        self.conv(name + ".downsample.0", x, stride))
        return F.relu(x + y)

    def fusion(self, name, x):
        x = F.leaky_relu(self.bn(name + ".1", self.conv(name + ".0", x)),
                         0.01)
        return self.conv(name + ".3", x)

    def backbone(self, img):
        """img: [N, H, W] float in [0, 1] -> (coarse [N, C, H/8, W/8],
        fine [N, C_f, H/2, W/2])."""
        b = "backbone."
        x = img[:, None].float()
        x0 = F.relu(self.bn(b + "bn1", self.conv(b + "conv1", x, 2)))
        x1 = self.block(b + "layer1.1", self.block(b + "layer1.0", x0, 1), 1)
        x2 = self.block(b + "layer2.1", self.block(b + "layer2.0", x1, 2), 1)
        x3 = self.block(b + "layer3.1", self.block(b + "layer3.0", x2, 2), 1)
        x3_out = self.conv(b + "layer3_outconv", x3)
        up = lambda t: F.interpolate(t, scale_factor=2.0, mode="bilinear",
                                     align_corners=True)
        x2_out = self.fusion(b + "layer2_outconv2",
                             self.conv(b + "layer2_outconv", x2) + up(x3_out))
        x1_out = self.fusion(b + "layer1_outconv2",
                             self.conv(b + "layer1_outconv", x1) + up(x2_out))
        return x3_out, x1_out

    # -- transformer
    def encoder(self, name, x, src, xm=None, sm=None):
        """One LoFTR encoder layer, linear attention.  x [N, L, C], src
        [N, S, C], masks [N, L] / [N, S] or None."""
        n, l, c = x.shape
        h = 8
        d = c // h
        q = self.linear(name + ".q_proj", x).reshape(n, l, h, d)
        k = self.linear(name + ".k_proj", src).reshape(n, -1, h, d)
        v = self.linear(name + ".v_proj", src).reshape(n, -1, h, d)
        Q = F.elu(q) + 1.0
        K = F.elu(k) + 1.0
        if xm is not None:
            Q = Q * xm[:, :, None, None].float()
        if sm is not None:
            K = K * sm[:, :, None, None].float()
            v = v * sm[:, :, None, None].float()
        s_len = v.shape[1]
        kv = self.mm("nshd,nshv->nhdv", K, v / s_len)
        z = 1.0 / (torch.einsum("nlhd,nhd->nlh", Q, K.sum(dim=1)) + 1e-6)
        msg = self.mm("nlhd,nhdv->nlhv", Q, kv) * z[..., None] * s_len
        msg = self.linear(name + ".merge", msg.reshape(n, l, c))
        msg = F.layer_norm(msg, (c,), self.p[name + ".norm1.weight"],
                           self.p[name + ".norm1.bias"], 1e-5)
        y = F.relu(self.linear(name + ".mlp.0", torch.cat([x, msg], -1)))
        y = self.linear(name + ".mlp.2", y)
        y = F.layer_norm(y, (c,), self.p[name + ".norm2.weight"],
                         self.p[name + ".norm2.bias"], 1e-5)
        return x + y

    def stack(self, prefix, names, f0, f1, m0=None, m1=None):
        for i, kind in enumerate(names):
            layer = f"{prefix}.layers.{i}"
            if kind == "self":
                f0 = self.encoder(layer, f0, f0, m0, m0)
                f1 = self.encoder(layer, f1, f1, m1, m1)
            else:
                f0 = self.encoder(layer, f0, f1, m0, m1)
                f1 = self.encoder(layer, f1, f0, m1, m0)
        return f0, f1

    def features(self, img0, img1, mask0=None, mask1=None):
        """Backbone, position encoding and coarse transformer.  img: [B, H,
        W]; masks [B, H/8, W/8] bool or None.  Returns (c0 [B, L, C], c1,
        fine0 [B, Hf, Wf, Cf], fine1, m0 [B, L] or None, m1)."""
        B = img0.shape[0]
        if img0.shape == img1.shape:
            c, f = self.backbone(torch.cat([img0, img1]))
            c0, c1, f0, f1 = c[:B], c[B:], f[:B], f[B:]
        else:
            c0, f0 = self.backbone(img0)
            c1, f1 = self.backbone(img1)

        def flat(c):
            _, C, h, w = c.shape
            pe = torch.from_numpy(pe_table(C, h, w)).to(c.device)
            return (c.permute(0, 2, 3, 1) + pe[None]).reshape(B, h * w, C)

        m0 = None if mask0 is None else mask0.reshape(B, -1)
        m1 = None if mask1 is None else mask1.reshape(B, -1)
        c0, c1 = self.stack("loftr_coarse", ["self", "cross"] * (
            self.w["n_coarse_layers"] // 2), flat(c0), flat(c1), m0, m1)
        return (c0, c1, f0.permute(0, 2, 3, 1), f1.permute(0, 2, 3, 1),
                m0, m1)

    def fine(self, c0, c1, f0, f1, i_ids, j_ids, hw0, hw1):
        """Fine stage of one pair: c [L, C]; f [Hf, Wf, Cf]; ids [K].
        Returns expec_f [K, 3] (x, y, std) in window coordinates."""
        W = 5
        stride = f0.shape[0] // hw0[0]
        w0 = windows(f0, i_ids, hw0[1], W, stride)
        w1 = windows(f1, j_ids, hw1[1], W, stride)
        cw = self.linear("fine_preprocess.down_proj",
                         torch.cat([c0[i_ids], c1[j_ids]]), bias=True)
        k = i_ids.shape[0]
        ww = W * W

        def merge(win, ctx):
            return self.linear("fine_preprocess.merge_feat", torch.cat(
                [win, ctx[:, None, :].expand(-1, ww, -1)], -1), bias=True)

        w0, w1 = merge(w0, cw[:k]), merge(w1, cw[k:])
        w0, w1 = self.stack("loftr_fine", ["self", "cross"] * (
            self.w["n_fine_layers"] // 2), w0, w1)
        return soft_argmax(w0, w1)


# ------------------------------------------------------------------ pieces

def pe_table(d_model: int, h: int, w: int) -> np.ndarray:
    """[h, w, C] sinusoidal encoding, 1-based positions, channels in
    groups of 4 (sin x, cos x, sin y, cos y) a frequency (the fixed
    ``temp_bug_fix`` form)."""
    div = np.exp(np.arange(0, d_model // 2, 2, dtype=np.float64)
                 * (-math.log(10000.0) / (d_model // 2)))
    y = np.arange(1, h + 1, dtype=np.float64)[:, None, None]
    x = np.arange(1, w + 1, dtype=np.float64)[None, :, None]
    pe = np.zeros((h, w, d_model))
    pe[:, :, 0::4] = np.sin(x * div)
    pe[:, :, 1::4] = np.cos(x * div)
    pe[:, :, 2::4] = np.sin(y * div)
    pe[:, :, 3::4] = np.cos(y * div)
    return pe.astype(np.float32)


def windows(feat: torch.Tensor, ids: torch.Tensor, wc: int, W: int,
            stride: int) -> torch.Tensor:
    """The W x W windows of a fine map [Hf, Wf, C] at coarse cells ``ids``
    [K] (the reference's ``F.unfold`` with padding W // 2): [K, W*W, C]."""
    r = W // 2
    fp = F.pad(feat, (0, 0, r, r, r, r))
    ids = ids.long()
    off = torch.arange(W, device=feat.device)
    ys = ((ids // wc) * stride)[:, None] + off
    xs = ((ids % wc) * stride)[:, None] + off
    win = fp[ys[:, :, None], xs[:, None, :]]
    return win.reshape(ids.shape[0], W * W, feat.shape[-1])


def soft_argmax(f0: torch.Tensor, f1: torch.Tensor) -> torch.Tensor:
    """Centre of window 0 against window 1: heatmap softmax, expected
    (x, y) in [-1, 1] and the summed standard deviation.  [K, WW, C] ->
    [K, 3]."""
    k, ww, c = f0.shape
    w = int(round(ww ** 0.5))
    sim = torch.einsum("kc,krc->kr", f0[:, ww // 2], f1) / c ** 0.5
    heat = torch.softmax(sim, dim=-1)
    xs = torch.linspace(-1.0, 1.0, w, device=f0.device)
    gy, gx = torch.meshgrid(xs, xs, indexing="ij")
    grid = torch.stack([gx, gy], -1).reshape(ww, 2)
    mu = heat @ grid
    var = heat @ grid ** 2 - mu ** 2
    std = var.clamp_min(1e-10).sqrt().sum(-1)
    return torch.cat([mu, std[:, None]], -1)


def border_ok(hw: tuple, border: int, mask: Optional[torch.Tensor]):
    """[L] bool: coarse cells a match may use (border removed inside the
    mask's valid extent).  mask: [h, w] bool or None."""
    h, w = hw
    dev = None if mask is None else mask.device
    ys = torch.arange(h, device=dev)[:, None]
    xs = torch.arange(w, device=dev)[None, :]
    if mask is None:
        he, we = h, w
    else:
        mi = mask.int()
        he, we = int(mi.sum(0).max()), int(mi.sum(1).max())
    ok = (ys >= border) & (ys < he - border) & (xs >= border) & \
        (xs < we - border)
    if mask is not None:
        ok = ok & mask.bool()
    return ok.reshape(-1)


class PairConf:
    """Dual-softmax confidence of one pair without the [L, S] matrix in
    memory: the row and column log-sum-exp come from blocks of rows, and
    any row or column of conf is formed on demand."""

    def __init__(self, c0, c1, m0, m1, temperature: float,
                 block: int = 2048):
        C = c0.shape[-1]
        self.a = c0.float() / C ** 0.5 / temperature
        self.b = c1.float() / C ** 0.5
        self.m0 = None if m0 is None else m0.bool()
        self.m1 = None if m1 is None else m1.bool()
        self.block = block
        L, S = c0.shape[0], c1.shape[0]
        row = torch.empty(L, device=c0.device)
        cmax = torch.full((S,), -float("inf"), device=c0.device)
        csum = torch.zeros(S, device=c0.device)
        for s in range(0, L, block):
            sim = self.sim_rows(s, min(L, s + block))
            row[s:s + sim.shape[0]] = torch.logsumexp(sim, dim=1)
            bm = sim.amax(dim=0)
            nm = torch.maximum(cmax, bm)
            csum = csum * torch.exp(cmax - nm) + \
                torch.exp(sim - nm[None]).sum(0)
            cmax = nm
        self.lse_row = row
        self.lse_col = cmax + torch.log(csum)

    def sim_rows(self, s, e):
        sim = self.a[s:e] @ self.b.t()
        if self.m0 is not None:
            pair = self.m0[s:e, None] & self.m1[None, :]
            sim = torch.where(pair, sim, torch.full_like(sim, -INF))
        return sim

    def conf_rows(self, rows):
        """conf[rows, :] for an index tensor ``rows``."""
        sim = self.a[rows] @ self.b.t()
        if self.m0 is not None:
            pair = self.m0[rows, None] & self.m1[None, :]
            sim = torch.where(pair, sim, torch.full_like(sim, -INF))
        return torch.exp(sim - self.lse_row[rows, None]) * \
            torch.exp(sim - self.lse_col[None, :])

    def best(self):
        """Per row (best conf, its column) and per column (best conf, its
        row), over the whole matrix in blocks of rows."""
        L, S = self.a.shape[0], self.b.shape[0]
        rv = torch.empty(L, device=self.a.device)
        rj = torch.empty(L, dtype=torch.long, device=self.a.device)
        cv = torch.full((S,), -1.0, device=self.a.device)
        ci = torch.zeros(S, dtype=torch.long, device=self.a.device)
        for s in range(0, L, self.block):
            e = min(L, s + self.block)
            conf = self.conf_rows(torch.arange(s, e, device=self.a.device))
            v, j = conf.max(dim=1)
            rv[s:e], rj[s:e] = v, j
            bv, bi = conf.max(dim=0)
            upd = bv > cv
            cv = torch.where(upd, bv, cv)
            ci = torch.where(upd, bi + s, ci)
        return rv, rj, cv, ci


def match_pair(model: Plain, c0, c1, m0, m1, hw0, hw1, thr: float,
               border: int, k: int, temperature: float = 0.1,
               mask0=None, mask1=None):
    """Coarse matches of one pair by the published rule: conf > thr,
    mutual nearest, border removed, then the top ``k`` by confidence (a
    stable order: ties keep the lower row).  Returns (conf, its per-row
    and per-column best (``PairConf.best``), i_ids, j_ids, mconf) of the
    valid matches only, by falling confidence."""
    conf = PairConf(c0, c1, m0, m1, temperature)
    rv, rj, cv, ci = conf.best()
    ok0 = border_ok(hw0, border, mask0).to(rv.device)
    ok1 = border_ok(hw1, border, mask1).to(rv.device)
    valid = (rv > thr) & (rv >= cv[rj]) & ok0 & ok1[rj]
    score = torch.where(valid, rv, torch.full_like(rv, -1.0))
    order = torch.sort(score, descending=True, stable=True).indices[:k]
    keep = valid[order]
    i_ids = order[keep]
    return conf, (rv, rj, cv, ci), i_ids, rj[i_ids], rv[i_ids]
