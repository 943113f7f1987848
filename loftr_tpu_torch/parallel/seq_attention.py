"""Sequence-parallel attention over a process group
(``loftr_tpu.parallel.seq_attention``).

Linear attention's cross-token quantities are plain sums over the keys:

    KV   = sum_s phi(K_s) V_s^T      (per head, [D, Dv])
    ksum = sum_s phi(K_s)            ([D])

so with the token axis sharded over a group, one all-reduce of the
[B, H, D, Dv] and [B, H, D] statistics a call gives every rank the global
ones; the query rows stay local.  Softmax attention rotates the K/V shards
around a ring instead (:func:`ring_full_attention`), folding each visiting
block into an online softmax.  Both carry their gradients: the all-reduce's
backward all-reduces, the ring's backward sends the other way.

:func:`sharded_coarse_stack` runs the plain coarse layer stack with its
tokens sharded over a group, as the JAX matcher runs it under
``coarse.seq_axis`` (``loftr_tpu/models/transformer.py``), and all-gathers
the tokens after it.

Layout: [B, L, H, D], as ``ops/attention.py``.
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import torch

from loftr_tpu_torch.ops.attention import elu_feature_map
from loftr_tpu_torch.parallel import comm


def _local_kv_stats(k, v, kv_mask):
    """This shard's (kv [B, H, D, Dv], ksum [B, H, D]) in float32, with v
    already divided by the global key count."""
    K = elu_feature_map(k)
    if kv_mask is not None:
        m = kv_mask[:, :, None, None].to(K.dtype)
        K = K * m
        v = v * m
    f32 = torch.float32
    kv = torch.einsum("bshd,bshv->bhdv", K.to(f32), v.to(f32))
    ksum = K.to(f32).sum(dim=1)
    return kv, ksum


def seq_parallel_linear_attention(q, k, v, q_mask=None, kv_mask=None,
                                  group=None, total_s: Optional[int] = None,
                                  eps: float = 1e-6):
    """Linear attention with the token axis sharded over ``group``.

    q, k, v: this rank's shards [B, l_loc, H, D] / [B, s_loc, H, D]; masks
    [B, l_loc] / [B, s_loc].  ``total_s`` is the global key count (the
    ``/S ... *S`` round trip of ``ops.attention.linear_attention``);
    ``s_loc`` times the group's size when not given.  Returns this rank's
    rows [B, l_loc, H, D]: ``linear_attention`` on the gathered sequences
    but for the order of the key sums."""
    s_total = total_s if total_s is not None else \
        v.shape[1] * comm.group_size(group)
    kv_l, ksum_l = _local_kv_stats(k, v / s_total, kv_mask)
    B, H, D, Dv = kv_l.shape
    # one all-reduce of [B, H, D, Dv + 1]
    stats = comm.all_reduce_sum(torch.cat([kv_l, ksum_l[..., None]], -1),
                                group)
    kv, ksum = stats[..., :Dv], stats[..., Dv]
    Q = elu_feature_map(q)
    if q_mask is not None:
        Q = Q * q_mask[:, :, None, None].to(Q.dtype)
    f32 = torch.float32
    z = 1.0 / (torch.einsum("blhd,bhd->blh", Q.to(f32), ksum) + eps)
    qkv = torch.einsum("blhd,bhdv->blhv", Q.to(f32),
                       kv.to(q.dtype).to(f32))
    out = qkv * z[..., None] * s_total
    return out.to(q.dtype)


def ring_full_attention(q, k, v, q_mask=None, kv_mask=None, group=None):
    """Softmax attention with the token axis sharded over ``group``.

    The K/V/mask shards travel around the ring (``comm.ring_shift``) while
    each rank folds the visiting block into an online softmax (running max,
    running normaliser, rescaled accumulator); the [L, S] score matrix is
    never formed, the peak block is [B, l_loc, H, s_loc].  Arguments as
    :func:`seq_parallel_linear_attention`.  Returns this rank's rows
    [B, l_loc, H, D]: ``ops.attention.full_attention`` on the gathered
    sequences up to rounding (float32 scores; the probabilities meet v in
    v's dtype before their normaliser, not after), with its zero rows
    where every pair is masked."""
    n = comm.group_size(group)
    B, l_loc, H, D = q.shape
    s_loc = k.shape[1]
    f32 = torch.float32
    scale = 1.0 / float(D) ** 0.5
    neg = -1e30       # a finite stand-in for -inf: exp and max stay defined
    if kv_mask is None:
        kv_mask = torch.ones((B, s_loc), dtype=torch.bool, device=q.device)
    m_c = kv_mask.bool()
    k_c, v_c = k, v
    qf = q.to(f32)
    run_max = torch.full((B, l_loc, H), neg, dtype=f32, device=q.device)
    run_den = torch.zeros((B, l_loc, H), dtype=f32, device=q.device)
    acc = torch.zeros((B, l_loc, H, D), dtype=f32, device=q.device)
    for step in range(n):
        s = torch.einsum("blhd,bshd->blhs", qf, k_c.to(f32)) * scale
        s = s.masked_fill(~m_c[:, None, None, :], neg)
        new_max = torch.maximum(run_max, s.amax(dim=-1))
        corr = torch.exp(run_max - new_max)
        p = torch.exp(s - new_max[..., None])
        run_den = run_den * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "blhs,bshd->blhd", p.to(v.dtype).to(f32), v_c.to(f32))
        run_max = new_max
        if step + 1 < n:
            k_c = comm.ring_shift(k_c, group)
            v_c = comm.ring_shift(v_c, group)
            m_c = comm.ring_shift(m_c.to(torch.uint8), group).bool()
    # rows whose every pair was masked: the max never left `neg`
    alive = run_max > neg * 0.5
    out = torch.where(alive[..., None],
                      acc / run_den.clamp_min(1e-30)[..., None],
                      torch.zeros_like(acc))
    if q_mask is not None:
        out = out * q_mask[:, :, None, None].to(out.dtype)
    return out.to(v.dtype)


def make_sharded_attention(group=None, kind: str = "linear"):
    """The sequence-parallel attention of ``kind`` ('linear': one
    all-reduce of the statistics; 'full': the K/V ring) over ``group``,
    with the signature of ``ops.attention.linear_attention``: a drop-in
    attention for this rank's shards."""
    if kind == "full":
        return partial(ring_full_attention, group=group)
    if kind != "linear":
        raise ValueError(f"attention {kind!r}")
    return partial(seq_parallel_linear_attention, group=group)


def token_shard(x: Optional[torch.Tensor], group):
    """This rank's contiguous slice of the token axis (dim 1) of x
    (``comm.split``: its backward gathers the slices' gradients)."""
    return None if x is None else comm.split(x, 1, group)


def sharded_coarse_stack(stack, feat0, feat1, mask0=None, mask1=None,
                         batch_packing: str = "concat", group=None):
    """The plain coarse layer stack (``models.transformer.
    LocalFeatureTransformer``) with the token axis of both images sharded
    over ``group``: each rank runs the layers on its slice of the tokens,
    with :func:`make_sharded_attention` of the stack's kind, and the
    results are all-gathered along the tokens.  Returns the full
    (feat0 [B, L, C], feat1 [B, S, C]) on every rank.  ``fused_heads`` does
    not apply here (the same values up to summation order).

    Gradients, for a loss that every rank forms alike from the gathered
    tokens (JAX's replicated program): the inputs' gradients are gathered
    over the slices and the parameters' summed over the ranks
    (``comm.split``, ``comm.sum_grad``), so every rank holds the gradients
    of the unsharded stack."""
    # the global key count of each call is its shard's times the group's
    attn = make_sharded_attention(group, stack.attention)
    args = (token_shard(feat0, group), token_shard(feat1, group),
            token_shard(mask0, group), token_shard(mask1, group))
    kw = {"batch_packing": batch_packing, "attn": attn}
    if torch.is_grad_enabled():
        # each rank's parameter gradient covers its own tokens
        params = {n: comm.sum_grad(p, group)
                  for n, p in stack.named_parameters()}
        c0, c1 = torch.func.functional_call(stack, params, args, kw)
    else:
        c0, c1 = stack(*args, **kw)
    return (comm.all_gather(c0, 1, group), comm.all_gather(c1, 1, group))
