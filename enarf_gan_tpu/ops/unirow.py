"""Unirow tri-plane sampling — single-fetch fused rows.

Replaces ops/quadtable.py's TWO gathers per (point, candidate, plane) — a
feature-quad row plus a bone-folded mask row — with ONE bf16 row of
4F+128 values that carries both:

    [ A_f | B_f | C_f | D_f | A_m(32) | B_m(32) | C_m(32) | D_m(32) ]

where A..D are the 2x2 bilinear texel quad of cell (t, s) and each mask
corner block holds that texel's mask logit for ALL bones (bone k at offset
k, K <= 32); the candidate's bone is selected by a one-hot over the
32-wide block at combine time instead of being folded into the row index.
The mask thus no longer multiplies the table by K: the packed table is
(B, 3*(H+1)*(W+1), 4F+128), built once per frame
(models/narf.py::pack_planes).

The combine (bilinear arithmetic + bone select + sigmoid-prod + weighted
feature sum) is an XLA graph with a hand-derived custom VJP. Gradients flow
through that VJP and natively through the gather and ``pack_unirow``
(plain pad/concat/astype ops), so the whole path trains.

Reference equivalents: libraries/triplane/sampling.py:54-127 and
cuda_extension/TriplaneSampler_kernel.cu:37-92 (fused gather-sum with
``align_corners=False`` + zeros padding).
"""
from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

from enarf_gan_tpu.ops.activation import straight_through_clamp
from enarf_gan_tpu.ops.quadtable import _quad_cells_weights

MASK_BLOCK = 32          # mask lanes per corner block (bones 0..K-1, K<=32)


def row_width(feat_dim: int) -> int:
    return 4 * feat_dim + 4 * MASK_BLOCK


def pack_unirow(tri_plane_feature: jnp.ndarray, feat_dim: int,
                num_bone: int) -> jnp.ndarray:
    """(B, (F+K)*3, H, W) planes → (B, 3*(H+1)*(W+1), 4F+128) bf16 table.

    Row r = p*(H+1)*(W+1) + t*(W+1) + s for plane p, cell (t, s); zeros out
    of bounds (grid_sample zero padding). Channel layout of the input
    follows the model: F*3 feature planes then K*3 per-bone mask planes
    (reference models/narf.py:71).
    """
    from enarf_gan_tpu.ops.quadtable import quad_pack_corners
    B, C3, H, W = tri_plane_feature.shape
    F, K = feat_dim, num_bone
    assert C3 == (F + K) * 3, (C3, F, K)
    assert K <= MASK_BLOCK, K

    feat = tri_plane_feature[:, :F * 3].reshape(B, 3, F, H, W) \
        .transpose(0, 1, 3, 4, 2)                              # (B,3,H,W,F)
    mask = tri_plane_feature[:, F * 3:].reshape(B, K, 3, H, W) \
        .transpose(0, 2, 3, 4, 1)                              # (B,3,H,W,K)
    fq = quad_pack_corners(feat)                               # (…, 4F)
    mq = quad_pack_corners(mask).reshape(B, 3, -1, 4, K)
    mq = jnp.pad(mq, ((0, 0),) * 3 + ((0, 0), (0, MASK_BLOCK - K)))
    mq = mq.reshape(B, 3, fq.shape[2], 4 * MASK_BLOCK)
    table = jnp.concatenate([fq, mq], axis=-1).astype(jnp.bfloat16)
    return table.reshape(B, 3 * fq.shape[2], row_width(F))


def _combine_xla(g, wq4, cand_idx, cand_valid_f, feat_dim, clamp_mask):
    """Combine: g (B,3,M,n,4F+128) bf16 → feature (B,F,n), cand_w (B,M,n).

    Keeps n minor throughout.
    """
    F = feat_dim
    B, _, M, n, _ = g.shape
    feat = sum(g[..., q * F:(q + 1) * F]
               * wq4[:, q][:, :, :, :, None].astype(g.dtype)
               for q in range(4))
    feat = feat.astype(jnp.float32).sum(axis=1)               # (B, M, n, F)
    oh = (jax.lax.broadcasted_iota(jnp.int32, (B, M, n, MASK_BLOCK), 3)
          == cand_idx[..., None]).astype(jnp.float32)         # (B, M, n, 32)
    base = 4 * F
    logit = sum(
        (g[..., base + q * MASK_BLOCK: base + (q + 1) * MASK_BLOCK]
         .astype(jnp.float32) * oh[:, None]).sum(axis=-1) * wq4[:, q]
        for q in range(4))                                    # (B, 3, M, n)
    if clamp_mask:
        logit = straight_through_clamp(logit)
    cand_wn = jax.nn.sigmoid(logit).prod(axis=1)              # (B, M, n)
    w = cand_wn * cand_valid_f                                # (B, M, n)
    feature = jnp.einsum("bmnf,bmn->bfn", feat, w)            # (B, F, n)
    return feature, cand_wn


@partial(jax.custom_vjp, nondiff_argnums=(4, 5))
def _unirow_combine(g, wq4, cand_idx, cand_valid_f, feat_dim, clamp_mask):
    """feature (B,F,n) f32, cand_w (B,M,n) f32 from gathered unirow rows.

    Args: g (B,3,M,n,4F+128) bf16; wq4 (B,4,3,M,n) f32 bilinear corner
    weights; cand_idx (B,M,n) int32; cand_valid_f (B,M,n) f32.
    """
    return _combine_xla(g, wq4, cand_idx, cand_valid_f, feat_dim, clamp_mask)


def _combine_fwd(g, wq4, cand_idx, cand_valid_f, feat_dim, clamp_mask):
    out = _unirow_combine(g, wq4, cand_idx, cand_valid_f, feat_dim,
                          clamp_mask)
    return out, (g, wq4, cand_idx, cand_valid_f)


def _combine_bwd(feat_dim, clamp_mask, res, cot):
    """Hand VJP (XLA): recompute intermediates once, emit dg/dwq4/dvalid.

    straight_through_clamp contributes identity to dlogit (ops/activation.py)
    but the sigmoid and its derivative are still evaluated at the CLAMPED
    logit, so the recompute must clamp before sigmoid.
    """
    g, wq4, cand_idx, cand_valid_f = res
    dfeature, dcw_out = cot
    F = feat_dim
    B, _, M, n, _ = g.shape
    base = 4 * F

    # recompute forward intermediates
    featq = [g[..., q * F:(q + 1) * F].astype(jnp.float32) for q in range(4)]
    wq = [wq4[:, q] for q in range(4)]                       # (B,3,M,n) each
    feat = sum(fq * w[..., None] for fq, w in zip(featq, wq))  # (B,3,M,n,F)
    feat_pm = feat.sum(axis=1)                               # (B,M,n,F)
    oh = (jax.lax.broadcasted_iota(jnp.int32, (B, M, n, MASK_BLOCK), 3)
          == cand_idx[..., None]).astype(jnp.float32)
    mq = [g[..., base + q * MASK_BLOCK: base + (q + 1) * MASK_BLOCK]
          .astype(jnp.float32) for q in range(4)]
    selq = [(m * oh[:, None]).sum(axis=-1) for m in mq]      # (B,3,M,n)
    logit = sum(s * w for s, w in zip(selq, wq))
    if clamp_mask:
        logit = jnp.clip(logit, -2.0, 5.0)
    sig = jax.nn.sigmoid(logit)                              # (B,3,M,n)
    cw = sig.prod(axis=1)                                    # (B,M,n)

    # backward (dfeature arrives point-minor: (B,F,n))
    w_pt = cw * cand_valid_f                                 # (B,M,n)
    dw_pt = jnp.einsum("bfn,bmnf->bmn", dfeature, feat_pm)
    dfeat_pm = (w_pt[..., None]
                * dfeature.transpose(0, 2, 1)[:, None])      # (B,M,n,F)
    dcw = dw_pt * cand_valid_f + dcw_out                     # (B,M,n)
    dvalid = dw_pt * cw
    dlogit = dcw[:, None] * cw[:, None] * (1.0 - sig)        # (B,3,M,n)

    dwq4 = [jnp.einsum("bpmnf,bmnf->bpmn", featq[q], dfeat_pm)
            + selq[q] * dlogit for q in range(4)]
    # dg feature lanes: broadcast dfeat_pm over planes, scale by wq[q]
    dg_feat = jnp.concatenate(
        [(wq[q][..., None] * dfeat_pm[:, None]).astype(g.dtype)
         for q in range(4)], axis=-1)                        # (B,3,M,n,4F)
    dg_mask = jnp.concatenate(
        [((dlogit * wq[q])[..., None] * oh[:, None]).astype(g.dtype)
         for q in range(4)], axis=-1)                        # (B,3,M,n,128)
    dg = jnp.concatenate([dg_feat, dg_mask], axis=-1)
    dwq4 = jnp.stack(dwq4, axis=1)                           # (B,4,3,M,n)
    return dg, dwq4, None, dvalid


_unirow_combine.defvjp(_combine_fwd, _combine_bwd)


def sample_candidates_unirow(
        table: jnp.ndarray, cand_pos: jnp.ndarray, cand_idx: jnp.ndarray,
        cand_valid: jnp.ndarray, feat_dim: int, num_bone: int, H: int, W: int,
        clamp_mask: bool = False) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Fused part-prob + weighted-feature sampling, one fetch per
    (point, candidate, plane).

    Args:
        table: (B, 3*(H+1)*(W+1), 4F+128) bf16 from ``pack_unirow``.
        cand_pos: (B, n, M, 3); cand_idx: (B, n, M) int32 bone ids;
        cand_valid: (B, n, M) bool.
    Returns:
        (feature (B, F, n) f32, cand_w (B, n, M) f32) — same contract as
        ops/quadtable.py::sample_candidates_quadtable.
    """
    B, n, M, _ = cand_pos.shape
    F = feat_dim
    HpWp = (H + 1) * (W + 1)
    cp = cand_pos.transpose(0, 3, 2, 1)                    # (B, 3, M, n)
    cells, wq = _quad_cells_weights(cp, H, W)              # (B, 3, M, n)
    plane = jnp.arange(3, dtype=jnp.int32).reshape(1, 3, 1, 1)
    R = table.shape[1]
    rows = (plane * HpWp + cells
            + (jnp.arange(B, dtype=jnp.int32) * R).reshape(B, 1, 1, 1))
    g = jnp.take(table.reshape(B * R, table.shape[-1]), rows.reshape(-1),
                 axis=0).reshape(B, 3, M, n, table.shape[-1])

    wq4 = jnp.stack(wq, axis=1)                            # (B, 4, 3, M, n)
    ci = cand_idx.transpose(0, 2, 1)                       # (B, M, n)
    cv = cand_valid.transpose(0, 2, 1).astype(jnp.float32)
    feature, cand_wn = _unirow_combine(g, wq4, ci, cv, F, clamp_mask)
    return feature, cand_wn.transpose(0, 2, 1)
