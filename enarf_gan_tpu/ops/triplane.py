"""Tri-plane feature sampling (XLA path).

Re-design of the reference's tri-plane ops
(reference: libraries/triplane/sampling.py:9-127 and
cuda_extension/TriplaneSampler_kernel.cu). Design differences, deliberate:

* The reference packs B tri-planes side-by-side into one wide plane and
  gathers only "valid" (bone, point) pairs with dynamic-shape
  gather/scatter_add (sampling.py:34-38, 99-123). Under XLA we keep static
  shapes: batching is a plain leading axis, and validity is a multiplicative
  mask. Invalid positions are placed at coordinate 2 (outside every plane) so
  zeros-padding makes them contribute nothing — the same masked semantics the
  reference's sparse path computes.
* The CUDA fused gather-sum kernel (TriplaneSampler.cpp:20) is replaced by
  the quad-packed row-gather sampler (``ops/quadtable.py``, the default hot
  path); this module is the correctness reference and dense fallback.

Plane coordinate convention (matches sampling.py:30 / kernel.cu:37-38):
plane 0 is indexed by (x, y), plane 1 by (y, z), plane 2 by (z, x), where the
first coordinate of the pair is the grid-sample x (width) axis.
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from enarf_gan_tpu.ops.activation import straight_through_clamp
from enarf_gan_tpu.ops.grid_sample import grid_sample_2d

# (x,y), (y,z), (z,x) index pairs for the three planes
PLANE_COORDS = ((0, 1), (1, 2), (2, 0))


def sample_feature(tri_plane_features: jnp.ndarray, position: jnp.ndarray,
                   reduction: str = "sum", clamp_mask: bool = False) -> jnp.ndarray:
    """Sample tri-plane features at 3-D positions.

    Args:
        tri_plane_features: (B, F*3, H, W) — three F-channel planes stacked.
        position: (B, 3, n) in [-1, 1] (out-of-range samples → 0).
        reduction: "sum" (features) or "prod" (sigmoid-product part prob).
        clamp_mask: straight-through clamp of logits before sigmoid (prod only).
    Returns:
        (B, F, n).
    """
    B, C3, H, W = tri_plane_features.shape
    F = C3 // 3
    n = position.shape[-1]
    planes = tri_plane_features.reshape(B * 3, F, H, W)
    # 2-D coords per plane: (B, 3planes, n, 2) → (B*3, n, 2)
    coords = jnp.stack(
        [jnp.stack([position[:, i], position[:, j]], axis=-1) for i, j in PLANE_COORDS],
        axis=1).reshape(B * 3, n, 2)
    feat = grid_sample_2d(planes, coords).reshape(B, 3, F, n)
    if reduction == "sum":
        return feat.sum(axis=1)
    elif reduction == "prod":
        if clamp_mask:
            feat = straight_through_clamp(feat)
        return jax.nn.sigmoid(feat).prod(axis=1)
    raise ValueError(f"unknown reduction {reduction!r}")


def sample_triplane_part_prob(tri_plane_weights: jnp.ndarray, position: jnp.ndarray,
                              position_validity: Optional[jnp.ndarray] = None,
                              mode: str = "prod", clamp_mask: bool = False) -> jnp.ndarray:
    """Per-part probability from per-bone mask tri-planes.

    Matches reference sampling.py:54-76.

    Args:
        tri_plane_weights: (B*n_bone, 3, H, W) — one 1-channel tri-plane per bone.
        position: (B, n_bone, 3, n).
        position_validity: (B, n_bone, n) bool, used by "sum" mode softmax.
    Returns:
        (B, n_bone, n) weights.
    """
    bs, n_bone, _, n = position.shape
    pos = position.reshape(bs * n_bone, 3, n)
    if mode == "prod":
        w = sample_feature(tri_plane_weights, pos, reduction="prod", clamp_mask=clamp_mask)
        return w.reshape(bs, n_bone, n)
    elif mode == "sum":
        w = sample_feature(tri_plane_weights, pos, reduction="sum", clamp_mask=clamp_mask)
        w = w.reshape(bs, n_bone, n)
        w = w - (~position_validity) * 1e4
        return jax.nn.softmax(w, axis=1)
    else:
        return jnp.full((bs, n_bone, n), 1.0 / n_bone, position.dtype)


def select_candidate_bones(canonical_pos: jnp.ndarray, validity: jnp.ndarray,
                           max_bones: int):
    """Pick the M most-central valid bones per point.

    Bone cubes barely overlap, so per point only a few bones are valid;
    choosing by cube-centrality (1 - max|coord|) is deterministic and keeps
    every valid bone whenever ≤ M are valid — in which case all downstream
    results are exact.

    Args:
        canonical_pos: (B, K, 3, n) canonical coordinates.
        validity: (B, K, n) bool.
    Returns:
        cand_idx (B, n, M) int32, cand_valid (B, n, M) bool,
        cand_pos (B, n, M, 3).
    """
    B, K, _, n = canonical_pos.shape
    M = min(max_bones, K)
    centrality = 1.0 - jnp.abs(canonical_pos).max(axis=2)  # (B, K, n)
    score = jnp.where(validity, 1.0 + centrality, -1.0)
    if M <= 8:
        # M repeated argmax sweeps instead of lax.top_k's per-point sort
        # (same selection: argmax, like top_k, takes the lowest index on ties),
        # and the candidate positions come out via a one-hot contraction —
        # no (B,n,K,3) transpose + gather.
        bone_ids = jnp.arange(K, dtype=jnp.int32)[None, :, None]
        sc = score
        idx_l, val_l, oh_l = [], [], []
        for _ in range(M):
            i = jnp.argmax(sc, axis=1).astype(jnp.int32)     # (B, n)
            sel = bone_ids == i[:, None, :]                  # (B, K, n)
            val_l.append(jnp.max(sc, axis=1))
            idx_l.append(i)
            oh_l.append(sel)
            sc = jnp.where(sel, -jnp.inf, sc)
        top_s = jnp.stack(val_l, axis=-1)                    # (B, n, M)
        top_idx = jnp.stack(idx_l, axis=-1)
        oh = jnp.stack(oh_l, axis=1).astype(canonical_pos.dtype)  # (B,M,K,n)
        cand_pos = jnp.einsum("bmkn,bkin->bnmi", oh, canonical_pos)
    else:
        top_s, top_idx = jax.lax.top_k(score.transpose(0, 2, 1), M)  # (B, n, M)
        pos = canonical_pos.transpose(0, 3, 1, 2)  # (B, n, K, 3)
        cand_pos = jnp.take_along_axis(pos, top_idx[..., None], axis=2)
    cand_valid = top_s > 0
    cand_pos = jnp.where(cand_valid[..., None], cand_pos, 2.0)
    return top_idx.astype(jnp.int32), cand_valid, cand_pos


def _bilinear_flat(table_flat: jnp.ndarray, base: jnp.ndarray, x: jnp.ndarray,
                   y: jnp.ndarray, H: int, W: int) -> jnp.ndarray:
    """Bilinear sample of 1-channel planes stored flat.

    table_flat: (T,) concatenated H*W planes; base: flat offset of each
    sample's plane; x, y: pixel coords (grid_sample unnormalized). All index
    arrays share one shape; returns that shape.
    """
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    out = jnp.zeros_like(x)
    for cx, cy, w in ((x0, y0, (1 - (x - x0)) * (1 - (y - y0))),
                      ((x0 + 1), y0, (x - x0) * (1 - (y - y0))),
                      (x0, (y0 + 1), (1 - (x - x0)) * (y - y0)),
                      ((x0 + 1), (y0 + 1), (x - x0) * (y - y0))):
        inb = (cx >= 0) & (cx <= W - 1) & (cy >= 0) & (cy <= H - 1)
        idx = base + jnp.clip(cy, 0, H - 1).astype(jnp.int32) * W \
            + jnp.clip(cx, 0, W - 1).astype(jnp.int32)
        out = out + jnp.take(table_flat, idx) * (w * inb)
    return out


def sample_part_prob_candidates(mask_planes: jnp.ndarray, cand_idx: jnp.ndarray,
                                cand_pos: jnp.ndarray,
                                clamp_mask: bool = False) -> jnp.ndarray:
    """Part probability (prod-of-sigmoids over 3 planes) for candidate bones
    only — sparse counterpart of sample_triplane_part_prob(mode="prod").

    Args:
        mask_planes: (B, K*3, H, W) per-bone mask tri-planes.
        cand_idx: (B, n, M) bone index per candidate.
        cand_pos: (B, n, M, 3) canonical positions (invalid at 2).
    Returns:
        (B, n, M) probabilities.
    """
    B, KC, H, W = mask_planes.shape
    K = KC // 3
    table = mask_planes.reshape(-1)
    batch_off = (jnp.arange(B, dtype=jnp.int32) * (KC * H * W))[:, None, None]
    prob = jnp.ones(cand_idx.shape, cand_pos.dtype)
    for p, (i, j) in enumerate(PLANE_COORDS):
        base = batch_off + (cand_idx * 3 + p) * (H * W)
        x = (cand_pos[..., i] + 1) * (W / 2) - 0.5
        y = (cand_pos[..., j] + 1) * (H / 2) - 0.5
        logit = _bilinear_flat(table, base, x, y, H, W)
        if clamp_mask:
            logit = straight_through_clamp(logit)
        prob = prob * jax.nn.sigmoid(logit)
    return prob


def sample_weighted_feature_candidates(feat_dim: int,
                                       tri_plane_features: jnp.ndarray,
                                       cand_pos: jnp.ndarray,
                                       cand_weight: jnp.ndarray,
                                       cand_valid: jnp.ndarray,
                                       clamp_mask: bool = False) -> jnp.ndarray:
    """Weighted feature sum over pre-selected candidate bones.

    Args:
        tri_plane_features: (B, F*3, H, W) shared feature planes.
        cand_pos: (B, n, M, 3); cand_weight/cand_valid: (B, n, M).
    Returns:
        (B, F, n).
    """
    B, n, M, _ = cand_pos.shape
    p = cand_pos.transpose(0, 3, 1, 2).reshape(B, 3, n * M)
    feat = sample_feature(tri_plane_features, p, reduction="sum",
                          clamp_mask=clamp_mask)  # (B, F, n*M)
    feat = feat.reshape(B, feat_dim, n, M)
    w = (cand_weight * cand_valid).astype(feat.dtype)
    return jnp.einsum("bfnm,bnm->bfn", feat, w)


def sample_weighted_feature_topm(feat_dim: int, tri_plane_features: jnp.ndarray,
                                 position: jnp.ndarray, weight: jnp.ndarray,
                                 position_validity: jnp.ndarray,
                                 max_bones: int = 4,
                                 clamp_mask: bool = False) -> jnp.ndarray:
    """Top-M sparse variant of the weighted feature sum.

    The static-shape counterpart of the reference's valid-pair gather
    (sampling.py:99-123): bone cubes barely overlap, so per point only a few
    bones are valid. Select the ``max_bones`` highest-weight valid bones per
    point and sample features only for those — ~K/M less gather work, exact
    whenever ≤ M bones are simultaneously valid (the overwhelmingly common
    case; set max_bones=K for the exact dense result).
    """
    bs, n_bone, _, n = position.shape
    M = min(max_bones, n_bone)
    score = weight * position_validity  # (B, K, n)
    top_w, top_idx = jax.lax.top_k(score.transpose(0, 2, 1), M)  # (B, n, M)
    pos = position.transpose(0, 3, 1, 2)  # (B, n, K, 3)
    top_pos = jnp.take_along_axis(pos, top_idx[..., None], axis=2)  # (B,n,M,3)
    # invalid selections (score 0) sample at out-of-range coords → 0 feature
    top_pos = jnp.where(top_w[..., None] > 0, top_pos, 2.0)
    p = top_pos.transpose(0, 3, 1, 2).reshape(bs, 3, n * M)
    feat = sample_feature(tri_plane_features, p, reduction="sum",
                          clamp_mask=clamp_mask)  # (B, F, n*M)
    feat = feat.reshape(bs, feat_dim, n, M)
    return jnp.einsum("bfnm,bnm->bfn", feat, top_w)


def sample_weighted_feature(feat_dim: int, tri_plane_features: jnp.ndarray,
                            position: jnp.ndarray, weight: jnp.ndarray,
                            position_validity: jnp.ndarray,
                            clamp_mask: bool = False,
                            max_bones: Optional[int] = None) -> jnp.ndarray:
    """Validity-masked, part-weighted sum of tri-plane features over bones.

    Dense static-shape equivalent of reference sampling.py:79-127
    (``sample_weighted_feature_v2``): for every valid (bone, point) pair,
    sample the shared feature tri-plane at the bone-canonical position,
    multiply by the part weight, and sum over bones.

    Args:
        feat_dim: F (=32).
        tri_plane_features: (B, F*3, H, W) shared feature planes.
        position: (B, n_bone, 3, n) canonical positions (invalid already at 2).
        weight: (B, n_bone, n) part weights.
        position_validity: (B, n_bone, n) bool.
    Returns:
        (B, F, n) float32.
    """
    if max_bones is not None and max_bones < position.shape[1]:
        return sample_weighted_feature_topm(feat_dim, tri_plane_features,
                                            position, weight, position_validity,
                                            max_bones, clamp_mask)
    bs, n_bone, _, n = position.shape
    # fold bones into the batch axis of the (shared) planes
    planes = jnp.broadcast_to(tri_plane_features[:, None],
                              (bs, n_bone) + tri_plane_features.shape[1:])
    planes = planes.reshape(bs * n_bone, *tri_plane_features.shape[1:])
    feat = sample_feature(planes, position.reshape(bs * n_bone, 3, n),
                          reduction="sum", clamp_mask=clamp_mask)
    feat = feat.reshape(bs, n_bone, feat_dim, n)
    w = (weight * position_validity).astype(feat.dtype)
    return jnp.einsum("bkfn,bkn->bfn", feat, w)
