"""Row-table tri-plane sampling.

Replaces the channel-broadcast gathers of ``ops/grid_sample.py`` on the hot
path (reference equivalents: libraries/triplane/sampling.py:54-127 and
cuda_extension/TriplaneSampler_kernel.cu:37-92).

SUPERSEDED by ``ops/quadtable.py`` (one fetch per sample-plane); kept as a
second independently-tested formulation (ENARF_SAMPLER=rowtable). Layout
rationale: ``jnp.take(table, rows, axis=0)`` with the channel axis MINOR
fetches whole rows, while a ``take_along_axis`` whose index is broadcast
over a 32-wide channel axis degrades to per-element gathers. So we lay the
planes out channels-last as
one flat row table and make each bilinear sample exactly TWO row fetches:

* row r = (plane p, line y, pair-slot s) holds the lane vector
  ``[feat[x=s-1] | feat[x=s] | mask[x=s-1] | mask[x=s]]`` — an x-pair, so
  the x-interpolation needs no extra fetch;
* pair-slots run s = 0..W (W+1 per line) with zero pads at s=0 and s=W,
  which reproduces ``grid_sample(padding_mode='zeros',
  align_corners=False)`` exactly at every edge — no cross-line bleed;
* the per-bone mask logits (all K bones) ride the same rows, so part
  probabilities (sampling.py:54-76) cost no extra gathers — the bone of
  interest is selected per sample with a one-hot dot over lanes.

The two y-rows (y0, y0+1) are fetched for all 3 planes of all M candidate
bones in a single ``jnp.take``.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from enarf_gan_tpu.ops.activation import straight_through_clamp
from enarf_gan_tpu.ops.triplane import PLANE_COORDS


def pack_rowtable(tri_plane_feature: jnp.ndarray, feat_dim: int,
                  num_bone: int, dtype=jnp.float32) -> jnp.ndarray:
    """(B, (F+K)*3, H, W) planes → (B, 3*H*(W+1), 2F+2K pad 128) row table.

    Channel layout of the input follows the model: first F*3 channels are the
    three F-wide feature planes, then K*3 one-channel-per-bone mask planes
    (reference models/narf.py:71).
    """
    B, C3, H, W = tri_plane_feature.shape
    F, K = feat_dim, num_bone
    assert C3 == (F + K) * 3, (C3, F, K)
    feat = tri_plane_feature[:, :F * 3].reshape(B, 3, F, H, W)
    mask = tri_plane_feature[:, F * 3:].reshape(B, K, 3, H, W).transpose(0, 2, 1, 3, 4)
    # (B, 3, H, W, F+K) channels-last
    ch = jnp.concatenate([feat, mask], axis=2).transpose(0, 1, 3, 4, 2)
    zero = jnp.zeros(ch.shape[:3] + (1, F + K), ch.dtype)
    left = jnp.concatenate([zero, ch], axis=3)    # value at x = s-1
    right = jnp.concatenate([ch, zero], axis=3)   # value at x = s
    lanes = 2 * (F + K)
    pad = (-lanes) % 128
    # lane order the sampler slices: [featL | featR | maskL | maskR]
    table = jnp.concatenate([left[..., :F], right[..., :F],
                             left[..., F:], right[..., F:]], axis=4)
    if pad:
        table = jnp.concatenate(
            [table, jnp.zeros(table.shape[:-1] + (pad,), table.dtype)], axis=-1)
    return table.reshape(B, 3 * H * (W + 1), lanes + pad).astype(dtype)


def _sample_rows(cand_pos: jnp.ndarray, H: int, W: int):
    """Rows + bilinear weights for every (plane, candidate, point) sample.

    cand_pos: (B, n, M, 3) canonical positions in [-1, 1] (invalid at 2).
    Returns rows (B, 3, n, M, 2) int32 into a (3*H*(W+1),)-row table and
    weights wy (B, 3, n, M, 2), cx (B, 3, n, M, 2) f32.
    """
    Wp = W + 1
    rows_l, wy_l, cx_l = [], [], []
    for p, (i, j) in enumerate(PLANE_COORDS):
        x = (cand_pos[..., i] + 1) * (W / 2) - 0.5   # (B, n, M)
        y = (cand_pos[..., j] + 1) * (H / 2) - 0.5
        x0 = jnp.floor(x)
        y0 = jnp.floor(y)
        fx = x - x0
        fy = y - y0
        in_x0 = (x0 >= 0) & (x0 <= W - 1)
        in_x1 = (x0 + 1 >= 0) & (x0 + 1 <= W - 1)
        in_y0 = (y0 >= 0) & (y0 <= H - 1)
        in_y1 = (y0 + 1 >= 0) & (y0 + 1 <= H - 1)
        s = jnp.clip(x0, -1, W - 1).astype(jnp.int32) + 1   # pair slot 0..W
        y0i = jnp.clip(y0, 0, H - 1).astype(jnp.int32)
        y1i = jnp.clip(y0 + 1, 0, H - 1).astype(jnp.int32)
        base = p * H * Wp
        row0 = base + y0i * Wp + s
        row1 = base + y1i * Wp + s
        wy0 = (1 - fy) * in_y0
        wy1 = fy * in_y1
        cx0 = (1 - fx) * in_x0
        cx1 = fx * in_x1
        rows_l.append(jnp.stack([row0, row1], axis=-1))
        wy_l.append(jnp.stack([wy0, wy1], axis=-1))
        cx_l.append(jnp.stack([cx0, cx1], axis=-1))
    rows = jnp.stack(rows_l, axis=1)  # (B, 3, n, M, 2)
    wy = jnp.stack(wy_l, axis=1).astype(jnp.float32)
    cx = jnp.stack(cx_l, axis=1).astype(jnp.float32)
    return rows, wy, cx


def sample_candidates_rowtable(
        table: jnp.ndarray, cand_pos: jnp.ndarray, cand_idx: jnp.ndarray,
        cand_valid: jnp.ndarray, feat_dim: int, num_bone: int, H: int, W: int,
        clamp_mask: bool = False) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Fused part-prob + weighted-feature sampling over candidate bones.

    Computes, per point, ``w_m = prod_p sigmoid(mask_m(pos_m))`` and
    ``feature = sum_m w_m * sum_p feat(pos_m)`` — the candidate-sparse
    equivalent of reference sampling.py:54-127, in two row gathers total.

    Args:
        table: (B, 3*H*(W+1), LANES) from ``pack_rowtable``.
        cand_pos: (B, n, M, 3); cand_idx: (B, n, M) int32 bone ids;
        cand_valid: (B, n, M) bool.
    Returns:
        (feature (B, F, n) f32, cand_w (B, n, M) f32).
    """
    B, n, M, _ = cand_pos.shape
    F, K = feat_dim, num_bone
    R = table.shape[1]
    rows, wy, cx = _sample_rows(cand_pos, H, W)      # (B, 3, n, M, 2)

    # one take for everything: (B, 3, n, M, 2) rows → (..., LANES)
    flat_rows = (rows + (jnp.arange(B, dtype=jnp.int32) * R)
                 .reshape(B, 1, 1, 1, 1)).reshape(-1)
    g = jnp.take(table.reshape(B * R, -1), flat_rows, axis=0)
    g = g.reshape(B, 3, n, M, 2, -1)

    # y-interpolation, keeping f32 accumulation
    gy = (g[..., 0, :] * wy[..., 0, None].astype(g.dtype)
          + g[..., 1, :] * wy[..., 1, None].astype(g.dtype)).astype(jnp.float32)
    cx0 = cx[..., 0, None]
    cx1 = cx[..., 1, None]
    feat = gy[..., :F] * cx0 + gy[..., F:2 * F] * cx1          # (B,3,n,M,F)
    mask_all = gy[..., 2 * F:2 * F + K] * cx0 \
        + gy[..., 2 * F + K:2 * F + 2 * K] * cx1               # (B,3,n,M,K)

    bone_oh = jax.nn.one_hot(cand_idx, K, dtype=mask_all.dtype)  # (B,n,M,K)
    logit = (mask_all * bone_oh[:, None]).sum(axis=-1)           # (B,3,n,M)
    if clamp_mask:
        logit = straight_through_clamp(logit)
    cand_w = jax.nn.sigmoid(logit).prod(axis=1)                  # (B,n,M)

    w = (cand_w * cand_valid).astype(feat.dtype)
    feature = jnp.einsum("bpnmf,bnm->bfn", feat, w)              # (B,F,n)
    return feature, cand_w
