"""Quad-packed tri-plane sampling (the f32 per-member sampler).

Replaces ``ops/rowtable.py`` (two row fetches per sample) with ONE feature
row fetch plus one slim mask row fetch per (point, candidate, plane): each
table row holds the full 2x2 bilinear texel quad for one sample cell, so
the bilinear interpolation becomes lane arithmetic on the fetched row.

Reference equivalents: libraries/triplane/sampling.py:54-127 and
cuda_extension/TriplaneSampler_kernel.cu:37-92 (the fused gather-sum with
``align_corners=False`` + zeros padding). The two design rules are (a)
fetch each texel quad once, (b) fetch only the bytes you use. Hence two
tables:

* feature table — rows of 4F lanes (=128 for F=32), one row per sample cell:

      [A_f | B_f | C_f | D_f]    A=plane[t-1,s-1] B=[t-1,s]
                                  C=plane[t,  s-1] D=[t,  s]

  (zeros out of bounds — exactly grid_sample's zero padding), row
  r = p*(H+1)*(W+1) + t*(W+1) + s for plane p, cell (t, s);

* mask table — the per-bone mask planes as 4-lane quad rows indexed by
  (bone, plane, cell): r = ((k*3 + p)*(H+1) + t)*(W+1) + s. The candidate's
  bone id goes INTO the row index, so part probabilities cost 8 bytes per
  sample-plane and no K-wide select.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from enarf_gan_tpu.ops.activation import straight_through_clamp
from enarf_gan_tpu.ops.triplane import PLANE_COORDS

QuadTables = Tuple[jnp.ndarray, jnp.ndarray]


def pack_quadtable(tri_plane_feature: jnp.ndarray, feat_dim: int,
                   num_bone: int, dtype=jnp.float32) -> QuadTables:
    """(B, (F+K)*3, H, W) planes → (feat_table, mask_table).

    feat_table: (B, 3*(H+1)*(W+1), 4F); mask_table: (B, K*3*(H+1)*(W+1), 4).
    Channel layout of the input follows the model: first F*3 channels are the
    three F-wide feature planes, then K*3 one-channel-per-bone mask planes
    (reference models/narf.py:71).
    """
    B, C3, H, W = tri_plane_feature.shape
    F, K = feat_dim, num_bone
    assert C3 == (F + K) * 3, (C3, F, K)
    feat = tri_plane_feature[:, :F * 3].reshape(B, 3, F, H, W) \
        .transpose(0, 1, 3, 4, 2)                       # (B,3,H,W,F)
    mask = tri_plane_feature[:, F * 3:].reshape(B, K * 3, H, W)[..., None]
    return (quad_pack_corners(feat).reshape(B, -1, 4 * F).astype(dtype),
            quad_pack_corners(mask).reshape(B, -1, 4).astype(dtype))


def quad_pack_corners(ch: jnp.ndarray) -> jnp.ndarray:
    """(B, P, H, W, C) planes → (B, P, (H+1)*(W+1), 4C) quad rows [A|B|C|D].

    Row (t, s) holds the 2×2 bilinear texel quad of the 1-texel zero-padded
    plane (grid_sample zero-padding semantics). Shared by the quadtable and
    unirow packers so the quad layout can never desynchronize between them.
    """
    B, Pax, H, W, _ = ch.shape
    P = jnp.pad(ch, ((0, 0), (0, 0), (1, 1), (1, 1), (0, 0)))
    q = jnp.concatenate(
        [P[:, :, :H + 1, :W + 1], P[:, :, :H + 1, 1:],
         P[:, :, 1:, :W + 1], P[:, :, 1:, 1:]], axis=-1)
    return q.reshape(B, Pax, (H + 1) * (W + 1), q.shape[-1])


def _quad_cells_weights(cp: jnp.ndarray, H: int, W: int):
    """Cell index (t, s) + 4 bilinear corner weights per (plane, cand, pt).

    cp: (B, 3, M, n) canonical positions in [-1, 1] (invalid at 2), with the
    POINT axis minor — every per-sample scalar op below runs over the long
    contiguous axis.
    Returns cells (B, 3, M, n) int32 (= t*(W+1)+s) and wq: 4 arrays
    (B, 3, M, n) f32 in corner order [A, B, C, D].
    """
    cells_l = []
    wq_l = [[], [], [], []]
    for p, (i, j) in enumerate(PLANE_COORDS):
        x = (cp[:, i] + 1) * (W / 2) - 0.5   # (B, M, n)
        y = (cp[:, j] + 1) * (H / 2) - 0.5
        x0 = jnp.floor(x)
        y0 = jnp.floor(y)
        fx = x - x0
        fy = y - y0
        in_x0 = (x0 >= 0) & (x0 <= W - 1)
        in_x1 = (x0 >= -1) & (x0 <= W - 2)
        in_y0 = (y0 >= 0) & (y0 <= H - 1)
        in_y1 = (y0 >= -1) & (y0 <= H - 2)
        s = jnp.clip(x0, -1, W - 1).astype(jnp.int32) + 1   # cell 0..W
        t = jnp.clip(y0, -1, H - 1).astype(jnp.int32) + 1   # cell 0..H
        cells_l.append(t * (W + 1) + s)
        cx0 = (1 - fx) * in_x0
        cx1 = fx * in_x1
        wy0 = (1 - fy) * in_y0
        wy1 = fy * in_y1
        for q, w in enumerate((cx0 * wy0, cx1 * wy0, cx0 * wy1, cx1 * wy1)):
            wq_l[q].append(w)
    cells = jnp.stack(cells_l, axis=1)                       # (B, 3, M, n)
    wq = [jnp.stack(ws, axis=1).astype(jnp.float32) for ws in wq_l]
    return cells, wq


def sample_candidates_quadtable(
        tables: QuadTables, cand_pos: jnp.ndarray, cand_idx: jnp.ndarray,
        cand_valid: jnp.ndarray, feat_dim: int, num_bone: int, H: int, W: int,
        clamp_mask: bool = False) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Fused part-prob + weighted-feature sampling over candidate bones.

    Computes, per point, ``w_m = prod_p sigmoid(mask_m(pos_m))`` and
    ``feature = sum_m w_m * sum_p feat(pos_m)`` — the candidate-sparse
    equivalent of reference sampling.py:54-127 — in one wide + one slim row
    gather.

    Args:
        tables: (feat_table, mask_table) from ``pack_quadtable``.
        cand_pos: (B, n, M, 3); cand_idx: (B, n, M) int32 bone ids;
        cand_valid: (B, n, M) bool.
    Returns:
        (feature (B, F, n) f32, cand_w (B, n, M) f32).
    """
    feat_table, mask_table = tables
    B, n, M, _ = cand_pos.shape
    F, K = feat_dim, num_bone
    HpWp = (H + 1) * (W + 1)
    cp = cand_pos.transpose(0, 3, 2, 1)                   # (B, 3, M, n)
    cells, wq = _quad_cells_weights(cp, H, W)             # (B, 3, M, n)
    plane = jnp.arange(3, dtype=jnp.int32).reshape(1, 3, 1, 1)

    # --- feature gather: row = plane*HpWp + cell ---
    Rf = feat_table.shape[1]
    frows = (plane * HpWp + cells
             + (jnp.arange(B, dtype=jnp.int32) * Rf).reshape(B, 1, 1, 1))
    g = jnp.take(feat_table.reshape(B * Rf, 4 * F), frows.reshape(-1),
                 axis=0).reshape(B, 3, M, n, 4 * F)

    # --- mask gather: row = (bone*3 + plane)*HpWp + cell — the bone id is
    # part of the row index, so no K-wide select is ever materialized
    Rm = mask_table.shape[1]
    ci = cand_idx.transpose(0, 2, 1)[:, None]             # (B, 1, M, n)
    mrows = ((ci * 3 + plane) * HpWp + cells
             + (jnp.arange(B, dtype=jnp.int32) * Rm).reshape(B, 1, 1, 1))
    gm = jnp.take(mask_table.reshape(B * Rm, 4), mrows.reshape(-1),
                  axis=0).reshape(B, 3, M, n, 4)

    # XLA combine: 4 slices over g in one fused pass; the wq factors stay
    # as four separate n-minor arrays (never stacked into a 4-wide minor
    # layout)
    feat = sum(g[..., q * F:(q + 1) * F]
               * wq[q][..., None].astype(g.dtype) for q in range(4))
    feat = feat.astype(jnp.float32).sum(axis=1)           # (B, M, n, F)
    logit = sum(gm[..., q].astype(jnp.float32) * wq[q] for q in range(4))
    if clamp_mask:
        logit = straight_through_clamp(logit)
    cand_wn = jax.nn.sigmoid(logit).prod(axis=1)          # (B, M, n)

    w = cand_wn * cand_valid.transpose(0, 2, 1)           # (B, M, n)
    feature = (feat * w[..., None]).sum(axis=1)           # (B, n, F)
    return feature.transpose(0, 2, 1), cand_wn.transpose(0, 2, 1)
