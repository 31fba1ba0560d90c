"""Patch-window tri-plane sampling — shared window fetches across rays.

The per-member samplers (ops/unirow.py, ops/quadtable.py) pay one row
gather per (point, candidate, plane). This sampler exploits ACROSS-RAY
locality instead: with depth bins pooled per 4×4-pixel patch, the 16
member rays of a (patch, sample, bone, plane) group land within ≤5 texels
of each other on the plane — so ONE 8×8-texel window fetch serves the
whole group:

  fetch   jnp.take of window rows from a stride-2 packed window table
  select  per-member bilinear = one batched einsum (members, 64) one-hot-
          bilinear weights @ (group, 64, F) windows; the 64-vector is the
          outer product of separable 8-wide t/s weight vectors, so the 4
          bilinear corners ride one matmul

The window is 8×8 because stride-2 bases + 8 texels cover member spread
≤ 5 unconditionally (7×7 needed even minima for spread 5). The residual
(groups with spread > 5; ~0 on bench geometry) is CLAMPED to the window
edge and reported by ``with_stats`` so callers can assert bounds. The
exact per-member samplers remain the default for eval/interop parity
paths.

Reference equivalents: libraries/triplane/sampling.py:54-127,
cuda_extension/TriplaneSampler_kernel.cu:37-92 (align_corners=False,
zeros padding — reproduced here via the 1-texel zero pad ring).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from enarf_gan_tpu.ops.activation import straight_through_clamp
from enarf_gan_tpu.ops.triplane import PLANE_COORDS

WIN = 8            # window side, texels
NTEX = WIN * WIN   # texels per window
STRIDE = 2         # window base stride, texels
SUB = 16           # rows per packed feature-window tile (SUB*LANE >= 64*F)
LANE = 128
RESCUE_W = 0.5     # uncovered-member rescue weight in select_patch_slots
                   # (module-level so tests can pin its effect on the
                   # sparse-frame capacity leak, tests/test_tilewin_sparse.py)


class TilewinTables(NamedTuple):
    feat: jnp.ndarray    # (B*3*nb*nb, SUB, LANE) bf16 window-row tiles
    mask: jnp.ndarray    # (B*K*3*nb*nb, 64) bf16
    nb: int              # window bases per plane dim
    feat_dim: int
    num_bone: int
    size: int            # plane resolution (H == W)


def _num_bases(size: int) -> int:
    # quad top-left texels py span [0, size] in the zero-padded plane and
    # the quad extends to py+1, so the last window must reach texel size+1:
    # max base >= size - (WIN - 2), rounded up to the stride
    return (size - WIN + 3 + STRIDE - 1) // STRIDE + 1


def pack_tilewin(tri_plane_feature: jnp.ndarray, feat_dim: int,
                 num_bone: int) -> TilewinTables:
    """(B, (F+K)*3, H, W) planes → packed window tables.

    Feature rows hold the 8×8×F window at base (2bi, 2bj) of the 1-texel
    zero-padded plane (grid_sample zero padding), texel-major
    (l = (t·8+s)·F + f); mask rows hold the same window of one bone's
    mask plane, one texel per lane (t·8+s).
    """
    B, C3, H, W = tri_plane_feature.shape
    F, K = feat_dim, num_bone
    assert C3 == (F + K) * 3 and H == W, (C3, F, K, H, W)
    nb = _num_bases(H)
    span = (nb - 1) * STRIDE + WIN     # padded extent windows address

    feat = tri_plane_feature[:, :F * 3].reshape(B, 3, F, H, W) \
        .transpose(0, 1, 3, 4, 2)                          # (B,3,H,W,F)
    mask = tri_plane_feature[:, F * 3:].reshape(B, K, 3, H, W) \
        .transpose(0, 1, 2, 3, 4)                          # (B,K,3,H,W)

    pf = jnp.pad(feat, ((0, 0), (0, 0), (1, span - H - 1),
                        (1, span - W - 1), (0, 0)))
    pm = jnp.pad(mask, ((0, 0), (0, 0), (0, 0), (1, span - H - 1),
                        (1, span - W - 1)))

    # Texel slabs are stacked on axis 0 (major) and transposed ONCE at the
    # end: stacking them texel-MINOR makes XLA materialize each slab as a
    # (N, 1) array, which tiled layouts pad up to 128x.
    def windows(p, ch_last):  # → (64, ..., nb, nb[, C])
        slabs = []
        for dt in range(WIN):
            for ds in range(WIN):
                sl = p[..., dt:dt + (nb - 1) * STRIDE + 1:STRIDE,
                       ds:ds + (nb - 1) * STRIDE + 1:STRIDE] \
                    if not ch_last else \
                    p[..., dt:dt + (nb - 1) * STRIDE + 1:STRIDE,
                      ds:ds + (nb - 1) * STRIDE + 1:STRIDE, :]
                slabs.append(sl)
        return jnp.stack(slabs, axis=0)

    fw = windows(pf, True)              # (64, B, 3, nb, nb, F)
    fw = fw.reshape(NTEX, B * 3 * nb * nb, F).astype(jnp.bfloat16) \
        .transpose(1, 0, 2)             # (N, 64, F): texel-major rows
    fw = fw.reshape(B * 3 * nb * nb, NTEX * F)
    width = -(-NTEX * F // (SUB * LANE)) * SUB * LANE
    fw = jnp.pad(fw, ((0, 0), (0, width - NTEX * F)))
    fw = fw.reshape(-1, width // LANE, LANE)

    mw = windows(pm, False)             # (64, B, K, 3, nb, nb)
    mw = mw.reshape(NTEX, B * K * 3 * nb * nb).astype(jnp.bfloat16)
    # materialize the texel-MAJOR (64, N) stack before transposing: without
    # the barrier XLA fuses the transpose into the 64 strided slices and
    # each materializes as a (1, N) minor-0 array
    mw = jax.lax.optimization_barrier(mw)
    mw = mw.transpose(1, 0)             # (N, 64)
    return TilewinTables(fw, mw, nb, F, K, H)


def member_texels(cp: jnp.ndarray, size: int):
    """Padded-plane texel coords + bilinear fractions per (plane, member).

    cp: (B, 3, Mp, n) canonical positions in [-1, 1] (invalid slots at 2).
    Returns py, px (B,3,Mp,n) int32 in [0, size] (top-left texel of the
    2×2 quad in the 1-texel zero-padded plane) and fy, fx fractions —
    identical sampling semantics to ops/quadtable._quad_cells_weights
    (align_corners=False + zero padding: the pad ring IS the zero border).
    """
    H = W = size
    pys, pxs, fys, fxs = [], [], [], []
    for p, (i, j) in enumerate(PLANE_COORDS):
        x = (cp[:, i] + 1) * (W / 2) - 0.5
        y = (cp[:, j] + 1) * (H / 2) - 0.5
        x0 = jnp.floor(x)
        y0 = jnp.floor(y)
        fxs.append(x - x0)
        fys.append(y - y0)
        pxs.append(jnp.clip(x0, -1, W - 1).astype(jnp.int32) + 1)
        pys.append(jnp.clip(y0, -1, H - 1).astype(jnp.int32) + 1)
    stack = lambda l: jnp.stack(l, axis=1)  # noqa: E731
    return stack(pys), stack(pxs), stack(fys), stack(fxs)


def group_bases(py, px, valid, nb: int):
    """Window base (stride-aligned, clipped) per (B, 3, Mp, np, S) group
    from the member texel minima (invalid members excluded via +big)."""
    big = jnp.int32(10 ** 6)
    inv = jnp.where(valid, 0, big)
    min_t = (py + inv).min(axis=4)                    # (B,3,Mp,np,S)
    min_s = (px + inv).min(axis=4)
    hi = (nb - 1) * STRIDE
    bt = jnp.clip((min_t // STRIDE) * STRIDE, 0, hi)
    bs = jnp.clip((min_s // STRIDE) * STRIDE, 0, hi)
    return bt, bs


def _sep_weights(d, f, lim: int):
    """lim-wide separable bilinear weight vector:
    w[i] = [i==d](1-f) + [i==d+1]f. d: (...,) int32 window-local texel
    offset; clamped members saturate at the window edge (d clipped into
    [0, lim-2] by callers)."""
    d = jnp.clip(d, 0, lim - 1)
    iota = jax.lax.broadcasted_iota(jnp.int32, d.shape + (lim,), d.ndim)
    dd = d[..., None]
    ff = f[..., None]
    return jnp.where(iota == dd, 1.0 - ff,
                     jnp.where(iota == dd + 1, ff, 0.0))


def select_patch_slots(canonical: jnp.ndarray, validity: jnp.ndarray,
                       n_patch: int, m: int, S: int, Mp: int):
    """Patch-level candidate bones: the Mp best bones per (patch, sample).

    Patch-pooled analog of ops/triplane.select_candidate_bones. Greedy
    selection: each slot takes the bone maximizing
    (max member score: valid ? 1 + cube-centrality : -1)
    + RESCUE_W · (count of still-uncovered members it would cover).
    The centrality term keeps the slots agreeing with the exact path's
    per-point top-M choice on dense scenes; the uncovered-rescue term
    vanishes once every member has a covering slot, and on sparse
    silhouette-straddling frames (where >Mp bones compete) it cuts the
    capacity leak — members whose every valid bone misses the Mp slots —
    from ~5% to <4% (tests/test_tilewin_sparse.py; ~0% on dense bench
    geometry either way).

    Args:
        canonical: (B, K, 3, n) canonical positions,
            point order ((patch*m + member)*S + sample).
        validity: (B, K, n) bool.
    Returns:
        slot_idx (B, Mp, np, S) int32; cand_pos (B, 3, Mp, np, m, S);
        cand_valid (B, Mp, np, m, S) bool.
    """
    B, K, _, n = canonical.shape
    assert n == n_patch * m * S, (n, n_patch, m, S)
    centrality = 1.0 - jnp.abs(canonical).max(axis=2)        # (B, K, n)
    score_m = jnp.where(validity, 1.0 + centrality, -1.0) \
        .reshape(B, K, n_patch, m, S)
    pooled = score_m.max(axis=3)                             # (B,K,np,S)
    covers = validity.reshape(B, K, n_patch, m, S) \
        .astype(canonical.dtype)                             # (B,K,np,m,S)

    bone_ids = jnp.arange(K, dtype=jnp.int32).reshape(1, K, 1, 1)
    uncov = jnp.ones((B, 1, n_patch, m, S), canonical.dtype)
    idx_l, oh_l = [], []
    taken = jnp.zeros_like(pooled, dtype=bool)
    for _ in range(Mp):
        rescue = (covers * uncov).sum(axis=3)                # (B,K,np,S)
        sc = jnp.where(taken, -jnp.inf, pooled + RESCUE_W * rescue)
        i = jnp.argmax(sc, axis=1).astype(jnp.int32)         # (B, np, S)
        sel = bone_ids == i[:, None]                         # (B, K, np, S)
        idx_l.append(i)
        oh_l.append(sel)
        taken = taken | sel
        new_cov = (sel[:, :, :, None].astype(covers.dtype) * covers) \
            .max(axis=1, keepdims=True)                      # (B,1,np,m,S)
        uncov = uncov * (1.0 - new_cov)
    slot_idx = jnp.stack(idx_l, axis=1)                      # (B,Mp,np,S)
    oh = jnp.stack(oh_l, axis=1).astype(canonical.dtype)     # (B,Mp,K,np,S)

    canonical_r = canonical.reshape(B, K, 3, n_patch, m, S)
    cand_pos = jnp.einsum("bgkns,bkcnms->bgcnms", oh, canonical_r) \
        .transpose(0, 2, 1, 3, 4, 5)                         # (B,3,Mp,np,m,S)
    valid_r = validity.reshape(B, K, n_patch, m, S)
    cand_valid = jnp.einsum("bgkns,bknms->bgnms", oh,
                            valid_r.astype(canonical.dtype)) > 0.5
    return slot_idx, cand_pos, cand_valid


def sample_tilewin(tables: TilewinTables, cand_pos: jnp.ndarray,
                   slot_idx: jnp.ndarray, cand_valid: jnp.ndarray,
                   clamp_mask: bool = False, with_stats: bool = False):
    """Fused window-shared part-prob + weighted-feature sampling.

    Args:
        tables: packed tables from ``pack_tilewin``.
        cand_pos: (B, 3, Mp, np, m, S) canonical positions per member/slot
            (invalid slots at 2.0), from ``select_patch_slots``.
        slot_idx: (B, Mp, np, S) int32 slot bone ids.
        cand_valid: (B, Mp, np, m, S) bool.
    Returns:
        (feature (B, F, np*m*S) f32, cand_w (B, Mp, np, m, S) f32
        [, stats]) — stats (if requested) = {"clamped": fraction of valid
        member-plane fetches outside their group window (edge-clamped)}.
    """
    B, _, Mp, n_patch, m, S = cand_pos.shape
    F, K, nb, size = (tables.feat_dim, tables.num_bone, tables.nb,
                      tables.size)
    n = n_patch * m * S
    cp = cand_pos.reshape(B, 3, Mp, n)
    py, px, fy, fx = member_texels(cp, size)
    pym = py.reshape(B, 3, Mp, n_patch, m, S)
    pxm = px.reshape(B, 3, Mp, n_patch, m, S)
    vm = jnp.broadcast_to(cand_valid[:, None],
                          (B, 3, Mp, n_patch, m, S))
    bt, bs = group_bases(pym, pxm, vm, nb)              # (B,3,Mp,np,S)

    # Layout note: a plane-major layout materializes per-plane f32
    # (…, m, F) features plus a transpose of them in device memory.
    # Everything below is arranged PLANE-MINOR so (plane, texel) merge into
    # one 192-wide contraction straight out of the gather, with no
    # transpose of anything bigger than the f32 coordinate tensors.

    # feature window rows in (B, Mp, np, S, 3) order → the gathered rows
    # land plane-adjacent-to-texels with p-major lane order (p, w, f)
    plane = jnp.arange(3, dtype=jnp.int32).reshape(1, 1, 1, 1, 3)
    batch = jnp.arange(B, dtype=jnp.int32).reshape(B, 1, 1, 1, 1)
    bi = (bt // STRIDE).transpose(0, 2, 3, 4, 1)        # (B,Mp,np,S,3)
    bj = (bs // STRIDE).transpose(0, 2, 3, 4, 1)
    frows = ((batch * 3 + plane) * nb + bi) * nb + bj   # (B,Mp,np,S,3)
    g = jnp.take(tables.feat, frows.reshape(-1), axis=0)
    g = g.reshape(B, Mp, n_patch, S, 3 * NTEX, F)       # (p,w)-merged

    # mask window rows: ((b*K + k)*3 + p)*nb² + bi*nb + bj
    mrows = (((batch * K + slot_idx[..., None]) * 3 + plane)
             * nb + bi) * nb + bj                       # (B,Mp,np,S,3)
    gm = jnp.take(tables.mask, mrows.reshape(-1), axis=0)
    gm = gm.reshape(B, Mp, n_patch, S, 3, NTEX)

    # per-member separable window weights, members-then-plane minor
    def expand(v):  # (B,3,Mp,np,S) → (B,3,Mp,np,m,S) member broadcast
        return v[:, :, :, :, None]

    dt = pym - expand(bt)
    ds = pxm - expand(bs)
    clamped = ((dt < 0) | (dt > WIN - 2) | (ds < 0) | (ds > WIN - 2))
    toT = lambda v: v.transpose(0, 2, 3, 5, 4, 1)  # noqa: E731
    # (B,3,Mp,np,m,S) → (B,Mp,np,S,m,3): f32 coords only — a few MB
    wt = _sep_weights(toT(jnp.clip(dt, 0, WIN - 2)),
                      toT(fy.reshape(pym.shape)), WIN)  # (B,Mp,np,S,m,3,8)
    ws = _sep_weights(toT(jnp.clip(ds, 0, WIN - 2)),
                      toT(fx.reshape(pxm.shape)), WIN)
    w64 = (wt[..., :, None] * ws[..., None, :]) \
        .reshape(B, Mp, n_patch, S, m, 3, NTEX).astype(jnp.bfloat16)
    # zero the weights of invalid members so garbage texels never leak
    w64 = w64 * toT(vm)[..., None].astype(w64.dtype)

    # select+bilinear+plane-sum: ONE batched contraction over all
    # 3·64 (plane, texel) lanes; the 12 bilinear corners are the nonzeros
    w192 = w64.reshape(B, Mp, n_patch, S, m, 3 * NTEX)
    feat = jnp.einsum("bgnsmw,bgnswf->bgnsmf", w192, g,
                      preferred_element_type=jnp.float32)
    # mask logit stays per-plane (cand_w = prod_p sigmoid(logit_p))
    logit = jnp.einsum("bgnsmpw,bgnspw->bgnsmp", w64,
                       gm.astype(jnp.bfloat16),
                       preferred_element_type=jnp.float32)
    if clamp_mask:
        logit = straight_through_clamp(logit)
    cand_wn = jax.nn.sigmoid(logit).prod(axis=-1)       # (B,Mp,np,S,m)

    vf = cand_valid.transpose(0, 1, 2, 4, 3).astype(jnp.float32)
    w = cand_wn * vf                                    # (B,Mp,np,S,m)
    feature = jnp.einsum("bgnsmf,bgnsm->bfnms", feat, w).reshape(B, F, n)
    cand_w = cand_wn.transpose(0, 1, 2, 4, 3)           # (B,Mp,np,m,S)
    if not with_stats:
        return feature, cand_w
    stats = {"clamped": (clamped & vm).sum() / jnp.maximum(vm.sum(), 1)}
    return feature, cand_w, stats
