"""tilewin patch-window sampler vs the exact quadtable oracle.

When every member's quad fits its group window (the typical case on
bench geometry), tilewin must reproduce the per-member
quadtable sampler exactly (up to bf16 table rounding)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from enarf_gan_tpu.ops.tilewin import (pack_tilewin, select_patch_slots,
                                       sample_tilewin, WIN)
from enarf_gan_tpu.ops.quadtable import (pack_quadtable,
                                         sample_candidates_quadtable)

TS, F, K = 16, 32, 6
B, NP, M_MEM, S, MP = 2, 3, 4, 5, 3


def make_planes(rng):
    return jax.random.normal(rng, (B, (F + K) * 3, TS, TS), jnp.float32)


def clustered_positions(rng):
    """(B, 3, MP, NP, M_MEM, S) positions clustered per (patch, sample,
    slot) within ~1.5 texels so every group fits one 7x7 window."""
    k1, k2 = jax.random.split(rng)
    centers = jax.random.uniform(k1, (B, 3, MP, NP, 1, S),
                                 minval=-0.85, maxval=0.85)
    jitter = jax.random.uniform(k2, (B, 3, MP, NP, M_MEM, S),
                                minval=-1.5 / TS, maxval=1.5 / TS)
    return jnp.clip(centers + jitter, -0.99, 0.99)


def test_sample_tilewin_matches_quadtable():
    rng = jax.random.PRNGKey(0)
    planes = make_planes(rng)
    tables = pack_tilewin(planes, F, K)

    pos = clustered_positions(jax.random.PRNGKey(1))
    slot_idx = jax.random.randint(jax.random.PRNGKey(2), (B, MP, NP, S),
                                  0, K, jnp.int32)
    valid = jax.random.uniform(jax.random.PRNGKey(3),
                               (B, MP, NP, M_MEM, S)) > 0.2

    feat, cand_w, stats = sample_tilewin(tables, pos, slot_idx, valid,
                                         with_stats=True)
    assert float(stats["clamped"]) == 0.0

    # oracle: exact per-member quadtable on the same candidate structure
    n = NP * M_MEM * S
    qtab = pack_quadtable(planes, F, K, jnp.float32)
    cand_pos = pos.reshape(B, 3, MP, NP, M_MEM, S) \
        .transpose(0, 3, 4, 5, 2, 1).reshape(B, n, MP, 3)
    cand_idx = jnp.broadcast_to(slot_idx[:, :, :, None, None, :]
                                .transpose(0, 2, 3, 4, 5, 1)[:, :, 0],
                                (B, NP, M_MEM, S, MP)).reshape(B, n, MP)
    cand_valid = valid.transpose(0, 2, 3, 4, 1).reshape(B, n, MP)
    feat_ref, w_ref = sample_candidates_quadtable(
        qtab, cand_pos, cand_idx, cand_valid, F, K, TS, TS)

    w_tile = cand_w.transpose(0, 2, 3, 4, 1).reshape(B, n, MP)
    # valid slots must match; invalid slots are free (oracle computes them,
    # tilewin fetches a garbage-window but zeroes the weights)
    vmask = np.asarray(cand_valid)
    np.testing.assert_allclose(np.asarray(w_tile)[vmask],
                               np.asarray(w_ref)[vmask], rtol=2e-2,
                               atol=2e-2)
    np.testing.assert_allclose(np.asarray(feat), np.asarray(feat_ref),
                               rtol=5e-2, atol=5e-2)


def test_sample_tilewin_gradients_flow():
    rng = jax.random.PRNGKey(4)
    planes = make_planes(rng)
    pos = clustered_positions(jax.random.PRNGKey(5))
    slot_idx = jax.random.randint(jax.random.PRNGKey(6), (B, MP, NP, S),
                                  0, K, jnp.int32)
    valid = jnp.ones((B, MP, NP, M_MEM, S), bool)

    def loss(pl):
        t = pack_tilewin(pl, F, K)
        f, w = sample_tilewin(t, pos, slot_idx, valid)
        return (f.astype(jnp.float32) ** 2).sum() + (w ** 2).sum()

    g = jax.grad(loss)(planes)
    assert np.isfinite(np.asarray(g)).all()
    assert float(jnp.abs(g).sum()) > 0


def test_select_patch_slots_covers_valid_bones():
    rng = jax.random.PRNGKey(7)
    n = NP * M_MEM * S
    canonical = jax.random.uniform(rng, (B, K, 3, n), minval=-1.5,
                                   maxval=1.5)
    validity = (jnp.abs(canonical) < 1).all(axis=2)
    slot_idx, cand_pos, cand_valid = select_patch_slots(
        canonical, validity, NP, M_MEM, S, K)  # Mp=K: capacity can't leak
    # with full capacity, every per-point valid bone appears in some slot
    total_valid = int(validity.sum())
    assert int(cand_valid.sum()) == total_valid
    # slot positions match the selected bone's canonical position
    ci = np.asarray(slot_idx)     # (B, K, NP, S)
    cp = np.asarray(cand_pos)     # (B, 3, K, NP, M_MEM, S)
    can = np.asarray(canonical).reshape(B, K, 3, NP, M_MEM, S)
    for b in range(B):
        for g in range(K):
            for p_ in range(NP):
                for s_ in range(S):
                    k = ci[b, g, p_, s_]
                    np.testing.assert_allclose(
                        cp[b, :, g, p_, :, s_], can[b, k, :, p_, :, s_],
                        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n_patch,s,m", [
    (NP, S, M_MEM),   # 2x2 patches
    (16, 5, 16),      # 4x4 patches, 80 windows per slot: many groups
])
def test_sample_tilewin_matches_oracle_fwd_and_vjp(n_patch, s, m):
    """The XLA combine vs the f32 grid-sample oracle (ops/triplane.py +
    ops/grid_sample.py) on the same candidates, forward and gradient with
    respect to the planes. bf16 tables keep ~3 significant digits."""
    from enarf_gan_tpu.ops.triplane import (
        sample_part_prob_candidates, sample_weighted_feature_candidates)
    planes = make_planes(jax.random.PRNGKey(9))
    k1, k2 = jax.random.split(jax.random.PRNGKey(10))
    centers = jax.random.uniform(k1, (B, 3, MP, n_patch, 1, s),
                                 minval=-0.85, maxval=0.85)
    jitter = jax.random.uniform(k2, (B, 3, MP, n_patch, m, s),
                                minval=-1.5 / TS, maxval=1.5 / TS)
    pos = jnp.clip(centers + jitter, -0.99, 0.99)
    slot_idx = jax.random.randint(jax.random.PRNGKey(11), (B, MP, n_patch, s),
                                  0, K, jnp.int32)
    valid = jax.random.uniform(jax.random.PRNGKey(12),
                               (B, MP, n_patch, m, s)) > 0.2
    n = n_patch * m * s
    c_pos = pos.transpose(0, 3, 4, 5, 2, 1).reshape(B, n, MP, 3)
    c_idx = jnp.broadcast_to(slot_idx.transpose(0, 2, 3, 1)[:, :, None],
                             (B, n_patch, m, s, MP)).reshape(B, n, MP)
    c_valid = valid.transpose(0, 2, 3, 4, 1).reshape(B, n, MP)
    cot_f = jax.random.normal(jax.random.PRNGKey(13), (B, F, n))
    cot_w = jax.random.normal(jax.random.PRNGKey(14), (B, n, MP))

    def tile(pl):
        f, w, stats = sample_tilewin(pack_tilewin(pl, F, K), pos, slot_idx,
                                     valid, with_stats=True)
        return f, w.transpose(0, 2, 3, 4, 1).reshape(B, n, MP), stats

    def oracle(pl):
        w = sample_part_prob_candidates(pl[:, F * 3:], c_idx, c_pos)
        f = sample_weighted_feature_candidates(F, pl[:, :F * 3], c_pos, w,
                                               c_valid)
        return f, w

    def loss(f, w):
        return (f * cot_f).sum() + (w * c_valid * cot_w).sum()

    f_t, w_t, stats = tile(planes)
    f_o, w_o = oracle(planes)
    assert float(stats["clamped"]) == 0.0
    vmask = np.asarray(c_valid)
    np.testing.assert_allclose(np.asarray(f_t), np.asarray(f_o),
                               rtol=3e-2, atol=3e-2)
    np.testing.assert_allclose(np.asarray(w_t)[vmask], np.asarray(w_o)[vmask],
                               rtol=3e-2, atol=3e-2)

    g_t = jax.grad(lambda pl: loss(*tile(pl)[:2]))(planes)
    g_o = jax.grad(lambda pl: loss(*oracle(pl)))(planes)
    scale = float(jnp.abs(g_o).max())
    assert scale > 0
    assert float(jnp.abs(g_t - g_o).max()) <= 3e-2 * scale


@pytest.mark.parametrize("ts", [16, 32])
def test_pack_tilewin_window_contents(ts):
    """Window rows hold the padded-plane texels the design says they do."""
    rng = jax.random.PRNGKey(8)
    planes = jax.random.normal(rng, (1, (F + K) * 3, ts, ts), jnp.float32)
    t = pack_tilewin(planes, F, K)
    feat = np.asarray(planes[0, :F * 3].reshape(3, F, ts, ts))
    pad = np.zeros((3, F, ts + 4, ts + 4), np.float32)
    pad[:, :, 1:ts + 1, 1:ts + 1] = feat
    rows = np.asarray(t.feat.astype(jnp.float32))
    nb = t.nb
    for p in (0, 2):
        for bi in (0, 1, nb - 1):
            for bj in (0, nb - 2):
                row = rows[(p * nb + bi) * nb + bj].reshape(-1)[:64 * F]
                win = row.reshape(8, 8, F)
                for dt in (0, 3, 7):
                    for ds in (1, 6):
                        expect = pad[p, :, 2 * bi + dt, 2 * bj + ds]
                        np.testing.assert_allclose(win[dt, ds], expect,
                                                   rtol=2e-2, atol=2e-2)
