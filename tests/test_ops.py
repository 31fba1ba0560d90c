import numpy as np
import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from enarf_gan_tpu.ops.grid_sample import grid_sample_2d
from enarf_gan_tpu.ops.activation import density_relu, straight_through_clamp
from enarf_gan_tpu.ops.triplane import (
    sample_feature, sample_triplane_part_prob, sample_weighted_feature)
from enarf_gan_tpu.ops.upfirdn import upfirdn2d, make_blur_kernel, upsample2x, downsample2x


def test_grid_sample_matches_torch(rng):
    B, C, H, W, n = 2, 5, 16, 16, 64
    img = rng.randn(B, C, H, W).astype(np.float32)
    # include in-range, edge, and out-of-range coordinates
    grid = rng.uniform(-1.3, 1.3, (B, n, 2)).astype(np.float32)
    grid[0, 0] = [1.0, 1.0]
    grid[0, 1] = [-1.0, -1.0]
    grid[0, 2] = [2.0, 2.0]

    ours = np.array(grid_sample_2d(jnp.array(img), jnp.array(grid)))
    ref = F.grid_sample(torch.tensor(img), torch.tensor(grid)[:, :, None, :],
                        mode="bilinear", padding_mode="zeros",
                        align_corners=False)[:, :, :, 0]
    np.testing.assert_allclose(ours, ref.numpy(), rtol=1e-4, atol=1e-5)


def torch_sample_feature(feats, position, reduction="sum", clamp_mask=False):
    # verbatim reference generic path (libraries/triplane/sampling.py:28-51)
    B, _, h, w = feats.shape
    n = position.shape[-1]
    features = feats.reshape(B * 3, -1, h, w)
    p2 = position[:, [0, 1, 1, 2, 2, 0]].reshape(B * 3, 2, n)
    p2 = p2.permute(0, 2, 1)[:, :, None]
    f = F.grid_sample(features, p2, align_corners=False)
    f = f.reshape(B, 3, -1, n)
    if reduction == "sum":
        return f.sum(dim=1)
    if clamp_mask:
        f = (f.data.clamp(-2, 5) - f.data) + f
    return torch.sigmoid(f).prod(dim=1)


def test_sample_feature_matches_reference(rng):
    B, Fdim, H, n = 2, 4, 32, 50
    feats = rng.randn(B, Fdim * 3, H, H).astype(np.float32)
    pos = rng.uniform(-1.1, 1.1, (B, 3, n)).astype(np.float32)
    for reduction in ["sum", "prod"]:
        ours = np.array(sample_feature(jnp.array(feats), jnp.array(pos), reduction))
        ref = torch_sample_feature(torch.tensor(feats), torch.tensor(pos), reduction)
        np.testing.assert_allclose(ours, ref.numpy(), rtol=1e-4, atol=1e-5)


def test_part_prob_modes(rng):
    bs, n_bone, H, n = 2, 3, 16, 20
    planes = rng.randn(bs * n_bone, 3, H, H).astype(np.float32)
    pos = rng.uniform(-1, 1, (bs, n_bone, 3, n)).astype(np.float32)
    validity = rng.rand(bs, n_bone, n) > 0.3

    w_prod = np.array(sample_triplane_part_prob(jnp.array(planes), jnp.array(pos),
                                                jnp.array(validity), mode="prod"))
    assert w_prod.shape == (bs, n_bone, n)
    assert (w_prod >= 0).all() and (w_prod <= 1).all()

    w_sum = np.array(sample_triplane_part_prob(jnp.array(planes), jnp.array(pos),
                                               jnp.array(validity), mode="sum"))
    np.testing.assert_allclose(w_sum.sum(axis=1), 1.0, rtol=1e-4)
    # invalid positions get (numerically) zero weight unless all bones invalid
    some_valid = validity.any(axis=1)
    assert (w_sum[~validity & some_valid[:, None]] < 1e-3).all()

    w_none = np.array(sample_triplane_part_prob(jnp.array(planes), jnp.array(pos),
                                                jnp.array(validity), mode="uniform"))
    np.testing.assert_allclose(w_none, 1 / n_bone)


def torch_weighted_feature(feat_dim, feats, position, weight, validity):
    # verbatim reference sparse path (libraries/triplane/sampling.py:79-127)
    batchsize, n_bone, n = validity.shape
    _, ch, tri_size, _ = feats.shape
    fp = F.pad(feats, (0, 1)).permute(1, 2, 0, 3).reshape(1, ch, tri_size,
                                                          (tri_size + 1) * batchsize)
    validity_flat = validity.reshape(-1)
    valid_args = torch.where(validity_flat)[0]
    pos_perm = position.permute(2, 0, 1, 3).reshape(3, batchsize * n_bone * n)
    vp = torch.gather(pos_perm, 1, valid_args[None].expand(3, -1))[None]
    batch_idx = torch.div(valid_args, n_bone * n, rounding_mode="trunc")
    # sample from packed plane
    b1, _, h, w = fp.shape
    features = fp.reshape(3, -1, h, w)
    p2 = vp[:, [0, 1, 1, 2, 2, 0]].reshape(3, 2, -1)
    actual_bs = w // (h + 1)
    scale = 1 / (actual_bs * (1 + 1 / h))
    p2 = p2.permute(0, 2, 1)[:, :, None].clone()
    p2[:, :, :, 0] = (p2[:, :, :, 0] * scale + batch_idx[None, :, None] * (2 / actual_bs)
                      + (scale - 1))
    value = F.grid_sample(features, p2, align_corners=False)
    value = value.reshape(1, 3, -1, vp.shape[-1]).sum(dim=1)
    w_g = torch.gather(weight.reshape(-1), 0, valid_args)
    value = value * w_g[None, None]
    out = torch.zeros(feat_dim, batchsize * n)
    scatter_idx = batch_idx * n + valid_args % n
    out.scatter_add_(1, scatter_idx[None].expand(feat_dim, -1), value.squeeze(0))
    return out.reshape(feat_dim, batchsize, n).permute(1, 0, 2)


def test_weighted_feature_matches_reference_sparse_path(rng):
    bs, n_bone, Fdim, H, n = 2, 4, 8, 16, 30
    feats = rng.randn(bs, Fdim * 3, H, H).astype(np.float32)
    pos = rng.uniform(-0.95, 0.95, (bs, n_bone, 3, n)).astype(np.float32)
    validity = rng.rand(bs, n_bone, n) > 0.4
    masked_pos = np.where(validity[:, :, None], pos, 2.0).astype(np.float32)
    weight = rng.rand(bs, n_bone, n).astype(np.float32)

    ours = np.array(sample_weighted_feature(
        Fdim, jnp.array(feats), jnp.array(masked_pos), jnp.array(weight),
        jnp.array(validity)))
    ref = torch_weighted_feature(Fdim, torch.tensor(feats), torch.tensor(masked_pos),
                                 torch.tensor(weight), torch.tensor(validity))
    np.testing.assert_allclose(ours, ref.numpy(), rtol=1e-3, atol=1e-4)


def test_density_relu_vjp():
    x = jnp.array([-1.0, -0.5, 0.5, 2.0])
    y, vjp = jax.vjp(density_relu, x)
    np.testing.assert_allclose(np.array(y), [0, 0, 0.5, 2.0])
    # upstream grad negative (wants larger input): leak through negatives
    g_neg = vjp(jnp.array([-1.0, -1.0, -1.0, -1.0]))[0]
    np.testing.assert_allclose(np.array(g_neg), [-0.1, -0.1, -1.0, -1.0], rtol=1e-6)
    # upstream grad positive: no leak
    g_pos = vjp(jnp.array([1.0, 1.0, 1.0, 1.0]))[0]
    np.testing.assert_allclose(np.array(g_pos), [0.0, 0.0, 1.0, 1.0], rtol=1e-6)


def test_straight_through_clamp():
    x = jnp.array([-5.0, 0.0, 7.0])
    y, vjp = jax.vjp(straight_through_clamp, x)
    np.testing.assert_allclose(np.array(y), [-2.0, 0.0, 5.0])
    np.testing.assert_allclose(np.array(vjp(jnp.ones(3))[0]), 1.0)


def test_upfirdn_blur_identity_dc(rng):
    # a constant image stays constant in the interior under a normalized blur
    x = np.ones((1, 2, 16, 16), np.float32)
    k = make_blur_kernel()
    out = np.array(upfirdn2d(jnp.array(x), k, pad=(2, 1)))
    np.testing.assert_allclose(out[0, 0, 4:-4, 4:-4], 1.0, rtol=1e-5)


def test_up_down_shapes(rng):
    x = jnp.array(rng.randn(2, 3, 8, 8).astype(np.float32))
    up = upsample2x(x)
    assert up.shape == (2, 3, 16, 16)
    down = downsample2x(up)
    assert down.shape == (2, 3, 8, 8)
    # energy preserved approximately for smooth signal
    const = jnp.ones((1, 1, 8, 8))
    up_c = np.array(upsample2x(const))
    np.testing.assert_allclose(up_c[0, 0, 4:-4, 4:-4], 1.0, rtol=1e-4)


def test_topm_matches_dense_when_few_bones_valid(rng):
    from enarf_gan_tpu.ops.triplane import sample_weighted_feature_topm
    bs, n_bone, Fdim, H, n = 2, 6, 8, 16, 40
    feats = rng.randn(bs, Fdim * 3, H, H).astype(np.float32)
    pos = rng.uniform(-0.95, 0.95, (bs, n_bone, 3, n)).astype(np.float32)
    # at most 3 bones valid per point
    validity = np.zeros((bs, n_bone, n), bool)
    for b in range(bs):
        for i in range(n):
            for k in rng.choice(n_bone, rng.randint(0, 4), replace=False):
                validity[b, k, i] = True
    masked_pos = np.where(validity[:, :, None], pos, 2.0).astype(np.float32)
    weight = rng.rand(bs, n_bone, n).astype(np.float32)

    dense = np.array(sample_weighted_feature(
        Fdim, jnp.array(feats), jnp.array(masked_pos), jnp.array(weight),
        jnp.array(validity)))
    topm = np.array(sample_weighted_feature_topm(
        Fdim, jnp.array(feats), jnp.array(masked_pos), jnp.array(weight),
        jnp.array(validity), max_bones=3))
    np.testing.assert_allclose(topm, dense, rtol=1e-4, atol=1e-5)


def test_candidate_path_matches_dense(rng):
    """Validity-first candidate selection == dense weight+feature pipeline
    when ≤M bones are valid per point."""
    from enarf_gan_tpu.ops.triplane import (
        select_candidate_bones, sample_part_prob_candidates,
        sample_weighted_feature_candidates)
    bs, n_bone, Fdim, H, n, M = 2, 6, 8, 16, 40, 3
    feat_planes = rng.randn(bs, Fdim * 3, H, H).astype(np.float32)
    mask_planes = rng.randn(bs, n_bone * 3, H, H).astype(np.float32)
    pos = rng.uniform(-0.9, 0.9, (bs, n_bone, 3, n)).astype(np.float32)
    validity = np.zeros((bs, n_bone, n), bool)
    for b in range(bs):
        for i in range(n):
            for k in rng.choice(n_bone, rng.randint(0, M + 1), replace=False):
                validity[b, k, i] = True

    # dense reference pipeline
    masked_pos = np.where(validity[:, :, None], pos, 2.0).astype(np.float32)
    w_dense = np.array(sample_triplane_part_prob(
        jnp.array(mask_planes.reshape(bs * n_bone, 3, H, H)),
        jnp.array(masked_pos), jnp.array(validity), mode="prod"))
    f_dense = np.array(sample_weighted_feature(
        Fdim, jnp.array(feat_planes), jnp.array(masked_pos),
        jnp.array(w_dense), jnp.array(validity)))

    cand_idx, cand_valid, cand_pos = select_candidate_bones(
        jnp.array(pos), jnp.array(validity), M)
    cand_w = sample_part_prob_candidates(jnp.array(mask_planes), cand_idx,
                                         cand_pos)
    f_cand = np.array(sample_weighted_feature_candidates(
        Fdim, jnp.array(feat_planes), cand_pos, cand_w, cand_valid))
    np.testing.assert_allclose(f_cand, f_dense, rtol=1e-3, atol=1e-4)
