"""Volume rendering runtime — frustum clipping, coarse→fine sampling, compositing.

Re-design of the reference render stack
(reference: libraries/NeRF/rendering.py:10-427):

* static shapes throughout — the reference's batchsize==1 invalid-ray
  compaction (rendering.py:107-110,337-350) becomes a validity mask that
  zeroes outputs; identical results, jit/pjit friendly;
* importance resampling via inverse-CDF sampling (a dense compare-sum —
  identical indices to searchsorted) with independent
  in-bin jitter — the same piecewise-constant distribution
  ``torch.multinomial`` + uniform/Nc realizes (rendering.py:192-194), without
  the sequential multinomial kernel;
* full-image rendering scans over fixed-size ray chunks inside one jit
  (the reference's python chunk loop, rendering.py:408-419).

The model plugs in as a pure closure
``density_color_fn(points (B,3,m), ray_dir (B,3,n)|None, pose_scaled) ->
(density (B,1,m), color (B,3,m)|None)`` where ``pose_scaled`` is the bone
pose with translations scaled by coordinate_scale — what
`calc_density_and_color_from_camera_coord_v2` is to the reference
(NeRF/base.py:69-79), minus the mutable buffers.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

SQRT3 = 3.0 ** 0.5
N_DEPTH_PROBE = 32  # reference rendering.py:18
DensityColorFn = Callable[[jnp.ndarray, Optional[jnp.ndarray], jnp.ndarray],
                          Tuple[jnp.ndarray, Optional[jnp.ndarray]]]


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    Nc: int = 48
    Nf: int = 64
    near_plane: float = 0.3
    far_plane: float = 5.0
    render_scale: float = 1.0
    coordinate_scale: float = 1.0
    view_dependent: bool = False
    # tiled path only: evaluate the coarse pass on the P*P patch's 4 corner
    # rays instead of all members (the pooled-bin estimator already pools
    # coarse weights patch-wide; corners bound the same windows) — ~4x less
    # coarse transform/combine/head work (nerf/tiled.py)
    tile_coarse_corners: bool = False


def decide_frustum_range(image_coord: jnp.ndarray, pose_to_camera: jnp.ndarray,
                         inv_intrinsics: jnp.ndarray, near_plane: float,
                         far_plane: float):
    """Per-ray [near, far] from intersections with per-bone [-1,1]^3 cubes.

    Matches reference rendering.py:10-79 (return_camera_coord=True path).

    Args:
        image_coord: (B, 1, 3, n) homogeneous pixel coords.
        pose_to_camera: (B, n_bone, 4, 4).
        inv_intrinsics: (3, 3) or (B, 3, 3).
    Returns:
        depth_min, depth_max: (B, 1, 1, n); ray_direction: (B, 3, n);
        validity: (B, 1, 1, n) bool.
    """
    B, _, _, n = image_coord.shape
    joints_z = pose_to_camera[:, :, 2, 3]
    near = jnp.maximum(joints_z.min() - SQRT3, near_plane)
    far = jnp.maximum(joints_z.max() + SQRT3, far_plane)

    R = pose_to_camera[:, :, :3, :3]
    t = pose_to_camera[:, :, :3, 3:]
    coords = image_coord.reshape(B, 3, n)
    if inv_intrinsics.ndim == 2:
        ray_direction = jnp.einsum("ij,bjn->bin", inv_intrinsics, coords)
    else:
        ray_direction = jnp.einsum("bij,bjn->bin", inv_intrinsics, coords)

    depths = jnp.linspace(near, far, N_DEPTH_PROBE)  # (S,)
    pts = ray_direction[:, None, :, :, None] * depths  # (B, 1, 3, n, S)
    pts = pts - t[:, :, :, :, None]                    # (B, K, 3, n, S)
    local = jnp.einsum("bkij,bkjns->bkins", jnp.swapaxes(R, -1, -2), pts,
                       precision=lax.Precision.HIGHEST)  # (B, K, 3, n, S)
    inside = (jnp.abs(local) <= 1).all(axis=2)  # (B, K, n, S)

    large = 1e3
    dmin = jnp.where(inside, depths, large).min(axis=3)   # (B, K, n)
    dmax = jnp.where(inside, depths, -large).max(axis=3)
    dmin = dmin.min(axis=1)[:, None, None, :]  # (B, 1, 1, n)
    dmax = dmax.max(axis=1)[:, None, None, :]

    validity = dmin != large
    # invalid rays fall back to the ORIGINAL config planes, not the
    # joint-adjusted ones (reference rendering.py:66-67)
    dmin = jnp.where(validity, dmin, near_plane)
    dmax = jnp.where(dmax != -large, dmax, far_plane)
    dmin = jnp.maximum(dmin, near_plane)
    return (lax.stop_gradient(dmin), lax.stop_gradient(dmax),
            lax.stop_gradient(ray_direction), validity)


def coarse_sample(image_coord: jnp.ndarray, pose_to_camera: jnp.ndarray,
                  inv_intrinsics: jnp.ndarray, near_plane: float = 0.3,
                  far_plane: float = 5.0, Nc: int = 64,
                  camera_pose: Optional[jnp.ndarray] = None,
                  view_dependent: bool = False, frustum=None):
    """Uniform bin midpoints per ray (reference rendering.py:82-135, no compaction).

    ``frustum`` optionally carries a precomputed
    (dmin, dmax, ray_direction, validity) — the full-image path probes all
    rays once per frame instead of once per chunk.

    Returns (coarse_depth (B,1,n,Nc+1), ray_dir_world (B,3,n)|None,
    coarse_points (B,3,n*Nc), validity (B,1,1,n), depth_min/max (B,1,n),
    start/end (B,3,n)).
    """
    B = image_coord.shape[0]
    if frustum is None:
        dmin, dmax, ray_direction, validity = decide_frustum_range(
            image_coord, pose_to_camera, inv_intrinsics, near_plane, far_plane)
    else:
        dmin, dmax, ray_direction, validity = frustum
    if view_dependent:
        assert camera_pose is not None
        rd = ray_direction / jnp.linalg.norm(ray_direction, axis=1, keepdims=True)
        rot = camera_pose[:, :3, :3] if camera_pose.shape[-1] == 4 else camera_pose
        ray_dir_world = jnp.einsum("bij,bjn->bin", jnp.swapaxes(rot, -1, -2), rd)
    else:
        ray_dir_world = None

    dmin2 = dmin[:, 0]  # (B, 1, n)
    dmax2 = dmax[:, 0]
    start = dmin2 * ray_direction  # (B, 3, n)
    end = dmax2 * ray_direction
    bins = jnp.linspace(0.0, 1.0, Nc + 1).reshape(1, 1, 1, Nc + 1)
    coarse_depth = dmin2[..., None] * (1 - bins) + dmax2[..., None] * bins  # (B,1,n,Nc+1)
    pts = start[..., None] * (1 - bins) + end[..., None] * bins  # (B,3,n,Nc+1)
    pts = (pts[..., 1:] + pts[..., :-1]) / 2
    coarse_points = pts.reshape(B, 3, -1)
    return (coarse_depth, ray_dir_world, coarse_points, validity,
            dmin2, dmax2, start, end)


def _smooth_pad_weights(weights: jnp.ndarray) -> jnp.ndarray:
    """max-of-neighbors smoothing + 0.01 floor (reference rendering.py:188-190)."""
    w = jnp.pad(weights, ((0, 0), (1, 1)))
    return (jnp.maximum(w[:, :-2], w[:, 1:-1]) +
            jnp.maximum(w[:, 1:-1], w[:, 2:])) / 2 + 0.01


def fine_sample_depths(rng: jax.Array, weights: jnp.ndarray, Nf: int,
                       Nc: int) -> jnp.ndarray:
    """Importance-sample Nf bin positions in [0, 1] from per-bin weights.

    Same distribution as reference rendering.py:192-197
    (multinomial bin + U(0,1)/Nc jitter, then sort): inverse-CDF bin pick via
    ``searchsorted`` with an independent uniform, plus in-bin jitter.

    Args:
        weights: (R, Nc) non-negative (already smoothed+floored).
    Returns:
        (R, Nf) sorted positions in [0, 1].
    """
    R = weights.shape[0]
    cdf = jnp.cumsum(weights, axis=1)
    cdf = cdf / cdf[:, -1:]
    k_bin, k_jit = jax.random.split(rng)
    u = jax.random.uniform(k_bin, (R, Nf), weights.dtype)
    # inverse-CDF bin index == searchsorted(cdf, u), computed as a dense
    # compare-sum: Nc is tiny, so the vectorized compare replaces a
    # vmapped binary search (identical indices)
    idx = (cdf[:, None, :] < u[:, :, None]).sum(axis=2)   # (R, Nf)
    jitter = jax.random.uniform(k_jit, (R, Nf), weights.dtype)
    bins = (idx.astype(weights.dtype) + jitter) / Nc
    return jnp.sort(bins, axis=1)


def coarse_to_fine_sample(rng: jax.Array, density_fn: DensityColorFn,
                          image_coord: jnp.ndarray, pose_to_camera: jnp.ndarray,
                          inv_intrinsics: jnp.ndarray, cfg: RenderConfig,
                          camera_pose: Optional[jnp.ndarray] = None,
                          frustum=None):
    """Coarse pass → transmittance weights → fine depths/points
    (reference rendering.py:138-224)."""
    B, _, _, n = image_coord.shape
    Nc, Nf = cfg.Nc, cfg.Nf
    (coarse_depth, ray_dir_world, coarse_points, validity,
     dmin, dmax, start, end) = coarse_sample(
        image_coord, pose_to_camera, inv_intrinsics, cfg.near_plane,
        cfg.far_plane, Nc, camera_pose, cfg.view_dependent, frustum=frustum)

    coarse_density, _ = density_fn(lax.stop_gradient(coarse_points), None,
                               pose_to_camera)
    coarse_density = lax.stop_gradient(coarse_density)

    Np = coarse_depth.shape[-1]  # Nc + 1
    density = coarse_density.reshape(B, 1, n, Nc)[..., :Np - 1]
    delta = coarse_depth[..., 1:] - coarse_depth[..., :-1]  # (B,1,n,Nc)
    dd = density * delta * cfg.render_scale
    T_i = jnp.exp(-(jnp.cumsum(dd, axis=3) - dd))
    weights = (T_i * (1 - jnp.exp(-dd))).reshape(B * n, Np - 1)
    weights = _smooth_pad_weights(weights)

    bins = fine_sample_depths(rng, weights, Nf, Nc).reshape(B, 1, n, Nf)
    fine_depth = dmin[..., None] * (1 - bins) + dmax[..., None] * bins  # (B,1,n,Nf)
    fine_points = (start[:, :, :, None] * (1 - bins) +
                   end[:, :, :, None] * bins)  # (B,3,n,Nf)
    fine_points = fine_points.reshape(B, 3, n * Nf)
    return fine_depth, fine_points, ray_dir_world, validity


def render_rays(rng: jax.Array, density_color_fn: DensityColorFn,
                image_coord: jnp.ndarray, pose_to_camera: jnp.ndarray,
                inv_intrinsics: jnp.ndarray, cfg: RenderConfig,
                camera_pose: Optional[jnp.ndarray] = None,
                frustum=None, pose_prescaled: bool = False,
                ray_chunk: Optional[int] = None):
    """Render sampled rays → (color (B,3,n), mask (B,n), disparity (B,n), aux).

    Matches reference render() (rendering.py:227-359); ``aux`` carries what
    ``model.buffers_tensors`` carried (fine_weights, fine_depth) as explicit
    outputs. ``frustum``/``pose_prescaled`` let the full-image path hoist the
    per-frame probe and pose scaling out of the chunk scan.

    ``ray_chunk`` scans fixed-size ray chunks inside the graph — rays are
    independent, so results are identical, but the DIFFERENTIABLE peak
    memory scales with the chunk, not the full ray count (the backward pass
    of the scan replays one chunk at a time). This is how full-image GAN
    training fits a 16 GB chip: one 128² image's single-pass VJP needs
    ~12 GB of gather cotangents; 4096-ray chunks need a quarter of that.
    """
    B, _, _, n = image_coord.shape
    if ray_chunk is not None and n > ray_chunk:
        assert frustum is None, "precomputed frustum + ray_chunk unsupported"
        assert n % ray_chunk == 0, (n, ray_chunk)
        n_chunks = n // ray_chunk
        coords = image_coord.reshape(B, 1, 3, n_chunks, ray_chunk) \
            .transpose(3, 0, 1, 2, 4)
        keys = jax.random.split(rng, n_chunks)

        def body(carry, inp):
            key, coord = inp
            return carry, render_rays(key, density_color_fn, coord,
                                      pose_to_camera, inv_intrinsics, cfg,
                                      camera_pose,
                                      pose_prescaled=pose_prescaled)

        _, (color, mask, disp, aux) = lax.scan(body, None, (keys, coords))
        # chunks stack on axis 0 in ray-major order → fold back into n
        color = color.transpose(1, 2, 0, 3).reshape(B, 3, n)
        mask = mask.transpose(1, 0, 2).reshape(B, n)
        disp = disp.transpose(1, 0, 2).reshape(B, n)

        def merge(name, x):
            if name == "fine_points":        # (C, B, 3, chunk*Nf) ray-major
                return x.transpose(1, 2, 0, 3).reshape(B, 3, -1)
            # (C, B, 1, chunk, S) → (B, 1, n, S)
            return x.transpose(1, 2, 0, 3, 4).reshape(
                B, x.shape[2], n, x.shape[4])

        aux = {k: merge(k, v) for k, v in aux.items()}
        return color, mask, disp, aux
    if cfg.coordinate_scale != 1 and not pose_prescaled:
        pose_to_camera = pose_to_camera.at[:, :, :3, 3].multiply(cfg.coordinate_scale)

    fine_depth, fine_points, ray_dir_world, validity = coarse_to_fine_sample(
        rng, density_color_fn, image_coord, pose_to_camera, inv_intrinsics,
        cfg, camera_pose, frustum=frustum)

    fine_density, fine_color = density_color_fn(fine_points, ray_dir_world,
                                                 pose_to_camera)

    Np = fine_depth.shape[-1]  # Nf
    fine_color = fine_color.reshape(B, 3, n, Np)[..., :Np - 1]
    fine_density = fine_density.reshape(B, 1, n, Np)[..., :Np - 1]

    delta = fine_depth[..., 1:] - fine_depth[..., :-1]  # (B,1,n,Np-1)
    dd = fine_density * delta * cfg.render_scale
    T_i = jnp.exp(-(jnp.cumsum(dd, axis=3) - dd))
    weights = T_i * (1 - jnp.exp(-dd))  # (B,1,n,Np-1)

    depth_mid = fine_depth[..., :-1]
    color = jnp.sum(weights * fine_color, axis=3)       # (B,3,n)
    mask = jnp.sum(weights, axis=3).reshape(B, n)
    disparity = jnp.sum(weights / depth_mid, axis=3).reshape(B, n)

    valid = validity.reshape(B, 1, n)
    color = jnp.where(valid, color, 0.0)
    mask = jnp.where(valid[:, 0], mask, 0.0)
    disparity = jnp.where(valid[:, 0], disparity, 0.0)

    aux = {"fine_weights": weights, "fine_depth": fine_depth,
           "fine_density": fine_density, "fine_points": fine_points}
    return color, mask, disparity, aux


def render_entire_img(rng: jax.Array, density_color_fn: DensityColorFn,
                      pose_to_camera: jnp.ndarray, inv_intrinsics: jnp.ndarray,
                      cfg: RenderConfig, render_size: int,
                      ray_batchsize: int = 16384,
                      camera_pose: Optional[jnp.ndarray] = None,
                      use_normalized_intrinsics: bool = False,
                      bbox: Optional[Tuple[int, int, int, int]] = None):
    """Full-image render by scanning fixed-size ray chunks inside jit.

    Matches reference rendering.py:362-427 (batch size 1). ``bbox`` crops the
    pixel grid (host-static) like the validation crop path.
    Returns (color (3,H,W), mask (H,W), disparity (H,W)).
    """
    if bbox is not None:
        x0, y0, x1, y1 = bbox
        width, height = x1 - x0, y1 - y0
    else:
        x0 = y0 = 0
        width = height = render_size
    npix = width * height
    idx = np.arange(npix)
    xs = (idx % width + 0.5 + x0).astype(np.float32)
    ys = (idx // width + 0.5 + y0).astype(np.float32)
    if use_normalized_intrinsics:
        xs, ys = xs / render_size, ys / render_size
    coords = jnp.asarray(np.stack([xs, ys, np.ones_like(xs)], axis=0))  # (3, npix)

    chunk = min(ray_batchsize, npix)
    n_chunks = -(-npix // chunk)
    pad = n_chunks * chunk - npix
    p2c = pose_to_camera[:1]
    if cfg.coordinate_scale != 1:
        p2c = p2c.at[:, :, :3, 3].multiply(cfg.coordinate_scale)

    # Frame-level frustum probe, once (the per-chunk probe repeated identical
    # work; reference probes per render() call, rendering.py:10-79).
    dmin, dmax, ray_dir, validity = decide_frustum_range(
        coords.reshape(1, 1, 3, npix), p2c, inv_intrinsics, cfg.near_plane,
        cfg.far_plane)
    valid1 = validity.reshape(npix)

    # Ray compaction: process valid rays first and skip all-invalid chunks —
    # the static-shape analog of the reference's batchsize==1 invalid-ray
    # compaction (rendering.py:107-110,337-350). Exact: invalid rays output
    # zeros either way; only their (zero) chunks are skipped.
    order = jnp.argsort(jnp.logical_not(valid1), stable=True)  # valid first
    inv_order = jnp.argsort(order)

    def permute(x, axis):
        return jnp.take(x, order, axis=axis)

    coords_s = permute(coords, 1)
    frustum_s = (permute(dmin, 3), permute(dmax, 3), permute(ray_dir, 2),
                 permute(validity, 3))

    def pad_chunks(x, axis):
        cfgpad = [(0, 0)] * x.ndim
        cfgpad[axis] = (0, pad)
        return jnp.pad(x, cfgpad)

    coords_s = pad_chunks(coords_s, 1).reshape(1, 1, 3, n_chunks, chunk) \
        .transpose(3, 0, 1, 2, 4)
    fr_chunks = (
        pad_chunks(frustum_s[0], 3).reshape(1, 1, 1, n_chunks, chunk)
        .transpose(3, 0, 1, 2, 4),
        pad_chunks(frustum_s[1], 3).reshape(1, 1, 1, n_chunks, chunk)
        .transpose(3, 0, 1, 2, 4),
        pad_chunks(frustum_s[2], 2).reshape(1, 3, n_chunks, chunk)
        .transpose(2, 0, 1, 3),
        pad_chunks(frustum_s[3], 3).reshape(1, 1, 1, n_chunks, chunk)
        .transpose(3, 0, 1, 2, 4),
    )
    has_valid = fr_chunks[3].reshape(n_chunks, -1).any(axis=1)

    keys = jax.random.split(rng, n_chunks)

    def body(carry, inp):
        key, coord, fr0, fr1, fr2, fr3, hv = inp

        def do_render(_):
            color, mask, disp, _ = render_rays(
                key, density_color_fn, coord, p2c, inv_intrinsics, cfg,
                camera_pose, frustum=(fr0, fr1, fr2, fr3),
                pose_prescaled=True)
            return color, mask, disp

        def skip(_):
            return (jnp.zeros((1, 3, chunk), jnp.float32),
                    jnp.zeros((1, chunk), jnp.float32),
                    jnp.zeros((1, chunk), jnp.float32))

        return carry, lax.cond(hv, do_render, skip, None)

    _, (color, mask, disp) = lax.scan(
        body, None, (keys, coords_s) + fr_chunks + (has_valid,))
    color = color.transpose(1, 2, 0, 3).reshape(1, 3, -1)[:, :, :npix]
    mask = mask.transpose(1, 0, 2).reshape(1, -1)[:, :npix]
    disp = disp.transpose(1, 0, 2).reshape(1, -1)[:, :npix]
    # undo the validity ordering
    color = jnp.take(color, inv_order, axis=2)
    mask = jnp.take(mask, inv_order, axis=1)
    disp = jnp.take(disp, inv_order, axis=1)
    return (color.reshape(3, height, width),
            mask.reshape(height, width),
            disp.reshape(height, width))
