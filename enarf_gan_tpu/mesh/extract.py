"""Mesh extraction from density fields.

Replaces the reference's PyMCubes path (reference: libraries/NARF/
mesh_rendering.py:50-81): density is evaluated on a voxel grid around the
body center in fixed-size chunks on-device, then iso-surfaced on the host.
The iso-surfacer is marching tetrahedra (6-tet cube split) — table-free,
vectorized numpy, watertight; it replaces the C++ marching-cubes
dependency.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp


def density_grid(density_fn: Callable, center: np.ndarray, voxel_size: float,
                 coordinate_scale: float = 1.0, cube_half: Optional[int] = None,
                 chunk: int = 262144) -> Tuple[np.ndarray, np.ndarray]:
    """Evaluate density on a cubic grid around ``center``.

    Mirrors reference mesh_rendering.py:56-72: bins in [-1, 1] at ``voxel_size``
    resolution, offset by the body center, scaled by coordinate_scale for the
    model. Returns (density (D, D, D), grid world coords origin info).

    Args:
        density_fn: (1, 3, n) scaled camera-frame points → (1, 1, n) density.
        center: (3,) body center (camera frame, unscaled).
        cube_half: half-size in voxels (default 1/voxel_size like the reference).
    """
    if cube_half is None:
        cube_half = int(1 / voxel_size)  # reference: grid spans [-1, 1]
    bins = np.arange(-cube_half, cube_half + 1) * voxel_size  # world offsets
    D = bins.shape[0]
    gx, gy, gz = np.meshgrid(bins, bins, bins, indexing="ij")
    pts = np.stack([gx, gy, gz]).reshape(1, 3, -1).astype(np.float32)
    pts = (pts + center.reshape(1, 3, 1)) * coordinate_scale

    n = pts.shape[-1]
    out = np.empty((n,), np.float32)
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        block = np.zeros((1, 3, chunk), np.float32)
        block[:, :, :e - s] = pts[:, :, s:e]
        d = np.asarray(density_fn(jnp.asarray(block)))
        out[s:e] = d.reshape(-1)[:e - s]
    return out.reshape(D, D, D), bins


# 6-tetrahedra decomposition of the unit cube (corner indices).
# corners: bit i of index = (x, y, z) offsets (x fastest)
_CUBE_CORNERS = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0],
                          [0, 0, 1], [1, 0, 1], [0, 1, 1], [1, 1, 1]])
_TETS = np.array([[0, 5, 1, 3], [0, 5, 3, 7], [0, 3, 2, 7],
                  [0, 2, 6, 7], [0, 6, 4, 7], [0, 4, 5, 7]])


def marching_tetrahedra(volume: np.ndarray, threshold: float,
                        spacing: float = 1.0) -> Tuple[np.ndarray, np.ndarray]:
    """Iso-surface of ``volume`` at ``threshold``.

    Returns (vertices (V, 3) in index coordinates * spacing, faces (F, 3)).
    """
    D0, D1, D2 = volume.shape
    # cube grid
    cx, cy, cz = np.meshgrid(np.arange(D0 - 1), np.arange(D1 - 1),
                             np.arange(D2 - 1), indexing="ij")
    cube_origin = np.stack([cx, cy, cz], axis=-1).reshape(-1, 3)  # (C, 3)

    corner_pos = cube_origin[:, None, :] + _CUBE_CORNERS[None]   # (C, 8, 3)
    corner_val = volume[corner_pos[..., 0], corner_pos[..., 1],
                        corner_pos[..., 2]]                      # (C, 8)

    # drop cubes the surface doesn't cross
    inside = corner_val > threshold
    active = inside.any(axis=1) & (~inside).any(axis=1)
    corner_pos = corner_pos[active]
    corner_val = corner_val[active]
    if corner_pos.shape[0] == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)

    tri_list = []
    for tet in _TETS:
        p = corner_pos[:, tet]          # (C, 4, 3)
        v = corner_val[:, tet]          # (C, 4)
        ins = v > threshold             # (C, 4)
        n_in = ins.sum(axis=1)

        def interp(pa, pb, va, vb):
            t = (threshold - va) / (vb - va + 1e-12)
            return pa + t[:, None] * (pb - pa)

        # one corner inside → one triangle; three inside → one triangle
        # (flipped); two inside → quad (two triangles)
        for target, flip in ((1, False), (3, True)):
            sel = n_in == target
            if not sel.any():
                continue
            want = ins[sel] if target == 1 else ~ins[sel]
            apex = np.argmax(want, axis=1)
            others = np.array([[j for j in range(4) if j != a] for a in apex])
            rows = np.arange(sel.sum())
            pa = p[sel][rows, apex].astype(np.float64)
            va = v[sel][rows, apex]
            tri = [interp(pa, p[sel][rows, others[:, k]].astype(np.float64),
                          va, v[sel][rows, others[:, k]]) for k in range(3)]
            tri = np.stack(tri, axis=1)  # (m, 3, 3)
            if flip:
                tri = tri[:, ::-1]
            tri_list.append(tri)

        sel = n_in == 2
        if sel.any():
            ins_sel = ins[sel]
            # indices of the 2 inside and 2 outside corners
            order = np.argsort(~ins_sel, axis=1)  # inside first
            rows = np.arange(sel.sum())[:, None]
            i0, i1 = order[:, 0], order[:, 1]
            o0, o1 = order[:, 2], order[:, 3]
            ps, vs = p[sel].astype(np.float64), v[sel]
            r = np.arange(sel.sum())
            e00 = interp(ps[r, i0], ps[r, o0], vs[r, i0], vs[r, o0])
            e01 = interp(ps[r, i0], ps[r, o1], vs[r, i0], vs[r, o1])
            e10 = interp(ps[r, i1], ps[r, o0], vs[r, i1], vs[r, o0])
            e11 = interp(ps[r, i1], ps[r, o1], vs[r, i1], vs[r, o1])
            tri_list.append(np.stack([e00, e10, e01], axis=1))
            tri_list.append(np.stack([e01, e10, e11], axis=1))

    tris = np.concatenate(tri_list, axis=0)  # (T, 3, 3)
    # weld vertices
    verts_flat = tris.reshape(-1, 3)
    keys = np.round(verts_flat * 1e5).astype(np.int64)
    uniq, idx = np.unique(keys, axis=0, return_inverse=True)
    verts = np.zeros((uniq.shape[0], 3), np.float64)
    verts[idx] = verts_flat
    faces = idx.reshape(-1, 3)
    # drop degenerate faces
    good = (faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2]) \
        & (faces[:, 0] != faces[:, 2])
    return (verts * spacing).astype(np.float32), faces[good].astype(np.int64)


def extract_mesh(density_fn: Callable, center: np.ndarray, voxel_size: float,
                 mesh_th: float = 15.0, coordinate_scale: float = 1.0,
                 cube_half: Optional[int] = None,
                 chunk: int = 262144) -> Tuple[np.ndarray, np.ndarray]:
    """Chunked density eval + iso-surface; vertices returned in camera frame
    (reference mesh_rendering.py:74-76 semantics)."""
    vol, bins = density_grid(density_fn, center, voxel_size, coordinate_scale,
                             cube_half, chunk)
    if cube_half is None:
        cube_half = int(1 / voxel_size)
    verts, faces = marching_tetrahedra(vol, mesh_th)
    verts = (verts - cube_half) * voxel_size + center.reshape(1, 3)
    return verts.astype(np.float32), faces


def gan_create_mesh(gen, gen_vars, pose_to_camera, bone_length, z,
                    voxel_size: float = 0.003, mesh_th: float = 15.0,
                    truncation_psi: float = 0.4, cube_half: Optional[int] = None):
    """Mesh from a TriNARFGenerator (reference models/generator.py:131-140 +
    NARF/base.py:65-83)."""
    import jax.numpy as jnp
    z_nerf, z_rend, _ = gen.split_z(z)
    center = np.asarray(pose_to_camera)[0, 0, :3, 3].copy()
    pose_t, bl_t = gen.apply(gen_vars, pose_to_camera, bone_length,
                             method="transform_pose")
    planes = gen.apply(gen_vars, z_nerf, bl_t, truncation_psi,
                       method="compute_tri_plane_feature")
    scale = gen.nerf_params.coordinate_scale
    pose_scaled = pose_t.at[:, :, :3, 3].multiply(scale)

    def density_fn(points):
        d, _ = gen.apply(gen_vars, points, pose_scaled, bl_t, planes, z_rend,
                         None, method="nerf_density_color")
        return d

    return extract_mesh(density_fn, center, voxel_size, mesh_th, scale,
                        cube_half=cube_half)


def dso_create_mesh(gen, variables, pose_to_camera, bone_length, frame_time,
                    voxel_size: float = 0.003, mesh_th: float = 15.0,
                    cube_half: Optional[int] = None):
    """Mesh from a DSONARFGenerator."""
    import jax.numpy as jnp
    z = gen.apply(variables, frame_time, pose_to_camera, method="get_latents")
    center = np.asarray(pose_to_camera)[0, 0, :3, 3].copy()
    pose_t, bl_t = gen.apply(variables, pose_to_camera, bone_length,
                             method="transform_pose")
    if gen.use_triplane:
        cond = gen.apply(variables, z, bl_t, method="compute_tri_plane_feature")
    else:
        cond = z
    scale = gen.nerf_params.coordinate_scale
    pose_scaled = pose_t.at[:, :, :3, 3].multiply(scale)

    def density_fn(points):
        d, _ = gen.apply(variables, points, pose_scaled, bl_t, cond, z, None,
                         method="nerf_density_color")
        return d

    return extract_mesh(density_fn, center, voxel_size, mesh_th, scale,
                        cube_half=cube_half)
