"""Image-level generators: TriNARFGenerator (GAN) and DSONARFGenerator.

Re-design of reference models/generator.py:14-300. Both are pure
modules (nn/module.py); RNG is threaded explicitly; the reference's
``buffers_tensors`` (fine_weights / fine_depth / tri_plane_feature) are
returned in an ``aux`` dict.

Full-image rendering lives in module-level functions that scan jit-compiled
fixed-size ray chunks (reference rendering.py:362-427's python loop).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from enarf_gan_tpu.nn import module as nn

from enarf_gan_tpu.geometry.encoding import scalar_positional_encoding
from enarf_gan_tpu.geometry.pose import transform_pose, transform_canonical_pose
from enarf_gan_tpu.models.narf import (NARFParams, TriPlaneNARF, MLPNARF,
                                       params_use_candidate_sampling)
from enarf_gan_tpu.nerf.ray_sampler import (image_grid_coords,
                                            mask_based_sampler,
                                            patch_based_sampler)
from enarf_gan_tpu.nerf.rendering import (RenderConfig, render_rays,
                                          render_entire_img)
from enarf_gan_tpu.nn.stylegan2 import PretrainedStyleGAN, StyleGAN2Generator


def _model_num_bone(num_bone: int, origin_location: str) -> int:
    """reference libraries/NARF/base.py:16."""
    return num_bone - 1 if origin_location in ("center", "center_fixed") else num_bone


def pose_encoding(pose: jnp.ndarray) -> jnp.ndarray:
    """Root-relative rotations → (B, (num_joint-1)*9)
    (reference models/generator.py:192-203)."""
    rot = pose[:, 1:, :3, :3]
    root = jnp.broadcast_to(pose[:, :1, :3, :3], rot.shape)
    enc = jnp.einsum("bkji,bkjl->bkil", root, rot,
                     precision=jax.lax.Precision.HIGHEST)  # root^T @ rot
    return enc.reshape(enc.shape[0], -1)


class DSONARFGenerator(nn.Module):
    """Dynamic-scene-overfitting generator (reference models/generator.py:143-300)."""
    nerf_params: NARFParams
    size: int
    num_bone: int                      # joints (24)
    parent_id: Tuple[int, ...]
    use_triplane: bool = True
    ray_batchsize: int = 4096

    @property
    def z_dim(self) -> int:
        z = 0
        if self.nerf_params.time_conditional:
            z += 20
        if self.nerf_params.pose_conditional:
            z += (self.num_bone - 1) * 9
        return z

    @property
    def model_num_bone(self) -> int:
        return _model_num_bone(self.num_bone, self.nerf_params.origin_location)

    def setup(self):
        cls = TriPlaneNARF if self.use_triplane else MLPNARF
        self.nerf = cls(self.nerf_params, z_dim=self.z_dim, z2_dim=self.z_dim,
                        num_bone=self.model_num_bone, parent_id=self.parent_id)

    # ---------------------------------------------------------------- #
    def get_latents(self, frame_time: jnp.ndarray,
                    pose_to_camera: jnp.ndarray) -> jnp.ndarray:
        """PE(frame_time) ⊕ pose encoding (reference generator.py:205-217)."""
        zs = []
        if self.nerf_params.time_conditional:
            zs.append(scalar_positional_encoding(frame_time, 10))
        if self.nerf_params.pose_conditional:
            zs.append(pose_encoding(pose_to_camera))
        assert zs, "DSO model needs time and/or pose conditioning"
        return jnp.concatenate(zs, axis=1)

    def transform_pose(self, pose_to_camera, bone_length):
        return transform_pose(pose_to_camera, bone_length,
                              self.nerf_params.origin_location,
                              np.asarray(self.parent_id))

    def render_cfg(self) -> RenderConfig:
        p = self.nerf_params
        return RenderConfig(Nc=p.Nc, Nf=p.Nf,
                            coordinate_scale=p.coordinate_scale,
                            view_dependent=p.view_dependent,
                            tile_coarse_corners=p.tile_coarse_corners)

    def compute_tri_plane_feature(self, z, bone_length_t, truncation_psi=1.0):
        return self.nerf.compute_tri_plane_feature(z, bone_length_t,
                                                   truncation_psi)

    def nerf_density_color(self, points, pose_scaled, bone_length_t, z_or_planes,
                           z_rend, ray_direction):
        d, c, _ = self.nerf.density_color(points, pose_scaled, bone_length_t,
                                          z_or_planes, z_rend, ray_direction)
        return d, c

    def pack_planes(self, z_or_planes):
        """Hoist the sampling-table pack out of per-chunk/per-pass calls."""
        if self.use_triplane:
            return self.nerf.pack_planes(z_or_planes)
        return z_or_planes

    def pack_planes_tiled(self, planes):
        return self.nerf.pack_planes_tiled(planes)

    def nerf_density_color_tiled(self, points, pose_scaled, bone_length_t,
                                 tables, z_rend, n_patch, m, S,
                                 ray_direction=None, with_stats=False):
        d, c, aux = self.nerf.density_color_tiled(
            points, pose_scaled, bone_length_t, tables, z_rend, n_patch, m,
            S, ray_direction, with_stats)
        if with_stats:
            return d, c, aux
        return d, c

    def __call__(self, rng: jax.Array, pose_to_camera, camera_pose, mask,
                 frame_time, bone_length, inv_intrinsics,
                 background: Optional[float] = None):
        """Sparse training render (reference generator.py:219-254).

        Returns (color (B,3,n), mask (B,n), ray_idx (B,n), aux).
        """
        rng_rays, rng_fine = jax.random.split(rng)
        z = self.get_latents(frame_time, pose_to_camera)
        pose_t, bl_t = self.transform_pose(pose_to_camera, bone_length)

        P = self.nerf_params.tile_patch
        if self.use_triplane and self.nerf.supports_tiled_sampling():
            # tilewin fast path: train on whole P×P pixel patches so member
            # rays share depth bins and window fetches (ops/tilewin.py)
            from enarf_gan_tpu.nerf.tiled import render_rays_tiled
            ray_idx, img_coord = patch_based_sampler(rng_rays, mask,
                                                     self.ray_batchsize, P)
            tables = self.nerf.pack_planes_tiled(
                self.compute_tri_plane_feature(z, bl_t))

            def fn_t(points, ray_dir, pose_scaled, n_patch, m, S):
                d, c, _ = self.nerf.density_color_tiled(
                    points, pose_scaled, bl_t, tables, z, n_patch, m, S,
                    ray_dir)
                return d, c

            color, nerf_mask, disparity, aux = render_rays_tiled(
                rng_fine, fn_t, img_coord, pose_t, inv_intrinsics,
                self.render_cfg(), P, camera_pose=camera_pose)
        else:
            ray_idx, img_coord = mask_based_sampler(rng_rays, mask,
                                                    self.ray_batchsize)
            if self.use_triplane:
                cond = self.pack_planes(self.compute_tri_plane_feature(z, bl_t))
            else:
                cond = z

            def fn(points, ray_dir, pose_scaled):
                return self.nerf_density_color(points, pose_scaled, bl_t,
                                               cond, z, ray_dir)

            color, nerf_mask, disparity, aux = render_rays(
                rng_fine, fn, img_coord, pose_t, inv_intrinsics,
                self.render_cfg(), camera_pose=camera_pose)
        if background is None:
            background = -1.0
        color = color + background * (1 - nerf_mask[:, None])
        return color, nerf_mask, ray_idx, aux


class TriNARFGenerator(nn.Module):
    """Pose-conditioned GAN generator with tri-plane NARF foreground and
    StyleGAN2 background (reference models/generator.py:14-140)."""
    nerf_params: NARFParams
    size: int
    num_bone: int                      # joints (24)
    parent_id: Tuple[int, ...]
    z_dim: int = 256
    crop_background: bool = False
    black_background: bool = False
    pretrained_background: bool = False
    background_ratio: float = 0.7
    channel_max: int = 512
    # PretrainedStyleGAN checkpoint resolution (tests shrink it; the real
    # stylegan2-church checkpoint is 256²)
    pretrained_bg_size: int = 256
    # scan the full-image ray grid in chunks of this size inside the forward
    # (identical results; bounds the differentiable peak memory — see
    # nerf/rendering.py::render_rays ray_chunk)
    train_ray_chunk: int = 4096

    @property
    def model_num_bone(self) -> int:
        return _model_num_bone(self.num_bone, self.nerf_params.origin_location)

    def setup(self):
        self.nerf = TriPlaneNARF(self.nerf_params, z_dim=self.z_dim * 2,
                                 z2_dim=self.z_dim,
                                 num_bone=self.model_num_bone,
                                 parent_id=self.parent_id)
        if not self.black_background:
            if self.pretrained_background:
                # frozen stylegan2-church background (reference
                # models/generator.py:33-38, custom_stylegan2/net.py:679-709);
                # its 512-d latent is cat(z_bg, z_rend) inside the module
                self.background_generator = PretrainedStyleGAN(
                    size=self.size, gen_size=self.pretrained_bg_size,
                    style_dim=self.z_dim * 2, channel_max=self.channel_max)
            else:
                self.background_generator = StyleGAN2Generator(
                    size=self.size, style_dim=self.z_dim, n_mlp=4,
                    out_channels=3, crop_background=self.crop_background,
                    channel_max=self.channel_max)

    def split_z(self, z: jnp.ndarray):
        """z (B, 4*z_dim) → (2z nerf, z render, z background)
        (reference generator.py:74-79)."""
        zd = z.shape[1] // (3 if self.black_background else 4)
        if self.black_background:
            return z[:, :zd * 2], z[:, zd * 2:], None
        return z[:, :zd * 2], z[:, zd * 2: zd * 3], z[:, zd * 3:]

    def transform_pose(self, pose_to_camera, bone_length):
        return transform_pose(pose_to_camera, bone_length,
                              self.nerf_params.origin_location,
                              np.asarray(self.parent_id))

    def render_cfg(self) -> RenderConfig:
        p = self.nerf_params
        return RenderConfig(Nc=p.Nc, Nf=p.Nf,
                            coordinate_scale=p.coordinate_scale,
                            view_dependent=p.view_dependent,
                            tile_coarse_corners=p.tile_coarse_corners)

    def compute_tri_plane_feature(self, z_nerf, bone_length_t, truncation_psi=1.0,
                                  update_w_avg: bool = False):
        return self.nerf.compute_tri_plane_feature(z_nerf, bone_length_t,
                                                   truncation_psi, update_w_avg)

    def nerf_density_color(self, points, pose_scaled, bone_length_t, planes,
                           z_rend, ray_direction):
        d, c, _ = self.nerf.density_color(points, pose_scaled, bone_length_t,
                                          planes, z_rend, ray_direction)
        return d, c

    def pack_planes(self, planes):
        """Hoist the sampling-table pack out of per-chunk/per-pass calls."""
        return self.nerf.pack_planes(planes)

    def pack_planes_tiled(self, planes):
        return self.nerf.pack_planes_tiled(planes)

    def nerf_density_color_tiled(self, points, pose_scaled, bone_length_t,
                                 tables, z_rend, n_patch, m, S,
                                 ray_direction=None, with_stats=False):
        return self.nerf.density_color_tiled(points, pose_scaled,
                                             bone_length_t, tables, z_rend,
                                             n_patch, m, S, ray_direction,
                                             with_stats)

    def background(self, z_bg, z_rend, rng=None, train: bool = False):
        """(reference generator.py:101-104): style-mixed background at
        inject_index n_latent-4."""
        n_latent = self.background_generator.n_latent
        crop_rng = noise_rng = None
        if rng is not None:
            crop_rng, noise_rng = jax.random.split(rng)
        return self.background_generator([z_bg, z_rend],
                                         inject_index=n_latent - 4,
                                         noise_rng=noise_rng,
                                         crop_rng=crop_rng, train=train)

    def __call__(self, rng: jax.Array, pose_to_camera, pose_to_world,
                 bone_length, z, inv_intrinsics, truncation_psi=1.0,
                 black_bg_if_possible: bool = False, return_disparity: bool = False,
                 train: bool = False):
        """Generate an image from pose (reference generator.py:56-118).

        Returns (rendered_color (B,3,H,W), fg_mask (B,H,W), aux) where aux
        holds fine_weights / fine_depth / tri_plane_feature / disparity / bg.
        """
        B = pose_to_camera.shape[0]
        rng_fine, rng_bg = jax.random.split(rng)
        _, img_coord = image_grid_coords(self.size, self.size, B)

        z_nerf, z_rend, z_bg = self.split_z(z)
        pose_t, bl_t = self.transform_pose(pose_to_camera, bone_length)
        planes = self.compute_tri_plane_feature(z_nerf, bl_t, truncation_psi,
                                                update_w_avg=train)

        # no scan while init creates params (init traces once, full-width)
        chunk = None if self.is_initializing() else (self.train_ray_chunk or None)
        P = self.nerf_params.tile_patch
        if self.nerf.supports_tiled_sampling():
            # patch-window fast path (ops/tilewin.py): full-image GAN rays
            # ARE a pixel grid, so patch-major tiling applies directly
            from enarf_gan_tpu.nerf.tiled import (render_rays_tiled,
                                                  tile_permutation)
            perm = jnp.asarray(tile_permutation(self.size, P))
            tables = self.nerf.pack_planes_tiled(planes)

            def fn_t(points, ray_dir, pose_scaled, n_patch, m, S):
                def inner(points, ray_dir, pose_scaled):
                    d, c, _ = self.nerf.density_color_tiled(
                        points, pose_scaled, bl_t, tables, z_rend, n_patch,
                        m, S, ray_dir)
                    return d, c
                if train:
                    # remat the per-point network: the window gathers would
                    # otherwise be stored as residuals (SURVEY §7.3)
                    inner = jax.checkpoint(inner)
                return inner(points, ray_dir, pose_scaled)

            fg_color, fg_mask, disparity, raux = render_rays_tiled(
                rng_fine, fn_t, img_coord[..., perm], pose_t, inv_intrinsics,
                self.render_cfg(), P, camera_pose=None, ray_chunk=chunk)
            inv = jnp.argsort(perm)
            fg_color = fg_color[:, :, inv]
            fg_mask = fg_mask[:, inv]
            disparity = disparity[:, inv]
            # per-ray aux back to raster order; fine_points stays in tiled
            # point order (its consumers are tiled-order aware)
            raux = {k: (v if k == "fine_points" else v[:, :, inv])
                    for k, v in raux.items()}
        else:
            planes_packed = self.pack_planes(planes)

            def fn(points, ray_dir, pose_scaled):
                return self.nerf_density_color(points, pose_scaled, bl_t,
                                               planes_packed, z_rend, ray_dir)

            if train:
                # rematerialize the per-point network in the backward pass:
                # the gathered quad rows are several GB per 128² image as
                # residuals; recomputing costs about a third of a forward
                # (SURVEY §7.3: trade FLOPs for memory via jax.checkpoint)
                fn = jax.checkpoint(fn)

            fg_color, fg_mask, disparity, raux = render_rays(
                rng_fine, fn, img_coord, pose_t, inv_intrinsics,
                self.render_cfg(), camera_pose=None, ray_chunk=chunk)
        fg_color = fg_color.reshape(B, 3, self.size, self.size)
        fg_mask = fg_mask.reshape(B, self.size, self.size)

        if not self.black_background and not black_bg_if_possible:
            bg_color = self.background(z_bg, z_rend, rng_bg, train=train)
        else:
            bg_color = jnp.float32(-1.0)

        rendered = fg_color + (1 - fg_mask[:, None]) * bg_color
        aux = {"fine_weights": raux["fine_weights"],
               "fine_depth": raux["fine_depth"],
               "tri_plane_feature": planes,
               "fg_color": fg_color,
               "bg_color": bg_color}
        if return_disparity:
            aux["disparity"] = (disparity.reshape(B, self.size, self.size)
                                * self.nerf_params.coordinate_scale)
        return rendered, fg_mask, aux


# ---------------------------------------------------------------------- #
# registration + full-image rendering helpers
# ---------------------------------------------------------------------- #

def register_canonical_pose(variables, canonical_pose: np.ndarray,
                            origin_location: str, parent_id) -> dict:
    """Fill the model's canonical-pose buffers from a (24, 4, 4) canonical
    pose array (reference models/narf.py:84-120).

    Works on any variables pytree containing 'buffers' leaves named
    canonical_pose / canonical_bone_length (at any nesting depth).
    """
    canon, length = transform_canonical_pose(np.asarray(canonical_pose),
                                             np.asarray(parent_id),
                                             origin_location)

    def fill(tree):
        out = {}
        for k, v in tree.items():
            if k == "canonical_pose":
                assert v.shape == canon.shape, (v.shape, canon.shape)
                out[k] = jnp.asarray(canon)
            elif k == "canonical_bone_length":
                assert v.shape == length.shape, (v.shape, length.shape)
                out[k] = jnp.asarray(length)
            elif isinstance(v, dict):
                out[k] = fill(v)
            else:
                out[k] = v
        return out

    variables = dict(variables)
    assert "buffers" in variables, "model has no canonical-pose buffers"
    variables["buffers"] = fill(dict(variables["buffers"]))
    return variables


def dso_render_entire_img_tiled(gen: DSONARFGenerator, variables, rng,
                                pose_to_camera, inv_intrinsics, frame_time,
                                bone_length, camera_pose=None,
                                render_size: int = 128,
                                ray_batchsize: Optional[int] = None):
    """Patch-tiled full-image DSO inference — the shared-fetch fast path
    (nerf/tiled.py + ops/tilewin.py). Selected by
    ``nerf_params.tile_patch > 0``; same outputs as dso_render_entire_img
    up to the documented sampling-pattern change."""
    from enarf_gan_tpu.nerf.tiled import render_entire_img_tiled
    P = gen.nerf_params.tile_patch
    assert gen.use_triplane, "tile_patch requires the tri-plane model"
    z = gen.apply(variables, frame_time, pose_to_camera, method="get_latents")
    pose_t, bl_t = gen.apply(variables, pose_to_camera, bone_length,
                             method="transform_pose")
    planes = gen.apply(variables, z, bl_t, method="compute_tri_plane_feature")
    tables = gen.apply(variables, planes, method="pack_planes_tiled")

    def fn(points, ray_dir, pose_scaled, n_patch, m, S):
        return gen.apply(variables, points, pose_scaled, bl_t, tables, z,
                         n_patch, m, S, ray_dir,
                         method="nerf_density_color_tiled")

    cfg = gen.render_cfg()
    rb = ray_batchsize or gen.nerf_params.render_bs
    return render_entire_img_tiled(rng, fn, pose_t, inv_intrinsics, cfg,
                                   render_size, P, ray_batchsize=rb,
                                   camera_pose=camera_pose)


def dso_render_entire_img(gen: DSONARFGenerator, variables, rng,
                          pose_to_camera, inv_intrinsics, frame_time,
                          bone_length, camera_pose=None, render_size: int = 128,
                          ray_batchsize: Optional[int] = None,
                          use_normalized_intrinsics: bool = False, bbox=None):
    """Full-image DSO inference (reference generator.py:256-278): tri-plane
    computed once, then chunked ray scan."""
    z = gen.apply(variables, frame_time, pose_to_camera, method="get_latents")
    pose_t, bl_t = gen.apply(variables, pose_to_camera, bone_length,
                             method="transform_pose")
    if gen.use_triplane:
        cond = gen.apply(variables, z, bl_t, method="compute_tri_plane_feature")
        cond = gen.apply(variables, cond, method="pack_planes")
    else:
        cond = z

    def fn(points, ray_dir, pose_scaled):
        return gen.apply(variables, points, pose_scaled, bl_t, cond, z, ray_dir,
                         method="nerf_density_color")

    cfg = gen.render_cfg()
    rb = ray_batchsize or gen.nerf_params.render_bs
    return render_entire_img(rng, fn, pose_t, inv_intrinsics, cfg, render_size,
                             ray_batchsize=rb, camera_pose=camera_pose,
                             use_normalized_intrinsics=use_normalized_intrinsics,
                             bbox=bbox)


def make_dso_full_renderer(gen: DSONARFGenerator, render_size: int,
                           ray_batchsize: Optional[int] = None,
                           use_normalized_intrinsics: bool = False,
                           with_camera_pose: bool = True):
    """Build a JITTED full-image DSO renderer (compile once, reuse per frame).

    The unjitted helper dispatches op by op; all callers on hot paths must
    use this factory.
    """
    import functools

    @functools.partial(jax.jit, static_argnames=())
    def render(variables, rng, pose_to_camera, inv_intrinsics, frame_time,
               bone_length, camera_pose=None):
        if (gen.use_triplane and not use_normalized_intrinsics
                and gen.nerf_params.tile_patch
                and params_use_candidate_sampling(gen.nerf_params,
                                                  gen.model_num_bone)):
            return dso_render_entire_img_tiled(
                gen, variables, rng, pose_to_camera, inv_intrinsics,
                frame_time, bone_length, camera_pose=camera_pose,
                render_size=render_size, ray_batchsize=ray_batchsize)
        return dso_render_entire_img(
            gen, variables, rng, pose_to_camera, inv_intrinsics, frame_time,
            bone_length, camera_pose=camera_pose, render_size=render_size,
            ray_batchsize=ray_batchsize,
            use_normalized_intrinsics=use_normalized_intrinsics)

    return render


def make_gan_full_renderer(gen: TriNARFGenerator,
                           render_size: Optional[int] = None,
                           ray_batchsize: Optional[int] = None):
    """JITTED full-image GAN foreground renderer."""

    @jax.jit
    def render(variables, rng, pose_to_camera, bone_length, z, inv_intrinsics,
               truncation_psi=1.0):
        return gan_render_entire_img(gen, variables, rng, pose_to_camera,
                                     bone_length, z, inv_intrinsics,
                                     truncation_psi=truncation_psi,
                                     render_size=render_size,
                                     ray_batchsize=ray_batchsize)

    return render


def gan_render_entire_img(gen: TriNARFGenerator, variables, rng, pose_to_camera,
                          bone_length, z, inv_intrinsics, truncation_psi=1.0,
                          render_size: Optional[int] = None,
                          ray_batchsize: Optional[int] = None):
    """Full-image GAN foreground render (used by demos/eval at higher res)."""
    z_nerf, z_rend, _ = gen.split_z(z)
    pose_t, bl_t = gen.apply(variables, pose_to_camera, bone_length,
                             method="transform_pose")
    planes = gen.apply(variables, z_nerf, bl_t, truncation_psi,
                       method="compute_tri_plane_feature")
    cfg = gen.render_cfg()
    rb = ray_batchsize or gen.nerf_params.render_bs
    P = gen.nerf_params.tile_patch
    if P and params_use_candidate_sampling(gen.nerf_params,
                                           gen.model_num_bone):
        from enarf_gan_tpu.nerf.tiled import render_entire_img_tiled
        tables = gen.apply(variables, planes, method="pack_planes_tiled")

        def fn_t(points, ray_dir, pose_scaled, n_patch, m, S):
            d, c, _ = gen.apply(variables, points, pose_scaled, bl_t, tables,
                                z_rend, n_patch, m, S, ray_dir,
                                method="nerf_density_color_tiled")
            return d, c

        return render_entire_img_tiled(rng, fn_t, pose_t, inv_intrinsics,
                                       cfg, render_size or gen.size, P,
                                       ray_batchsize=rb)
    planes = gen.apply(variables, planes, method="pack_planes")

    def fn(points, ray_dir, pose_scaled):
        return gen.apply(variables, points, pose_scaled, bl_t, planes, z_rend,
                         ray_dir, method="nerf_density_color")

    return render_entire_img(rng, fn, pose_t, inv_intrinsics, cfg,
                             render_size or gen.size, ray_batchsize=rb)
