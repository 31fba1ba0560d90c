"""Unarticulated NeRF baselines: MLPNeRF and TriPlaneNeRF.

Class-hierarchy parity with the reference (libraries/NeRF/nerf.py:30-85,
libraries/triplane/triplane_nerf.py:51-169) — single-frame models with no
bone re-rooting; not used by shipped configs but part of the model family.
"""
from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from enarf_gan_tpu.nn import module as nn

from enarf_gan_tpu.geometry.encoding import in_cube, positional_encoding, to_local
from enarf_gan_tpu.models.narf import NARFParams, _DensityColorHeads
from enarf_gan_tpu.nn.layers import MLP
from enarf_gan_tpu.nn.stylegan2 import StyleGAN2Generator
from enarf_gan_tpu.ops.activation import density_relu
from enarf_gan_tpu.ops.triplane import sample_feature


class MLPNeRF(nn.Module):
    """Plain PE→MLP NeRF (reference libraries/NeRF/nerf.py:30-85)."""
    params: NARFParams
    z_dim: int
    z2_dim: int

    def setup(self):
        p = self.params
        self.density_mlp = MLP(p.hidden_size, p.hidden_size, num_layers=8,
                               skips=(4,))
        self.heads = _DensityColorHeads(p, p.hidden_size, p.hidden_size // 2,
                                        self.z2_dim)

    def density_color(self, position, pose_to_camera, z, z_rend,
                      ray_direction=None):
        local = to_local(position, pose_to_camera)  # (B, 3, n), single frame
        validity = in_cube(local)
        enc = positional_encoding(local, self.params.num_frequency_for_position)
        feature = self.density_mlp(enc)
        density, color = self.heads(feature, z_rend, ray_direction)
        density = density * validity.any(axis=1, keepdims=True)
        return density, color, {}


class TriPlaneNeRF(nn.Module):
    """Single tri-plane NeRF, no bones (reference triplane_nerf.py:51-169)."""
    params: NARFParams
    z_dim: int
    z2_dim: int

    def setup(self):
        p = self.params
        ts = p.tri_plane_size
        if p.constant_triplane:
            self.tri_plane = self.param("tri_plane", nn.initializers.zeros,
                                        (1, p.feat_dim * 3, ts, ts))
        else:
            self.generator = StyleGAN2Generator(
                size=ts, style_dim=p.w_dim, n_mlp=8,
                out_channels=p.feat_dim * 3, use_noise=False,
                channel_max=max(p.w_dim, 64))
        hidden = 64
        self.heads = _DensityColorHeads(p, p.feat_dim, hidden, self.z2_dim)

    def compute_tri_plane_feature(self, z, truncation_psi=1.0):
        if self.params.constant_triplane:
            B = z.shape[0]
            return jnp.broadcast_to(self.tri_plane,
                                    (B,) + self.tri_plane.shape[1:])
        return self.generator([z], truncation_psi=truncation_psi)

    def density_color(self, position, pose_to_camera, tri_plane_feature,
                      z_rend, ray_direction=None):
        local = to_local(position, pose_to_camera)
        validity = in_cube(local)  # (B, 1, n)
        masked = jnp.where(validity, local.reshape(local.shape[0], 3, -1), 2.0)
        feature = sample_feature(tri_plane_feature, masked,
                                 clamp_mask=self.params.clamp_mask)
        density, color = self.heads(feature, z_rend, ray_direction)
        density = density * validity
        return density, color, {}
