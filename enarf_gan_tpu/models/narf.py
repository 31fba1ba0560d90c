"""Articulated NeRF models: TriPlaneNARF and MLPNARF.

Re-design of the reference model family (reference:
models/narf.py:17-389, libraries/NARF/base.py, libraries/NeRF/base.py).
Differences by design:

* pure modules — ``buffers_tensors`` / ``temporal_state`` side channels become
  explicit auxiliary outputs of the callers;
* canonical pose/bone-length "registered buffers" live in the 'buffers'
  variable collection (filled by ``models.generator.register_canonical_pose``);
* validity masking is static-shape (invalid positions forced to 2 so zero-pad
  sampling annihilates them — same masked semantics as the reference's sparse
  gather, models/narf.py:237 + sampling.py:79-127).

Tri-plane generator variants (reference models/narf.py:28-71), selected by
``NARFParams``: StyleGAN generator (default), constant planes, constant
tri-mask, deformation field (constant planes warped by a generated flow),
selector MLP.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from enarf_gan_tpu.nn import module as nn

from enarf_gan_tpu.geometry.encoding import (
    in_cube, multi_part_positional_encoding, positional_encoding, to_local)
from enarf_gan_tpu.nn.layers import (MLP, StyledConv1d, StyledMLP,
                                     GroupedConv1dReLUSelector)
from enarf_gan_tpu.nn.stylegan2 import StyleGAN2Generator
from enarf_gan_tpu.ops.activation import density_relu
from enarf_gan_tpu.ops.grid_sample import grid_sample_2d
from enarf_gan_tpu.ops.triplane import (
    sample_triplane_part_prob, sample_weighted_feature)


def params_use_candidate_sampling(params: "NARFParams",
                                  model_num_bone: int) -> bool:
    """True iff the candidate-sparse tri-plane-mask path drives part
    weighting (the default; selector variants bypass it)."""
    return (params.max_bones_per_point < model_num_bone
            and not params.no_selector and not params.selector_mlp)


def _sampler_kind() -> str:
    """Which candidate-sparse tri-plane sampler drives the hot path.

    "unirow" (default, bf16 sampling only — f32 configs fall back to
    "quad"): ops/unirow.py — ONE fused row gather per
    (point, candidate, plane) carrying the feature quad AND all-bone mask
    quads, combined by an XLA one-hot-select graph.
    "quad": ops/quadtable.py — feature row + bone-folded mask row (v3).
    "rowtable": ops/rowtable.py — two row gathers per sample (v2 path).
    "gridsample": per-plane grid-sample path (correctness oracle).
    """
    import os
    kind = os.environ.get("ENARF_SAMPLER")
    if kind in ("unirow", "quad", "rowtable", "gridsample"):
        return kind
    if os.environ.get("ENARF_ROWTABLE") == "0":  # legacy opt-out
        return "gridsample"
    return "unirow"


def _ablate_stage() -> str:
    """Measurement-only graph ablation for bench decomposition (PERF.md).

    ENARF_ABLATE=sampler  replace the tri-plane sampler outputs with cheap
                          functions of the candidate positions, so XLA DCEs
                          the table pack + gather + combine;
    ENARF_ABLATE=heads    replace the MLP heads with a slice of the feature.
    Never set during training/eval — frame-time decomposition only.
    """
    import os
    stage = os.environ.get("ENARF_ABLATE", "")
    if stage and not _ablate_stage._warned:
        _ablate_stage._warned = True
        import warnings
        warnings.warn(
            f"ENARF_ABLATE={stage!r} is set: sampler/head outputs are "
            "REPLACED with cheap stand-ins in every entry point. This is a "
            "bench-decomposition mode — unset it for any real run.",
            stacklevel=2)
    return stage


_ablate_stage._warned = False


@dataclasses.dataclass(frozen=True)
class NARFParams:
    """Static model hyper-parameters (mirror of config nerf_params)."""
    origin_location: str = "center_fixed"
    coordinate_scale: float = 3.0
    hidden_size: int = 256
    Nc: int = 48
    Nf: int = 64
    render_bs: int = 16384
    num_frequency_for_position: int = 10
    num_frequency_for_other: int = 4
    view_dependent: bool = True          # == not config.no_ray_direction
    model_type: str = "narf"             # narf | tnarf | dnarf (MLPNARF)
    multiply_density_with_triplane_weight: bool = False
    clamp_mask: bool = False
    constant_triplane: bool = False
    constant_trimask: bool = False
    constant_trimask_lr_mul: float = 1.0
    deformation_field: bool = False
    selector_mlp: bool = False
    no_selector: bool = False
    time_conditional: bool = True
    pose_conditional: bool = False
    tri_plane_size: int = 256
    feat_dim: int = 32
    w_dim: int = 512
    # top-M sparse bone gather (ops/triplane.py sample_weighted_feature_topm);
    # None/num_bone = exact dense. 4 covers real cube overlaps.
    max_bones_per_point: int = 4
    # dtype the packed row table is sampled in ("float32" | "bfloat16")
    plane_sample_dtype: str = "float32"
    # patch-window fast path (ops/tilewin.py): side of the pixel patch whose
    # rays share depth bins and window fetches; 0 = off (exact per-member
    # sampling). 4 is the measured sweet spot (tools/analyze_patch_locality)
    tile_patch: int = 0
    # tiled path: run the coarse pass on each patch's 4 corner rays only
    # (see RenderConfig.tile_coarse_corners) — ~4x less coarse work
    tile_coarse_corners: bool = False

    @classmethod
    def from_config(cls, nerf_params, view_dependent: Optional[bool] = None):
        """Build from a (merged) YAML config's generator_params.nerf_params."""
        get = lambda k, d: nerf_params.get(k, d) if hasattr(nerf_params, "get") \
            else getattr(nerf_params, k, d)
        if view_dependent is None:
            view_dependent = not get("no_ray_direction", False)
        return cls(
            origin_location=get("origin_location", "center_fixed"),
            coordinate_scale=float(get("coordinate_scale", 1)),
            hidden_size=int(get("hidden_size", 256)),
            Nc=int(get("Nc", 48)),
            Nf=int(get("Nf", 64)),
            render_bs=int(get("render_bs", 16384)),
            num_frequency_for_position=int(get("num_frequency_for_position", 10)),
            num_frequency_for_other=int(get("num_frequency_for_other", 4)),
            view_dependent=view_dependent,
            model_type=get("model_type", "narf"),
            multiply_density_with_triplane_weight=bool(
                get("multiply_density_with_triplane_wieght", False)),  # ref typo
            clamp_mask=bool(get("clamp_mask", False)),
            constant_triplane=bool(get("constant_triplane", False)),
            constant_trimask=bool(get("constant_trimask", False)),
            constant_trimask_lr_mul=float(get("constant_trimask_lr_mul", 1)),
            deformation_field=bool(get("deformation_field", False)),
            selector_mlp=bool(get("selector_mlp", False)),
            no_selector=bool(get("no_selector", False)),
            max_bones_per_point=int(get("max_bones_per_point", 4)),
            plane_sample_dtype=get("plane_sample_dtype", "float32"),
            time_conditional=bool(get("time_conditional", False)),
            pose_conditional=bool(get("pose_conditional", False)),
            tri_plane_size=int(get("tri_plane_size", 256)),
            feat_dim=int(get("feat_dim", 32)),
            w_dim=int(get("w_dim", 512)),
            tile_patch=int(get("tile_patch", 0)),
            tile_coarse_corners=bool(get("tile_coarse_corners", False)),
        )


def _repeat_ray_dir_encoding(feature: jnp.ndarray, ray_direction: jnp.ndarray,
                             num_frequency: int) -> jnp.ndarray:
    """PE(ray_dir) broadcast from n rays to n*Nf samples
    (reference triplane_nerf.py:38-41)."""
    enc = positional_encoding(ray_direction, num_frequency)  # (B, 3*2L, n)
    factor = feature.shape[-1] // enc.shape[-1]
    return jnp.repeat(enc, factor, axis=2)


class _DensityColorHeads(nn.Module):
    """density_fc + color MLP heads (reference triplane_nerf.py:32-48).

    NOTE: returns the raw density logit — TriPlaneNARF applies MyReLU*10 on
    top (reference models/narf.py:271-274) while MLPNARF leaves it raw (the
    reference's import shadowing at models/narf.py:9,14 selects the
    non-activating head; parity kept deliberately).
    """
    params: NARFParams
    in_dim: int
    hidden_dim: int
    z2_dim: int

    @nn.compact
    def __call__(self, feature, z_rend, ray_direction):
        if self.params.view_dependent:
            density = StyledConv1d(1, self.z2_dim, name="density_fc")(feature, z_rend)
            if ray_direction is None:
                color = None
            else:
                enc = _repeat_ray_dir_encoding(
                    feature, ray_direction, self.params.num_frequency_for_other)
                color = StyledMLP(self.hidden_dim, 3, style_dim=self.z2_dim,
                                  name="color_mlp")(
                    jnp.concatenate([feature, enc], axis=1), z_rend)
                color = jnp.tanh(color)
        else:
            cd = StyledMLP(self.hidden_dim, 4, style_dim=self.z2_dim,
                           name="color_mlp")(feature, z_rend)
            color, density = jnp.tanh(cd[:, :3]), cd[:, 3:]
        return density, color


class TriPlaneNARF(nn.Module):
    """Tri-plane articulated NeRF (reference models/narf.py:17-290)."""
    params: NARFParams
    z_dim: int
    z2_dim: int
    num_bone: int           # bones AFTER origin re-rooting (23 or 24)
    parent_id: Tuple[int, ...] = ()

    @property
    def feat_dim(self):
        return self.params.feat_dim

    def setup(self):
        p = self.params
        ts = p.tri_plane_size
        fch = p.feat_dim * 3
        mch = self.num_bone * 3
        c_dim = p.num_frequency_for_other * 2 * self.num_bone

        def sg(out_ch):
            return StyleGAN2Generator(size=ts, style_dim=p.w_dim, n_mlp=8,
                                      out_channels=out_ch, c_dim=c_dim,
                                      use_noise=False,
                                      channel_max=max(p.w_dim, 64))

        if p.constant_triplane:
            self.tri_plane = self.param("tri_plane", nn.initializers.zeros,
                                        (1, fch + mch, ts, ts))
        elif p.constant_trimask:
            self.generator = sg(fch)
            self.tri_plane = self.param("tri_plane", nn.initializers.zeros,
                                        (1, mch, ts, ts))
        elif p.deformation_field:
            self.tri_plane = self.param("tri_plane", nn.initializers.zeros,
                                        (1, fch + mch, ts, ts))
            self.flow_generator = sg(2 * 3)
        elif p.selector_mlp:
            self.generator = sg(fch)
            self.selector = GroupedConv1dReLUSelector(self.num_bone)
        else:
            self.generator = sg(fch + mch)

        hidden = 64
        head_in = p.feat_dim + (3 * p.num_frequency_for_other * 2
                                if p.view_dependent else 0)
        self.heads = _DensityColorHeads(p, head_in, hidden, self.z2_dim)

        self.canonical_pose = self.variable(
            "buffers", "canonical_pose",
            lambda: jnp.zeros((self.num_bone, 4, 4), jnp.float32))
        self.canonical_bone_length = self.variable(
            "buffers", "canonical_bone_length",
            lambda: jnp.ones((self.num_bone,), jnp.float32))

    # ------------------------------------------------------------------ #
    def encode_bone_length(self, bone_length: jnp.ndarray) -> jnp.ndarray:
        """(B, n_bone, 1) → (B, n_bone*2L) PE conditioning
        (reference models/narf.py:286-288)."""
        enc = multi_part_positional_encoding(
            bone_length, self.params.num_frequency_for_other, self.num_bone)
        return enc[:, :, 0]

    def compute_tri_plane_feature(self, z: jnp.ndarray, bone_length: jnp.ndarray,
                                  truncation_psi=1.0,
                                  update_w_avg: bool = False) -> jnp.ndarray:
        """z + PE(bone length) → (B, (32+n_bone)*3, 256, 256) feature planes."""
        p = self.params
        B = z.shape[0] if z is not None else bone_length.shape[0]
        ts = p.tri_plane_size
        if p.constant_triplane:
            return jnp.broadcast_to(self.tri_plane,
                                    (B,) + self.tri_plane.shape[1:])
        c = self.encode_bone_length(bone_length)
        if p.constant_trimask:
            feat = self.generator([z], c=c, truncation_psi=truncation_psi,
                                  update_w_avg=update_w_avg)
            mask = jnp.broadcast_to(self.tri_plane * p.constant_trimask_lr_mul,
                                    (B,) + self.tri_plane.shape[1:])
            return jnp.concatenate([feat, mask], axis=1)
        if p.deformation_field:
            # warp constant feature planes by a generated flow field
            # (reference models/narf.py:39-58)
            flow = self.flow_generator([z], c=c, truncation_psi=truncation_psi,
                                       update_w_avg=update_w_avg)  # (B, 6, ts, ts)
            flow = flow.reshape(B * 3, 2, ts, ts).transpose(0, 2, 3, 1)  # (3B,ts,ts,2)
            ar = jnp.arange(ts, dtype=flow.dtype)
            gy, gx = jnp.meshgrid(ar, ar, indexing="ij")
            grid = jnp.stack([gx, gy], axis=2) + 0.5  # (ts, ts, 2) in pixels
            grid = (grid[None] + flow) / (ts / 2) - 1  # [-1, 1]
            planes = jnp.broadcast_to(self.tri_plane,
                                      (B,) + self.tri_plane.shape[1:])
            fch = p.feat_dim * 3
            feat_planes = planes[:, :fch].reshape(B * 3, p.feat_dim, ts, ts)
            warped = grid_sample_2d(feat_planes, grid.reshape(B * 3, -1, 2))
            warped = warped.reshape(B, fch, ts, ts)
            return jnp.concatenate([warped, planes[:, fch:]], axis=1)
        if p.selector_mlp:
            feat = self.generator([z], c=c, truncation_psi=truncation_psi,
                                  update_w_avg=update_w_avg)
            zeros = jnp.zeros((B, self.num_bone * 3, ts, ts), feat.dtype)
            return jnp.concatenate([feat, zeros], axis=1)
        return self.generator([z], c=c, truncation_psi=truncation_psi,
                              update_w_avg=update_w_avg)

    # ------------------------------------------------------------------ #
    def to_local_and_canonical(self, points, pose_to_camera, bone_length):
        """Camera → per-bone local + canonical coords
        (reference models/narf.py:147-174)."""
        R = pose_to_camera[:, :, :3, :3]
        t = pose_to_camera[:, :, :3, 3:]
        local = jnp.einsum("bkij,bkjn->bkin", jnp.swapaxes(R, -1, -2),
                           points[:, None] - t,
                           precision=jax.lax.Precision.HIGHEST)  # (B,K,3,n)
        scale = (self.canonical_bone_length.value[None, :, None]
                 / bone_length / self.params.coordinate_scale)  # (B,K,1)
        canonical = local * scale[:, :, :, None]
        cR = self.canonical_pose.value[:, :3, :3]
        ct = self.canonical_pose.value[:, :3, 3:]
        canonical = jnp.einsum("kij,bkjn->bkin", cR, canonical,
                               precision=jax.lax.Precision.HIGHEST) + ct[None]
        bs, K, _, n = local.shape
        return local.reshape(bs, K * 3, n), canonical

    def calc_weight(self, tri_plane_weights, position, position_validity):
        """Part probabilities: uniform / selector MLP / tri-plane prob
        (reference models/narf.py:122-145)."""
        p = self.params
        bs, K, _, n = position.shape
        if p.no_selector:
            return jnp.full((bs, K, n), 1.0 / K, position.dtype)
        if p.selector_mlp:
            enc = multi_part_positional_encoding(
                position.reshape(bs, K * 3, n), p.num_frequency_for_position, K)
            h = self.selector(enc)
            return jax.nn.softmax(h, axis=1)
        return sample_triplane_part_prob(tri_plane_weights, position,
                                         position_validity, mode="prod",
                                         clamp_mask=p.clamp_mask)

    @property
    def plane_sample_dtype(self):
        return (jnp.bfloat16 if self.params.plane_sample_dtype == "bfloat16"
                else jnp.float32)

    def uses_candidate_sampling(self) -> bool:
        return params_use_candidate_sampling(self.params, self.num_bone)

    def supports_tiled_sampling(self) -> bool:
        """tile_patch only accelerates the candidate-sparse tri-plane-mask
        path; selector variants (no_selector / selector_mlp) fall back to
        the exact renderer (they have no per-bone mask planes to window)."""
        return (self.params.tile_patch > 0
                and self.uses_candidate_sampling())

    def _effective_sampler(self) -> str:
        kind = _sampler_kind()
        if kind == "unirow" and (self.params.plane_sample_dtype != "bfloat16"
                                 or self.params.feat_dim > 32
                                 or self.num_bone > 32):
            return "quad"  # unirow rows are bf16 / 32-lane-blocked
        return kind

    def pack_planes(self, tri_plane_feature):
        """Pre-pack planes into the active sampler's table.

        Callers that evaluate density_color many times per frame (the chunked
        full-image scan, coarse+fine passes) hoist the pack here so it runs
        once per frame instead of once per chunk (reference analog: the
        tri-plane is computed once per image, NARF/base.py:53-63).
        Returns the input unchanged when the active sampler keeps raw planes.
        """
        if (tri_plane_feature is not None
                and not isinstance(tri_plane_feature, tuple)
                and tri_plane_feature.ndim == 4
                and self.uses_candidate_sampling()):
            kind = self._effective_sampler()
            if kind == "unirow":
                from enarf_gan_tpu.ops.unirow import pack_unirow
                return (pack_unirow(tri_plane_feature, self.params.feat_dim,
                                    self.num_bone),)
            if kind == "quad":
                from enarf_gan_tpu.ops.quadtable import pack_quadtable
                return pack_quadtable(tri_plane_feature,
                                      self.params.feat_dim, self.num_bone,
                                      self.plane_sample_dtype)
        return tri_plane_feature

    def density_color(self, position, pose_to_camera, bone_length,
                      tri_plane_feature, z_rend, ray_direction=None):
        """Density + color at camera-frame positions
        (reference models/narf.py:176-275 calc_density... + backbone).

        Args:
            position: (B, 3, n).
            pose_to_camera: (B, K, 4, 4) re-rooted bone frames
                (translation already scaled by coordinate_scale).
            bone_length: (B, K, 1).
            tri_plane_feature: (B, (32+K)*3, ts, ts) precomputed planes.
            z_rend: (B, z2_dim) rendering style.
            ray_direction: (B, 3, n_rays) world dirs or None.
        Returns:
            (density (B, 1, n), color (B, 3, n) | None, aux dict)
        """
        p = self.params
        bs, _, n = position.shape
        K = self.num_bone
        ts = p.tri_plane_size
        local, canonical = self.to_local_and_canonical(position, pose_to_camera,
                                                       bone_length)
        validity = in_cube(local)  # (B, K, n)
        validity = validity & (jnp.abs(canonical) < 1).all(axis=2)
        canonical_pts = canonical  # (B, K, 3, n)
        fch = p.feat_dim * 3

        use_candidates = (p.max_bones_per_point < K and not p.no_selector
                          and not p.selector_mlp)
        packed = isinstance(tri_plane_feature, tuple)
        if packed:
            assert use_candidates, \
                "pre-packed sampling tables require the candidate fast path"
        if use_candidates:
            # sparse fast path: gather mask probs AND features only for the
            # M most-central valid bones (static-shape analog of the
            # reference's valid-pair gather, sampling.py:99-123)
            from enarf_gan_tpu.ops.triplane import select_candidate_bones
            cand_idx, cand_valid, cand_pos = select_candidate_bones(
                canonical_pts, validity, p.max_bones_per_point)
            kind = self._effective_sampler()
            if _ablate_stage() == "sampler":
                # bench decomposition: cheap stand-ins derived from
                # cand_pos so the table pack/gather/combine are DCE'd
                f0 = cand_pos.mean(axis=2).transpose(0, 2, 1)  # (B, 3, n)
                reps = (p.feat_dim + 2) // 3
                feature = jnp.tile(f0, (1, reps, 1))[:, :p.feat_dim]
                cand_w = jax.nn.sigmoid(cand_pos.sum(axis=3))  # (B, n, M)
            elif (packed and len(tri_plane_feature) == 1) or (
                    not packed and kind == "unirow"):
                # unirow table: ONE fused row gather per
                # (pt, cand, plane) — feature quad + all-bone mask quads in
                # the same row (ops/unirow.py)
                from enarf_gan_tpu.ops.unirow import (
                    pack_unirow, sample_candidates_unirow)
                table = (tri_plane_feature[0] if packed else
                         pack_unirow(tri_plane_feature, p.feat_dim, K))
                feature, cand_w = sample_candidates_unirow(
                    table, cand_pos, cand_idx, cand_valid, p.feat_dim, K,
                    ts, ts, clamp_mask=p.clamp_mask)
            elif packed or kind == "quad":
                # quad table: one feature-row + one bone-folded mask-row
                # gather per (pt, cand, plane) (ops/quadtable.py)
                from enarf_gan_tpu.ops.quadtable import (
                    pack_quadtable, sample_candidates_quadtable)
                table = tri_plane_feature if packed else pack_quadtable(
                    tri_plane_feature, p.feat_dim, K, self.plane_sample_dtype)
                feature, cand_w = sample_candidates_quadtable(
                    table, cand_pos, cand_idx, cand_valid, p.feat_dim, K,
                    ts, ts, clamp_mask=p.clamp_mask)
            elif kind == "rowtable":
                # channels-minor row table: 2 row gathers per sample fetch
                # feature AND mask lanes together (ops/rowtable.py)
                from enarf_gan_tpu.ops.rowtable import (
                    pack_rowtable, sample_candidates_rowtable)
                table = pack_rowtable(tri_plane_feature, p.feat_dim, K,
                                      self.plane_sample_dtype)
                feature, cand_w = sample_candidates_rowtable(
                    table, cand_pos, cand_idx, cand_valid, p.feat_dim, K,
                    ts, ts, clamp_mask=p.clamp_mask)
            else:
                from enarf_gan_tpu.ops.triplane import (
                    sample_part_prob_candidates,
                    sample_weighted_feature_candidates)
                feat_planes = tri_plane_feature[:, :fch]
                if p.plane_sample_dtype == "bfloat16":
                    feat_planes = feat_planes.astype(jnp.bfloat16)
                cand_w = sample_part_prob_candidates(
                    tri_plane_feature[:, fch:], cand_idx, cand_pos,
                    clamp_mask=p.clamp_mask)  # (B, n, M)
                feature = sample_weighted_feature_candidates(
                    p.feat_dim, feat_planes, cand_pos,
                    cand_w.astype(feat_planes.dtype),
                    cand_valid, clamp_mask=p.clamp_mask)
            feature = feature.astype(jnp.float32)  # (B, 32, n)
            weight_max = (cand_w * cand_valid).max(axis=2)[:, None]  # (B,1,n)
            weight = cand_w.transpose(0, 2, 1)  # (B, M, n) for aux
        else:
            masked_pos = jnp.where(validity[:, :, None], canonical_pts, 2.0)
            weight = self.calc_weight(
                tri_plane_feature[:, fch:].reshape(bs * K, 3, ts, ts),
                masked_pos, validity)
            feature = sample_weighted_feature(
                p.feat_dim, tri_plane_feature[:, :fch], masked_pos, weight,
                validity, clamp_mask=p.clamp_mask,
                max_bones=None)  # (B, 32, n)
            weight_max = weight.max(axis=1, keepdims=True)

        if _ablate_stage() == "heads":
            density, color = feature[:, :1], feature[:, 1:4]
        else:
            density, color = self.heads(feature, z_rend, ray_direction)
        if p.multiply_density_with_triplane_weight:
            density = density_relu(density) * (10 * weight_max)
        else:
            density = density_relu(density) * 10
        density = density * validity.any(axis=1, keepdims=True)
        aux = {"weight": weight}
        return density, color, aux

    def pack_planes_tiled(self, tri_plane_feature):
        """Pack planes into the patch-window tables (ops/tilewin.py)."""
        from enarf_gan_tpu.ops.tilewin import pack_tilewin
        assert self.uses_candidate_sampling(), \
            "tile_patch requires the candidate-sparse tri-plane-mask path " \
            "(incompatible with no_selector / selector_mlp / " \
            "max_bones_per_point >= num_bone)"
        return pack_tilewin(tri_plane_feature, self.params.feat_dim,
                            self.num_bone)

    def density_color_tiled(self, position, pose_to_camera, bone_length,
                            tables, z_rend, n_patch: int, m: int, S: int,
                            ray_direction=None, with_stats: bool = False):
        """Patch-window fast path of ``density_color`` (ops/tilewin.py).

        Same math as the candidate branch, but candidates are chosen per
        (pixel patch, sample) and the tri-plane gathers are one shared
        window fetch per (patch, sample, slot, plane) instead of one row
        per (point, candidate, plane). ``position`` must be in tiled point
        order ((patch*m + member)*S + sample); see nerf/tiled.py.
        """
        from enarf_gan_tpu.ops.tilewin import (select_patch_slots,
                                               sample_tilewin)
        p = self.params
        bs, _, n = position.shape
        local, canonical = self.to_local_and_canonical(
            position, pose_to_camera, bone_length)
        validity = in_cube(local)
        validity = validity & (jnp.abs(canonical) < 1).all(axis=2)
        slot_idx, cand_pos, cand_valid = select_patch_slots(
            canonical, validity, n_patch, m, S, p.max_bones_per_point)
        if _ablate_stage() == "sampler":
            # bench decomposition: DCE the window gather+combine (and the
            # table pack, which then has no consumer in the frame graph)
            f0 = cand_pos.mean(axis=2).reshape(bs, 3, n)
            reps = (tables.feat_dim + 2) // 3
            feature = jnp.tile(f0, (1, reps, 1))[:, :tables.feat_dim]
            cand_w = jax.nn.sigmoid(cand_pos.sum(axis=1))  # (B,Mp,np,m,S)
            out = (feature, cand_w, {"clamped": jnp.float32(0)})
        else:
            out = sample_tilewin(tables, cand_pos, slot_idx, cand_valid,
                                 clamp_mask=p.clamp_mask,
                                 with_stats=with_stats)
        feature, cand_w = out[0].astype(jnp.float32), out[1]
        wv = (cand_w * cand_valid).max(axis=1)          # (B, np, m, S)
        weight_max = wv.reshape(bs, 1, n)

        if _ablate_stage() == "heads":
            density, color = feature[:, :1], feature[:, 1:4]
        else:
            density, color = self.heads(feature, z_rend, ray_direction)
        if p.multiply_density_with_triplane_weight:
            density = density_relu(density) * (10 * weight_max)
        else:
            density = density_relu(density) * 10
        density = density * validity.any(axis=1, keepdims=True)
        aux = {"weight": cand_w.reshape(bs, -1, n)}
        if with_stats:
            aux["tilewin_stats"] = out[2]
        return density, color, aux


class MLPNARF(nn.Module):
    """MLP-based NARF baselines: narf / tnarf / dnarf
    (reference models/narf.py:293-389)."""
    params: NARFParams
    z_dim: int
    z2_dim: int
    num_bone: int
    parent_id: Tuple[int, ...] = ()

    def setup(self):
        p = self.params
        K = self.num_bone
        L = p.num_frequency_for_position
        hidden = p.hidden_size
        self.selector = GroupedConv1dReLUSelector(K)
        in_dim = K * 3 * L * 2
        if p.model_type == "dnarf":
            self.deformation_field = MLP(hidden, K * 3, num_layers=8, skips=(4,))
            self.density_mlp = MLP(hidden, hidden, num_layers=8, skips=(4,))
        elif p.model_type == "tnarf":
            self.density_mlp = StyledMLP(hidden, hidden, style_dim=self.z_dim,
                                         num_layers=8)
        elif p.model_type == "narf":
            self.density_mlp = MLP(hidden, hidden, num_layers=8, skips=(4,))
        else:
            raise ValueError(f"unknown model_type {p.model_type!r}")
        head_hidden = hidden // 2
        self.heads = _DensityColorHeads(p, hidden, head_hidden, self.z2_dim)

    def density_color(self, position, pose_to_camera, bone_length, z, z_rend,
                      ray_direction=None):
        """(reference models/narf.py:332-389). Densities stay unactivated —
        see _DensityColorHeads note."""
        p = self.params
        K = self.num_bone
        L = p.num_frequency_for_position
        local = to_local(position, pose_to_camera)  # (B, K*3, n)
        validity = in_cube(local)  # (B, K, n)

        enc = multi_part_positional_encoding(local, L, K)
        prob = jax.nn.softmax(self.selector(enc), axis=1)  # (B, K, n)
        enc = enc * jnp.repeat(prob, 3 * L * 2, axis=1)

        if p.model_type == "dnarf":
            zz = jnp.broadcast_to(z[:, :, None], z.shape + (position.shape[-1],))
            dp = self.deformation_field(jnp.concatenate([enc, zz], axis=1))
            local = local + dp
            enc = multi_part_positional_encoding(local, L, K)

        if p.model_type == "tnarf":
            feature = self.density_mlp(enc, z)
        else:
            feature = self.density_mlp(enc)

        density, color = self.heads(feature, z_rend, ray_direction)
        density = density * validity.any(axis=1, keepdims=True)
        return density, color, {"prob": prob}
