"""StyleGAN2 in JAX — mapping, skip-architecture synthesis, discriminator.

One implementation serves all three uses in the framework (the reference uses
two separate CUDA-op libraries for these):
  * tri-plane feature generator — 256², (32+n_bone)*3 ch, bone-length
    conditioning, no noise (reference libraries/triplane/triplane_nerf.py:17-29);
  * deformation-field flow generator — 256², 6 ch (reference models/narf.py:39-58);
  * learned background generator — 2x-wide constant input + random crop
    (reference libraries/custom_stylegan2/net.py:346-536).

Numerics follow the reference blocks: equalized LR everywhere, modulated 3x3
convs demodulated by rsqrt(sum sq), FIR [1,3,3,1] up/down firdn, skip
to_rgbs, and a minibatch-std discriminator (net.py:609-676).

Per-sample modulation uses the input-scale/output-demod formulation (one
shared-weight conv per layer instead of B grouped convs — same math). The upsample path realizes the transposed conv via lhs_dilation;
kernels are stored in conv orientation (a .pth import must flip them).

Truncation ψ uses a w_avg tracked in the 'stats' collection (ADA-style,
reference stylegan2_ada mapping); training steps thread ``update_w_avg=True``.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from enarf_gan_tpu.nn import module as nn

from enarf_gan_tpu.nn.layers import (EqualLinear, EqualConv2d, fused_leaky_relu,
                                     pixel_norm, _normal_init, _MATMUL_PREC)
from enarf_gan_tpu.ops.upfirdn import make_blur_kernel, upfirdn2d

BLUR_KERNEL = (1, 3, 3, 1)


def channels_dict(channel_multiplier: int = 2, channel_max: int = 512) -> dict:
    """Per-resolution channel counts (reference net.py:376-386; identical to
    stylegan2-ada's channel_base=32768 schedule for <=256 at multiplier 2).
    ``channel_max`` caps widths (tests / memory tuning)."""
    base = {4: 512, 8: 512, 16: 512, 32: 512,
            64: 256 * channel_multiplier, 128: 128 * channel_multiplier,
            256: 64 * channel_multiplier, 512: 32 * channel_multiplier,
            1024: 16 * channel_multiplier}
    return {k: min(v, channel_max) for k, v in base.items()}


class MappingNetwork(nn.Module):
    """z (+ optional conditioning c) → w, with tracked w_avg for truncation."""
    style_dim: int
    num_layers: int = 8
    lr_mul: float = 0.01
    c_dim: int = 0
    w_avg_beta: float = 0.995

    @nn.compact
    def __call__(self, z: jnp.ndarray, c: Optional[jnp.ndarray] = None,
                 update_w_avg: bool = False,
                 truncation_psi=1.0) -> jnp.ndarray:
        h = pixel_norm(z, axis=1)
        if self.c_dim > 0:
            assert c is not None and c.shape[1] == self.c_dim
            emb = EqualLinear(self.style_dim, name="embed")(c)
            h = jnp.concatenate([h, pixel_norm(emb, axis=1)], axis=1)
        for i in range(self.num_layers):
            h = EqualLinear(self.style_dim, lr_mul=self.lr_mul, activation=True,
                            name=f"fc{i}")(h)
        w_avg = self.variable("stats", "w_avg",
                              lambda: jnp.zeros((self.style_dim,), jnp.float32))
        if update_w_avg and not self.is_initializing():
            mean_w = jax.lax.stop_gradient(h.mean(axis=0))
            w_avg.value = mean_w + (w_avg.value - mean_w) * self.w_avg_beta
        # truncation as an always-applied lerp (psi is a traced scalar; psi=1
        # is the identity), so changing psi never recompiles.
        h = w_avg.value[None] + truncation_psi * (h - w_avg.value[None])
        return h


class _ModulatedConv2d(nn.Module):
    """Style-modulated (de)modulated 3x3/1x1 conv, optional 2x upsample."""
    out_channels: int
    kernel_size: int = 3
    demodulate: bool = True
    upsample: bool = False

    @nn.compact
    def __call__(self, x: jnp.ndarray, style_w: jnp.ndarray) -> jnp.ndarray:
        B, C, H, W = x.shape
        k = self.kernel_size
        weight = self.param("weight", _normal_init(), (self.out_channels, C, k, k))
        scale = 1 / math.sqrt(C * k * k)
        s = EqualLinear(C, bias_init=1.0, name="modulation")(style_w)  # (B, C)

        x = x * s[:, :, None, None]
        w = weight * scale
        if self.upsample:
            y = jax.lax.conv_general_dilated(
                x, w,
                window_strides=(1, 1), padding=((k - 1, k - 1), (k - 1, k - 1)),
                lhs_dilation=(2, 2),
                dimension_numbers=("NCHW", "OIHW", "NCHW"), precision=_MATMUL_PREC)
            if self.demodulate:
                d = jax.lax.rsqrt(
                    jnp.einsum("oikl,bi->bo", w ** 2, s ** 2) + 1e-8)
                y = y * d[:, :, None, None]
            kernel = make_blur_kernel(BLUR_KERNEL, upsample_factor=2)
            p = kernel.shape[0] - 2 - (k - 1)  # reference ModulatedConv2d pads
            y = upfirdn2d(y, kernel, pad=((p + 1) // 2 + 1, p // 2 + 1))
            return y
        y = jax.lax.conv_general_dilated(
            x, w, (1, 1), ((k // 2, k // 2), (k // 2, k // 2)),
            dimension_numbers=("NCHW", "OIHW", "NCHW"), precision=_MATMUL_PREC)
        if self.demodulate:
            d = jax.lax.rsqrt(jnp.einsum("oikl,bi->bo", w ** 2, s ** 2) + 1e-8)
            y = y * d[:, :, None, None]
        return y


class StyledConv2d(nn.Module):
    out_channels: int
    kernel_size: int = 3
    upsample: bool = False
    use_noise: bool = True

    @nn.compact
    def __call__(self, x: jnp.ndarray, style_w: jnp.ndarray,
                 noise_rng: Optional[jax.Array] = None) -> jnp.ndarray:
        y = _ModulatedConv2d(self.out_channels, self.kernel_size,
                             upsample=self.upsample, name="conv")(x, style_w)
        if self.use_noise:
            nw = self.param("noise_weight", nn.initializers.zeros, ())
            if noise_rng is not None:
                noise = jax.random.normal(noise_rng,
                                          (y.shape[0], 1) + y.shape[2:], y.dtype)
                y = y + nw * noise
        b = self.param("bias", nn.initializers.zeros, (self.out_channels,))
        y = y + b[None, :, None, None]
        return jax.nn.leaky_relu(y, 0.2) * 2 ** 0.5


class ToRGB(nn.Module):
    out_channels: int = 3

    @nn.compact
    def __call__(self, x: jnp.ndarray, style_w: jnp.ndarray,
                 skip: Optional[jnp.ndarray] = None) -> jnp.ndarray:
        y = _ModulatedConv2d(self.out_channels, 1, demodulate=False,
                             name="conv")(x, style_w)
        b = self.param("bias", nn.initializers.zeros, (self.out_channels,))
        y = y + b[None, :, None, None]
        if skip is not None:
            kernel = make_blur_kernel(BLUR_KERNEL, upsample_factor=2)
            p = kernel.shape[0] - 2
            skip = upfirdn2d(skip, kernel, up=2, pad=((p + 1) // 2 + 1, p // 2))
            y = y + skip
        return y


class SynthesisNetwork(nn.Module):
    """Skip-architecture synthesis (reference net.py:388-531)."""
    size: int
    out_channels: int = 3
    channel_multiplier: int = 2
    wide: bool = False          # crop_background: 2x-wide constant input
    use_noise: bool = True
    channel_max: int = 512
    const_hw: Optional[Tuple[int, int]] = None  # override constant-input shape

    @property
    def n_latent(self) -> int:
        return int(math.log2(self.size)) * 2 - 2

    @nn.compact
    def __call__(self, latent: jnp.ndarray,
                 noise_rng: Optional[jax.Array] = None) -> jnp.ndarray:
        """latent: (B, n_latent, style_dim) per-layer styles → (B, C, H, W[*2])."""
        ch = channels_dict(self.channel_multiplier, self.channel_max)
        log_size = int(math.log2(self.size))
        B = latent.shape[0]
        const_hw = self.const_hw or (4, 8 if self.wide else 4)
        const = self.param("const", _normal_init(), (1, ch[4]) + tuple(const_hw))
        out = jnp.broadcast_to(const, (B,) + const.shape[1:])

        def next_rng(r):
            return (None, None) if r is None else tuple(jax.random.split(r))

        noise_rng, r = next_rng(noise_rng)
        out = StyledConv2d(ch[4], use_noise=self.use_noise,
                           name="conv1")(out, latent[:, 0], r)
        skip = ToRGB(self.out_channels, name="to_rgb1")(out, latent[:, 1])

        i = 1
        for res_log in range(3, log_size + 1):
            res_ch = ch[2 ** res_log]
            noise_rng, r1 = next_rng(noise_rng)
            out = StyledConv2d(res_ch, upsample=True, use_noise=self.use_noise,
                               name=f"conv_up{res_log}")(out, latent[:, i], r1)
            noise_rng, r2 = next_rng(noise_rng)
            out = StyledConv2d(res_ch, use_noise=self.use_noise,
                               name=f"conv{res_log}")(out, latent[:, i + 1], r2)
            skip = ToRGB(self.out_channels, name=f"to_rgb{res_log}")(
                out, latent[:, i + 2], skip)
            i += 2
        return skip


class StyleGAN2Generator(nn.Module):
    """Mapping + synthesis with style mixing / truncation / background crop.

    Covers both the reference's background Generator (net.py:346-536) and the
    stylegan2-ada tri-plane generator (triplane_nerf.py:17-29) via config.
    """
    size: int
    style_dim: int
    n_mlp: int
    out_channels: int = 3
    channel_multiplier: int = 2
    c_dim: int = 0
    crop_background: bool = False
    use_noise: bool = True
    channel_max: int = 512

    def setup(self):
        self.mapping = MappingNetwork(self.style_dim, self.n_mlp, c_dim=self.c_dim)
        self.synthesis = SynthesisNetwork(self.size, self.out_channels,
                                          self.channel_multiplier,
                                          wide=self.crop_background,
                                          use_noise=self.use_noise,
                                          channel_max=self.channel_max)

    @property
    def n_latent(self) -> int:
        return int(math.log2(self.size)) * 2 - 2

    def __call__(self, styles: Sequence[jnp.ndarray],
                 c: Optional[jnp.ndarray] = None,
                 inject_index: Optional[int] = None,
                 truncation_psi: float = 1.0,
                 input_is_latent: bool = False,
                 update_w_avg: bool = False,
                 noise_rng: Optional[jax.Array] = None,
                 crop_rng: Optional[jax.Array] = None,
                 train: bool = False) -> jnp.ndarray:
        n_latent = self.n_latent
        if not input_is_latent:
            styles = [self.mapping(s, c, update_w_avg=update_w_avg,
                                   truncation_psi=truncation_psi) for s in styles]
        if len(styles) < 2:
            latent = jnp.repeat(styles[0][:, None], n_latent, axis=1)
        else:
            if inject_index is None:
                inject_index = n_latent // 2
            latent = jnp.concatenate(
                [jnp.repeat(styles[0][:, None], inject_index, axis=1),
                 jnp.repeat(styles[1][:, None], n_latent - inject_index, axis=1)],
                axis=1)
        img = self.synthesis(latent, noise_rng=noise_rng)
        if self.crop_background:
            # training: random horizontal+vertical crop of the 2x-wide canvas
            # (reference net.py:527-531 uses kornia RandomCrop); eval: center.
            if train and crop_rng is not None:
                max_x = img.shape[3] - self.size
                max_y = img.shape[2] - self.size
                kx, ky = jax.random.split(crop_rng)
                x0 = jax.random.randint(kx, (), 0, max_x + 1)
                y0 = jax.random.randint(ky, (), 0, max_y + 1)
                img = jax.lax.dynamic_slice(
                    img, (0, 0, y0, x0),
                    (img.shape[0], img.shape[1], self.size, self.size))
            else:
                img = img[:, :, :, self.size // 2: self.size * 3 // 2]
        return img


class ConvLayer(nn.Module):
    """EqualConv2d with optional FIR-blur downsample + fused lrelu
    (reference net.py:539-585)."""
    out_channels: int
    kernel_size: int = 3
    downsample: bool = False
    activate: bool = True
    use_bias: bool = True

    @nn.compact
    def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
        k = self.kernel_size
        if self.downsample:
            kernel = make_blur_kernel(BLUR_KERNEL)
            p = (kernel.shape[0] - 2) + (k - 1)
            x = upfirdn2d(x, kernel, pad=((p + 1) // 2, p // 2))
            stride, padding = 2, 0
        else:
            stride, padding = 1, k // 2
        y = EqualConv2d(self.out_channels, k, stride, padding,
                        use_bias=self.use_bias and not self.activate,
                        name="conv")(x)
        if self.activate:
            b = self.param("bias", nn.initializers.zeros, (self.out_channels,)) \
                if self.use_bias else None
            y = fused_leaky_relu(y, b)
        return y


class ResBlock(nn.Module):
    out_channels: int

    @nn.compact
    def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
        in_ch = x.shape[1]
        h = ConvLayer(in_ch, 3, name="conv1")(x)
        h = ConvLayer(self.out_channels, 3, downsample=True, name="conv2")(h)
        skip = ConvLayer(self.out_channels, 1, downsample=True, activate=False,
                         use_bias=False, name="skip")(x)
        return (h + skip) / math.sqrt(2)


class Discriminator(nn.Module):
    """StyleGAN2 discriminator with optional minibatch-std
    (reference net.py:609-676). ``axis_name`` enables the cross-device
    all-reduce of the std features inside shard_map (net.py:665-667 → psum)."""
    size: int
    in_dim: int = 3
    channel_multiplier: int = 2
    minibatch_std: bool = True
    stddev_group: int = 4
    axis_name: Optional[str] = None
    channel_max: int = 512

    @nn.compact
    def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
        ch = channels_dict(self.channel_multiplier, self.channel_max)
        log_size = int(math.log2(self.size))
        h = ConvLayer(ch[self.size], 1, name="from_rgb")(x)
        for i in range(log_size, 2, -1):
            h = ResBlock(ch[2 ** (i - 1)], name=f"res{i}")(h)
        B, C, H, W = h.shape
        if self.minibatch_std:
            group = min(B, self.stddev_group)
            stddev = h.reshape(group, -1, 1, C, H, W)
            var = stddev.var(axis=0)
            if self.axis_name is not None:
                var = jax.lax.pmean(var, self.axis_name)
            stddev = jnp.sqrt(var + 1e-8)          # (B//group, 1, C, H, W)
            stddev = stddev.mean(axis=(2, 3, 4), keepdims=True)  # (B//g,1,1,1,1)
            stddev = stddev[:, :, 0]               # (B//group, 1, 1, 1)
            stddev = jnp.tile(stddev, (group, 1, H, W))
            h = jnp.concatenate([h, stddev], axis=1)
        h = ConvLayer(ch[4], 3, name="final_conv")(h)
        h = h.reshape(B, -1)
        h = EqualLinear(ch[4], activation=True, name="final_linear0")(h)
        return EqualLinear(1, name="final_linear1")(h)


class PretrainedStyleGAN(nn.Module):
    """Frozen StyleGAN2-church background (reference net.py:679-709).

    The reference slices the 4x4 constant input to half height (net.py:695)
    and renders a 128x256 canvas; we keep the full 256² canvas and crop —
    randomly to ``size``² at train time, center at eval. Weights come from a
    rosinality stylegan2-church checkpoint converted with
    ``data_preprocess/convert_stylegan2_church.py`` and loaded via
    ``training/checkpoint.py::load_pretrained_background``.
    """
    size: int = 128
    style_dim: int = 512
    n_mlp: int = 8
    gen_size: int = 256          # church checkpoint resolution
    channel_max: int = 512

    def setup(self):
        self.gen = StyleGAN2Generator(size=self.gen_size, style_dim=self.style_dim,
                                      n_mlp=self.n_mlp, out_channels=3,
                                      use_noise=True,
                                      channel_max=self.channel_max)
        # const_hw (2, 4) is realized by slicing the loaded 4x4 const in the
        # converter, matching reference net.py:695.

    @property
    def n_latent(self) -> int:
        return self.gen.n_latent

    def __call__(self, zs, inject_index: int, train: bool = False,
                 crop_rng: Optional[jax.Array] = None,
                 noise_rng: Optional[jax.Array] = None) -> jnp.ndarray:
        z = jnp.concatenate(zs, axis=1)
        img = self.gen([z], inject_index=inject_index, noise_rng=noise_rng)
        # (B, 3, 256, 256) from full const → reference slices const instead;
        # crop to self.size either way
        if train and crop_rng is not None:
            ky, kx = jax.random.split(crop_rng)
            y0 = jax.random.randint(ky, (), 0, img.shape[2] - self.size + 1)
            x0 = jax.random.randint(kx, (), 0, img.shape[3] - self.size + 1)
            img = jax.lax.dynamic_slice(
                img, (0, 0, y0, x0),
                (img.shape[0], img.shape[1], self.size, self.size))
        else:
            c = img.shape[3] // 2
            img = img[:, :, :self.size, c - self.size // 2: c + self.size // 2]
        return img
