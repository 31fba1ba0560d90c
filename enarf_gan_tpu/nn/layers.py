"""Equalized-LR and modulated layers (on nn/module.py).

Numerics match the reference's custom StyleGAN2 primitives
(reference: libraries/custom_stylegan2/net.py:30-320):

* equalized learning rate — params init ~ N(0,1)/lr_mul, scaled at runtime by
  ``lr_mul / sqrt(fan_in)``;
* fused bias + LeakyReLU(0.2) * sqrt(2);
* per-sample modulated 1x1 conv over point clouds, demodulated by L2 weight
  row normalization (net.py:230-254).

All 1x1 "convs" over (B, C, n) point batches are einsums — matmuls with
the huge n axis minor. Per-sample modulation uses the
input-scaling formulation instead of the reference's batch-grouped-conv
trick, which is algebraically identical and avoids materializing B copies of
the weights.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from enarf_gan_tpu.nn import module as nn

# Matmul precision: None defers to jax_default_matmul_precision (a float32
# matmul may run in TF32 on a GPU; tests pin "float32" for golden parity).
_MATMUL_PREC = None


def fused_leaky_relu(x: jnp.ndarray, bias: Optional[jnp.ndarray] = None,
                     negative_slope: float = 0.2, scale: float = 2 ** 0.5) -> jnp.ndarray:
    """bias + LeakyReLU * sqrt(2) (reference stylegan2 op/fused_act)."""
    if bias is not None:
        # bias broadcasts over all non-channel axes; channel axis is 1 for
        # convs ((B, C, ...)) and -1 for linear layers ((B, C)).
        if x.ndim == 2:
            x = x + bias[None, :]
        else:
            shape = [1, -1] + [1] * (x.ndim - 2)
            x = x + bias.reshape(shape)
    return jax.nn.leaky_relu(x, negative_slope) * scale


def pixel_norm(x: jnp.ndarray, axis: int = 1, eps: float = 1e-8) -> jnp.ndarray:
    """x * rsqrt(mean(x^2)) (reference stylegan2 PixelNorm)."""
    return x * jax.lax.rsqrt(jnp.mean(x ** 2, axis=axis, keepdims=True) + eps)


def _normal_init(lr_mul: float = 1.0):
    def init(key, shape, dtype=jnp.float32):
        return jax.random.normal(key, shape, dtype) / lr_mul
    return init


class EqualLinear(nn.Module):
    """Equalized linear layer (reference net.py:128-179)."""
    out_dim: int
    use_bias: bool = True
    bias_init: float = 0.0
    lr_mul: float = 1.0
    activation: bool = False  # fused leaky-relu

    @nn.compact
    def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
        in_dim = x.shape[-1]
        w = self.param("weight", _normal_init(self.lr_mul), (self.out_dim, in_dim))
        scale = self.lr_mul / math.sqrt(in_dim)
        b = None
        if self.use_bias:
            b = self.param("bias", nn.initializers.constant(self.bias_init),
                           (self.out_dim,)) * self.lr_mul
        y = jnp.einsum("...i,oi->...o", x, w * scale, precision=_MATMUL_PREC)
        if self.activation:
            return fused_leaky_relu(y, b)
        if b is not None:
            y = y + b
        return y


class EqualConv1d(nn.Module):
    """Equalized grouped 1x1 conv over (B, C, n) (reference net.py:70-119).

    Only kernel_size=1 is used anywhere in the framework; grouped weights are
    kept as (groups, out_per, in_per) and applied as a grouped einsum.
    """
    out_channels: int
    groups: int = 1
    use_bias: bool = True
    bias_init: float = 0.0
    lr_mul: float = 1.0

    @nn.compact
    def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
        B, C, n = x.shape
        g = self.groups
        in_per, out_per = C // g, self.out_channels // g
        w = self.param("weight", _normal_init(self.lr_mul), (g, out_per, in_per))
        # reference scale: 1/sqrt(in_channel/groups * k) * lr_mul  (c=w=1, k=1)
        scale = self.lr_mul / math.sqrt(in_per)
        y = jnp.einsum("bgin,goi->bgon", x.reshape(B, g, in_per, n), w * scale,
                       precision=_MATMUL_PREC).reshape(B, self.out_channels, n)
        if self.use_bias:
            b = self.param("bias", nn.initializers.constant(self.bias_init),
                           (self.out_channels,))
            y = y + b[None, :, None]
        return y


class EqualConv2d(nn.Module):
    """Equalized 2-D conv over (B, C, H, W) (reference net.py:30-61)."""
    out_channels: int
    kernel_size: int = 3
    stride: int = 1
    padding: int = 0
    use_bias: bool = True

    @nn.compact
    def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
        C = x.shape[1]
        k = self.kernel_size
        w = self.param("weight", _normal_init(), (self.out_channels, C, k, k))
        scale = 1 / math.sqrt(C * k * k)
        y = jax.lax.conv_general_dilated(
            x, w * scale, (self.stride, self.stride),
            ((self.padding, self.padding), (self.padding, self.padding)),
            dimension_numbers=("NCHW", "OIHW", "NCHW"), precision=_MATMUL_PREC)
        if self.use_bias:
            b = self.param("bias", nn.initializers.zeros, (self.out_channels,))
            y = y + b[None, :, None, None]
        return y


class ModulatedConv1d(nn.Module):
    """Per-sample style-modulated grouped 1x1 conv over (B, C, n).

    Matches reference net.py:194-254: style → per-in-channel scale (EqualLinear
    bias_init=1); demodulation normalizes each output row of the modulated
    weight to unit L2 norm (F.normalize semantics, eps=1e-12).
    """
    out_channels: int
    style_dim: int
    groups: int = 1
    demodulate: bool = True

    @nn.compact
    def __call__(self, x: jnp.ndarray, style: jnp.ndarray) -> jnp.ndarray:
        B, C, n = x.shape
        g = self.groups
        in_per, out_per = C // g, self.out_channels // g
        scale = 1 / math.sqrt(C)  # reference: fan_in = in_channel * k**2
        w = self.param("weight", _normal_init(), (g, out_per, in_per))
        s = EqualLinear(C, bias_init=1.0, name="modulation")(style)  # (B, C)
        s = s.reshape(B, g, 1, in_per)
        wmod = (w * scale)[None] * s  # (B, g, out_per, in_per)
        if self.demodulate:
            norm = jnp.sqrt(jnp.sum(wmod ** 2, axis=3, keepdims=True))
            wmod = wmod / jnp.maximum(norm, 1e-12)
        y = jnp.einsum("bgin,bgoi->bgon", x.reshape(B, g, in_per, n), wmod,
                       precision=_MATMUL_PREC)
        return y.reshape(B, self.out_channels, n)


class StyledConv1d(nn.Module):
    """ModulatedConv1d + bias + LeakyReLU(0.2)*sqrt(2), no noise.

    Matches the reference StyledConv1d alias (libraries/NeRF/utils.py:8-10 →
    custom_stylegan2 StyledConv with conv_1d=True, use_noise=False).
    """
    out_channels: int
    style_dim: int
    groups: int = 1

    @nn.compact
    def __call__(self, x: jnp.ndarray, style: jnp.ndarray) -> jnp.ndarray:
        y = ModulatedConv1d(self.out_channels, self.style_dim, self.groups,
                            name="conv")(x, style)
        b = self.param("bias", nn.initializers.zeros, (self.out_channels,))
        y = y + b[None, :, None]
        return jax.nn.leaky_relu(y, 0.2) * 2 ** 0.5


class StyledMLP(nn.Module):
    """Stack of StyledConv1d (reference libraries/NeRF/net.py:10-27)."""
    hidden_dim: int
    out_dim: int
    style_dim: int = 512
    num_layers: int = 3

    @nn.compact
    def __call__(self, x: jnp.ndarray, z: jnp.ndarray) -> jnp.ndarray:
        h = StyledConv1d(self.hidden_dim, self.style_dim)(x, z)
        for _ in range(self.num_layers - 2):
            h = StyledConv1d(self.hidden_dim, self.style_dim)(h, z)
        return StyledConv1d(self.out_dim, self.style_dim)(h, z)


class MLP(nn.Module):
    """EqualConv1d stack with skip concatenations (reference NeRF/net.py:30-51).

    Note: the reference applies NO nonlinearity between layers — parity is
    kept deliberately (skips still make depth meaningful for optimization).
    """
    hidden_dim: int
    out_dim: int
    num_layers: int = 3
    skips: Tuple[int, ...] = ()

    @nn.compact
    def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
        h = EqualConv1d(self.hidden_dim)(x)
        for i in range(1, self.num_layers - 1):
            if i in self.skips:
                h = jnp.concatenate([h, x], axis=1)
            h = EqualConv1d(self.hidden_dim)(h)
        if (self.num_layers - 1) in self.skips:
            h = jnp.concatenate([h, x], axis=1)
        return EqualConv1d(self.out_dim)(h)


class GroupedConv1dReLUSelector(nn.Module):
    """Per-bone selector MLP: grouped conv → ReLU → grouped conv.

    Reference models/narf.py:305-311 (plain torch Conv1d version) and
    :65-69 (EqualConv1d version) — both are per-bone two-layer heads over the
    multi-part PE; we use the equalized variant for both.
    """
    num_bone: int
    hidden_per_bone: int = 10

    @nn.compact
    def __call__(self, encoded_p: jnp.ndarray) -> jnp.ndarray:
        h = EqualConv1d(self.hidden_per_bone * self.num_bone,
                        groups=self.num_bone)(encoded_p)
        h = jax.nn.relu(h)
        return EqualConv1d(self.num_bone, groups=self.num_bone)(h)
