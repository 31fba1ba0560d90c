"""Positional encodings and coordinate-frame utilities (pure jnp).

Numerically equivalent to the reference implementations
(reference: libraries/NeRF/utils.py:13-106) but with static shapes and no
in-place masking; suitable for use inside jit.

Conventions: point batches are laid out ``(B, C, n)`` with the large ``n``
axis last (minor), so elementwise work over millions of samples stays
contiguous.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp


def positional_encoding(x: jnp.ndarray, num_frequency: int, cos_first: bool = True,
                        cat_dim: int = 2) -> jnp.ndarray:
    """NeRF positional encoding of ``x`` with ``num_frequency`` octaves.

    Matches reference libraries/NeRF/utils.py:74-88 exactly, including both
    memory layouts:
      * ``cat_dim=2`` (default, cos first): output (B, dim*2L, n), dim-major —
        per input dim the block is [cos f0..f{L-1}, sin f0..f{L-1}].
      * ``cat_dim=1`` (sin first): output (B, 2L*dim, n), frequency-major —
        [sin f0 (all dims), .., sin f{L-1}, cos f0, .., cos f{L-1}].
    """
    bs, dim, n = x.shape
    freqs = (2.0 ** jnp.arange(num_frequency, dtype=x.dtype)) * jnp.pi
    if cat_dim == 2:
        xf = x[:, :, None, :] * freqs[None, None, :, None]  # (B, dim, L, n)
        parts = (jnp.cos(xf), jnp.sin(xf)) if cos_first else (jnp.sin(xf), jnp.cos(xf))
        enc = jnp.concatenate(parts, axis=2)  # (B, dim, 2L, n)
    elif cat_dim == 1:
        xf = x[:, None, :, :] * freqs[None, :, None, None]  # (B, L, dim, n)
        parts = (jnp.cos(xf), jnp.sin(xf)) if cos_first else (jnp.sin(xf), jnp.cos(xf))
        enc = jnp.concatenate(parts, axis=1)  # (B, 2L, dim, n)
    else:
        raise ValueError(f"unsupported cat_dim={cat_dim}")
    return enc.reshape(bs, -1, n)


def multi_part_positional_encoding(value: jnp.ndarray, num_frequency: int,
                                   num_bone: int) -> jnp.ndarray:
    """Per-bone positional encoding with out-of-cube masking.

    Matches reference libraries/NeRF/utils.py:46-71: encode (B, n_bone*d, n)
    bone-wise with sin-first frequency-major layout, then zero the whole
    encoding block of any bone whose input coordinate lies outside [-1, 1].
    """
    b, _, n = value.shape
    val = value.reshape(b * num_bone, -1, n)
    gamma = positional_encoding(val, num_frequency, cos_first=False, cat_dim=1)
    gamma = gamma.reshape(b, num_bone, -1, n)

    # bone is masked if ANY of its coordinates leaves [-1, 1]
    outside = (jnp.abs(val.reshape(b, num_bone, -1, n)) > 1).any(axis=2, keepdims=True)
    gamma = jnp.where(outside, 0.0, gamma)
    return gamma.reshape(b, -1, n)


def mip_nerf_positional_encoding(value: jnp.ndarray, diag_sigma: jnp.ndarray,
                                 num_frequency: int) -> jnp.ndarray:
    """Integrated PE of mip-NeRF (reference libraries/NeRF/utils.py:91-106)."""
    bs, dim, n = value.shape
    gamma = positional_encoding(value, num_frequency, cos_first=False, cat_dim=1)
    scales = (4.0 ** jnp.arange(num_frequency, dtype=value.dtype)) * jnp.pi
    sig = diag_sigma[:, None, :, :] * scales[None, :, None, None]  # (B, L, dim, n)
    sig = jnp.exp(-sig / 2)
    sig = jnp.concatenate([sig, sig], axis=1).reshape(bs, -1, n)
    return gamma * sig


def in_cube(p: jnp.ndarray) -> jnp.ndarray:
    """Whether positions lie inside the cube [-1, 1]^3.

    Matches reference libraries/NeRF/utils.py:35-43.
    ``p``: (B, 3, n) → (B, 1, n) bool; (B, groups*3, n) → (B, groups, n) bool.
    """
    if p.shape[1] == 3:
        return (jnp.abs(p) <= 1).all(axis=1, keepdims=True)
    b, c, n = p.shape
    return (jnp.abs(p.reshape(b, c // 3, 3, n)) <= 1).all(axis=2)


def to_local(points: jnp.ndarray, pose_to_camera: jnp.ndarray) -> jnp.ndarray:
    """Transform camera-frame points into each bone's local frame.

    Matches reference libraries/NeRF/utils.py:13-32: ``R^T (p - t)`` per bone.

    Args:
        points: (B, 3, n) camera-coordinate points.
        pose_to_camera: (B, n_bone, 4, 4) bone-to-camera transforms.
    Returns:
        (B, n_bone*3, n) local coordinates.
    """
    R = pose_to_camera[:, :, :3, :3]              # (B, n_bone, 3, 3)
    t = pose_to_camera[:, :, :3, 3:]              # (B, n_bone, 3, 1)
    local = jnp.einsum("bkij,bkjn->bkin", jnp.swapaxes(R, -1, -2),
                       points[:, None] - t,
                       precision=jax.lax.Precision.HIGHEST)       # (B, n_bone, 3, n)
    bs, n_bone, _, n = local.shape
    return local.reshape(bs, n_bone * 3, n)


def scalar_positional_encoding(x: jnp.ndarray, num_frequency: int) -> jnp.ndarray:
    """PE of a scalar batch (B,) → (B, 2L). Matches reference models/generator.py:181-190."""
    xf = x[:, None] * (2.0 ** jnp.arange(num_frequency, dtype=x.dtype)) * np.pi
    return jnp.concatenate([jnp.cos(xf), jnp.sin(xf)], axis=1)
