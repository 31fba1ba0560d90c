"""Bilinear 2-D grid sampling.

Matches ``torch.nn.functional.grid_sample(..., mode='bilinear',
padding_mode='zeros', align_corners=False)``, the semantics the reference's
tri-plane path depends on (reference: libraries/triplane/sampling.py:40 and
cuda_extension/TriplaneSampler_kernel.cu:40-41). Exact parity here is what
makes checkpoint-level output parity possible.

Two implementations, numerically identical (both torch-oracle tested):

* ``grid_sample_2d`` — quad-row formulation: the image is repacked so each
  row of a flat table carries the full 2x2 bilinear quad of one sample cell,
  making each sample ONE row gather plus arithmetic on the fetched row,
  instead of broadcasting the channel axis through the gather.
* ``grid_sample_2d_texelwise`` — the original 4-corner
  ``take_along_axis`` formulation, kept as a second oracle and for
  platforms/shapes where repacking is not worth it.
"""
from __future__ import annotations

import jax.numpy as jnp


def _corner_weights(grid_xy: jnp.ndarray, H: int, W: int):
    """Pixel coords → cell index (t, s) and 4 corner weights [A, B, C, D].

    Corner order: A=(y0,x0) B=(y0,x1) C=(y1,x0) D=(y1,x1); weights carry the
    out-of-bounds zeroing (align_corners=False, zeros padding).
    """
    x = (grid_xy[:, :, 0] + 1) * (W / 2) - 0.5  # (B, n)
    y = (grid_xy[:, :, 1] + 1) * (H / 2) - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = x - x0
    fy = y - y0
    in_x0 = (x0 >= 0) & (x0 <= W - 1)
    in_x1 = (x0 >= -1) & (x0 <= W - 2)
    in_y0 = (y0 >= 0) & (y0 <= H - 1)
    in_y1 = (y0 >= -1) & (y0 <= H - 2)
    s = jnp.clip(x0, -1, W - 1).astype(jnp.int32) + 1   # cell 0..W
    t = jnp.clip(y0, -1, H - 1).astype(jnp.int32) + 1   # cell 0..H
    cx0 = (1 - fx) * in_x0
    cx1 = fx * in_x1
    wy0 = (1 - fy) * in_y0
    wy1 = fy * in_y1
    wq = jnp.stack([cx0 * wy0, cx1 * wy0, cx0 * wy1, cx1 * wy1], axis=-1)
    return t, s, wq


def pack_quad_image(input: jnp.ndarray) -> jnp.ndarray:
    """(B, C, H, W) → (B, (H+1)*(W+1), 4C) quad-cell row table.

    Row (t, s) holds [A|B|C|D] with A=img[t-1,s-1], B=img[t-1,s],
    C=img[t,s-1], D=img[t,s] (zeros out of bounds).
    """
    B, C, H, W = input.shape
    ch = input.transpose(0, 2, 3, 1)                      # (B, H, W, C)
    P = jnp.pad(ch, ((0, 0), (1, 1), (1, 1), (0, 0)))
    quad = jnp.concatenate(
        [P[:, :H + 1, :W + 1], P[:, :H + 1, 1:],
         P[:, 1:, :W + 1], P[:, 1:, 1:]], axis=-1)        # (B,H+1,W+1,4C)
    return quad.reshape(B, (H + 1) * (W + 1), 4 * C)


def grid_sample_2d(input: jnp.ndarray, grid_xy: jnp.ndarray) -> jnp.ndarray:
    """Bilinear sample of ``input`` (B, C, H, W) at ``grid_xy`` (B, n, 2).

    ``grid_xy[..., 0]`` is x (width axis), ``grid_xy[..., 1]`` is y (height),
    both normalized to [-1, 1]; align_corners=False, zeros padding.

    Returns (B, C, n).
    """
    B, C, H, W = input.shape
    n = grid_xy.shape[1]
    table = pack_quad_image(input)                        # (B, R, 4C)
    R = table.shape[1]
    t, s, wq = _corner_weights(grid_xy, H, W)             # (B,n), (B,n,4)
    rows = t * (W + 1) + s
    flat_rows = (rows + (jnp.arange(B, dtype=jnp.int32) * R)[:, None]) \
        .reshape(-1)
    g = jnp.take(table.reshape(B * R, 4 * C), flat_rows, axis=0) \
        .reshape(B, n, 4, C)
    out = jnp.einsum("bnqc,bnq->bnc", g, wq.astype(g.dtype),
                     preferred_element_type=jnp.float32)
    return out.astype(input.dtype).transpose(0, 2, 1)


def _gather_hw(img_flat: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """img_flat: (B, C, H*W); idx: (B, n) → (B, C, n)."""
    B, C, _ = img_flat.shape
    idx = jnp.broadcast_to(idx[:, None, :], (B, C, idx.shape[-1]))
    return jnp.take_along_axis(img_flat, idx, axis=2)


def grid_sample_2d_texelwise(input: jnp.ndarray, grid_xy: jnp.ndarray) -> jnp.ndarray:
    """4-corner ``take_along_axis`` formulation (second oracle); same
    semantics and signature as ``grid_sample_2d``."""
    B, C, H, W = input.shape
    n = grid_xy.shape[1]
    x = (grid_xy[:, :, 0] + 1) * (W / 2) - 0.5  # (B, n) pixel coords
    y = (grid_xy[:, :, 1] + 1) * (H / 2) - 0.5

    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    x1 = x0 + 1
    y1 = y0 + 1

    wx1 = x - x0  # weight of x1
    wy1 = y - y0
    wx0 = 1 - wx1
    wy0 = 1 - wy1

    def corner_idx_and_mask(cx, cy):
        inb = (cx >= 0) & (cx <= W - 1) & (cy >= 0) & (cy <= H - 1)
        ix = jnp.clip(cx, 0, W - 1).astype(jnp.int32)
        iy = jnp.clip(cy, 0, H - 1).astype(jnp.int32)
        return iy * W + ix, inb

    img_flat = input.reshape(B, C, H * W)
    out = jnp.zeros((B, C, n), input.dtype)
    for cx, cy, w in ((x0, y0, wx0 * wy0), (x1, y0, wx1 * wy0),
                      (x0, y1, wx0 * wy1), (x1, y1, wx1 * wy1)):
        idx, inb = corner_idx_and_mask(cx, cy)
        val = _gather_hw(img_flat, idx)
        out = out + val * (w * inb)[:, None, :].astype(input.dtype)
    return out
