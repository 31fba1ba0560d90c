"""upfirdn2d — upsample / FIR filter / downsample, as one XLA conv.

Replacement for the reference's CUDA upfirdn2d
(reference: libraries/stylegan2_pytorch op/upfirdn2d, used by Blur/Upsample in
custom_stylegan2/net.py:14). Implemented with a single depthwise
``lax.conv_general_dilated``: lhs_dilation realizes the zero-insert upsample,
window stride realizes the downsample, and explicit padding is applied after
dilation — exactly the upfirdn operation order.

Only symmetric separable kernels ([1,3,3,1] outer product) are used by the
framework, so correlation == convolution and no kernel flip is needed.
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp
from jax import lax


def make_blur_kernel(k=(1, 3, 3, 1), upsample_factor: int = 1) -> np.ndarray:
    """Normalized 2-D FIR kernel; scaled by factor**2 when used after upsample."""
    k = np.asarray(k, np.float32)
    kernel = np.outer(k, k)
    kernel /= kernel.sum()
    if upsample_factor > 1:
        kernel = kernel * (upsample_factor ** 2)
    return kernel


def upfirdn2d(x: jnp.ndarray, kernel: np.ndarray, up: int = 1, down: int = 1,
              pad=(0, 0)) -> jnp.ndarray:
    """Apply upfirdn to (B, C, H, W). ``pad`` = (pad_before, pad_after) on both axes."""
    B, C, H, W = x.shape
    kh, kw = kernel.shape
    kern = jnp.asarray(kernel, x.dtype)[None, None].repeat(C, axis=0)  # (C,1,kh,kw)
    pad0, pad1 = int(pad[0]), int(pad[1])
    # torch's upfirdn zero-inserts to length in*up (up-1 trailing zeros);
    # lhs_dilation yields in*up-(up-1), so fold the difference into pad_after.
    pad1 = pad1 + (up - 1)
    return lax.conv_general_dilated(
        x, kern,
        window_strides=(down, down),
        padding=((pad0, pad1), (pad0, pad1)),
        lhs_dilation=(up, up),
        rhs_dilation=(1, 1),
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        feature_group_count=C,
    )


def blur(x: jnp.ndarray, kernel: np.ndarray, pad) -> jnp.ndarray:
    return upfirdn2d(x, kernel, up=1, down=1, pad=pad)


def upsample2x(x: jnp.ndarray, k=(1, 3, 3, 1)) -> jnp.ndarray:
    """2x FIR upsample (reference stylegan2 Upsample: p=len(k)-2, pad=(p+1)//2+1, p//2)."""
    kernel = make_blur_kernel(k, upsample_factor=2)
    p = kernel.shape[0] - 2
    return upfirdn2d(x, kernel, up=2, down=1, pad=((p + 1) // 2 + 1, p // 2))


def downsample2x(x: jnp.ndarray, k=(1, 3, 3, 1)) -> jnp.ndarray:
    """2x FIR downsample (p=len(k)-2, pad=((p+1)//2, p//2))."""
    kernel = make_blur_kernel(k)
    p = kernel.shape[0] - 2
    return upfirdn2d(x, kernel, up=1, down=2, pad=((p + 1) // 2, p // 2))
