"""enarf_gan_tpu — JAX framework for efficient geometry-aware neural
articulated representations (ENARF-GAN capabilities).

Re-designed from the reference PyTorch/CUDA implementation
(nogu-atsu/ENARF-GAN): pure functions over pytrees, static shapes + masking
instead of dynamic compaction, packed-table tri-plane gathers compiled by
XLA, and `jax.sharding` meshes for scale-out.

Layer map (mirrors reference SURVEY.md §1, rebuilt idiomatically):
  ops/       — numeric kernels: grid_sample, tri-plane gathers,
               custom-VJP activations, upfirdn2d
  nn/        — module layer, equalized/modulated layers, StyleGAN2
               synthesis/mapping/D
  geometry/  — pose math, SMPL forward kinematics, positional encodings
  nerf/      — ray sampling, frustum clipping, coarse/fine volume rendering
  models/    — TriPlaneNARF / MLPNARF / generators
  parallel/  — device-mesh + sharding helpers (DP over images, SP over rays)
  data/      — cache readers, pose datasets, bone-mask rasterizer, prefetch
  training/  — DSO + GAN train steps, losses, checkpointing
  eval_lib/  — PSNR/SSIM/LPIPS-style metrics, FID pipeline
  mesh/      — density-grid marching cubes + software rasterizer
"""

__version__ = "0.1.0"
