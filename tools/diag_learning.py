"""Diagnose a blank-render training failure of the DSO overfit gates.

Three stages, each isolating one link of the chain the overfit gate needs:

A. GEOMETRY — render the fixture scene with a *forced* density field
   (constant density inside any bone cube, constant color). If the rendered
   mask does not cover the GT mask, the fixture camera/pose/frustum geometry
   is misaligned and no optimizer can fix it.
B. LEARNING DYNAMICS — run a short instrumented training: per-K-iters log
   loss terms, rendered-mask mean at GT-fg vs GT-bg rays, fine-density
   stats, and gradient norms through the density head.
C. QUALITY — validate PSNR vs. the blank-render floor computed on the same
   fixture (the degenerate baseline every gate must beat).

Runs on the CPU. Usage:
    python tools/diag_learning.py [--size 32] [--iters 300] [--tile 0]
"""
from __future__ import annotations

import argparse
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"

import jax
import jax.numpy as jnp
import numpy as np
import optax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from enarf_gan_tpu.config import AttrDict
from enarf_gan_tpu.data.fixtures import make_synthetic_human_cache
from enarf_gan_tpu.data.datasets import SSODataset
from enarf_gan_tpu.data.loader import DataLoader
from enarf_gan_tpu.nerf.rendering import render_entire_img
from enarf_gan_tpu.training import dso
from enarf_gan_tpu.training.losses import photometric_loss, gather_pixels
from enarf_gan_tpu.eval_lib.metrics import psnr as psnr_fn


def quality_config(root, out_root, size, iters, tile_patch, lr=0.02):
    cfg = AttrDict({
        "out_root": out_root, "out": f"diag_dso_{tile_patch}",
        "dataset": {"bs": 1, "image_size": size, "bg_color": -1,
                    "num_workers": 1,
                    "train": {"data_root": root, "n_frames": 1}},
        "generator_params": {
            "use_triplane": True, "ray_batchsize": 1024,
            "nerf_params": {
                "w_dim": 64,
                "hidden_size": 32, "Nc": 12, "Nf": 16,
                "no_ray_direction": True,
                "origin_location": "center_fixed", "coordinate_scale": 3,
                "render_bs": 1024, "model_type": "narf",
                "multiply_density_with_triplane_wieght": False,
                "clamp_mask": False, "constant_triplane": False,
                "constant_trimask": False, "selector_mlp": False,
                "deformation_field": True, "no_selector": False,
                "time_conditional": True, "pose_conditional": False,
                "constant_trimask_lr_mul": 1, "tri_plane_size": 32},
        },
        "loss": {"color_coef": 1, "mask_coef": 1, "nerf_loss_type": "mse"},
        "num_iter": iters, "lr": lr, "scheduler_gamma": 0.99995,
        "val_interval": 10 ** 6, "print_interval": 10 ** 6,
        "tensorboard_interval": 10 ** 6, "save_interval": 10 ** 6,
        "resume": None, "resume_latest": False,
    })
    if tile_patch:
        cfg.generator_params.nerf_params.tile_patch = tile_patch
        cfg.generator_params.nerf_params.plane_sample_dtype = "bfloat16"
        cfg.generator_params.nerf_params.tile_coarse_corners = True
    return cfg


def stage_a_geometry(gen, variables, item, size):
    """Forced-density render: is the scene geometry even visible?"""
    pose_3d = jnp.asarray(item["pose_3d"][None])
    inv_K = jnp.linalg.inv(jnp.asarray(item["intrinsics"]))[None]
    bone_length = jnp.asarray(item["bone_length"][None])
    pose_t, bl_t = gen.apply(variables, pose_3d, bone_length,
                             method="transform_pose")

    def forced_fn(points, ray_dir, pose_scaled):
        R = pose_scaled[:, :, :3, :3]
        t = pose_scaled[:, :, :3, 3:]
        local = jnp.einsum("bkij,bkjn->bkin", jnp.swapaxes(R, -1, -2),
                           points[:, None] - t)
        valid = (jnp.abs(local) <= 1).all(axis=2).any(axis=1)  # (B, n)
        density = valid[:, None].astype(jnp.float32) * 5.0
        color = jnp.full(points.shape, 0.57, jnp.float32)
        return density, color

    cfg = gen.render_cfg()
    color, mask, disp = render_entire_img(
        jax.random.PRNGKey(0), forced_fn, pose_t, inv_K, cfg, size,
        ray_batchsize=1024)
    mask = np.asarray(mask)
    gt_mask = np.asarray(item["mask"])
    fg = gt_mask > 0.5
    rendered_fg = mask > 0.5
    cover = (rendered_fg & fg).sum() / max(fg.sum(), 1)
    print(f"[A] GT fg fraction          : {fg.mean():.4f}")
    print(f"[A] forced-render fg frac   : {rendered_fg.mean():.4f}")
    print(f"[A] coverage of GT fg       : {cover:.4f}  (want ~1.0)")
    print(f"[A] forced mask mean        : {mask.mean():.4f} max {mask.max():.4f}")
    return cover


def make_diag_step(gen, tx, loss_cfg, bg_color):
    loss_type = loss_cfg.nerf_loss_type
    color_coef = float(loss_cfg.color_coef)
    mask_coef = float(loss_cfg.mask_coef)

    @jax.jit
    def step(variables, opt_state, rng, batch):
        params = variables["params"]
        rest = {k: v for k, v in variables.items() if k != "params"}

        def loss_fn(params):
            color, nerf_mask, ray_idx, aux = gen.apply(
                {"params": params, **rest}, rng, batch["pose_3d"],
                batch["camera_rotation"], batch["mask"], batch["frame_time"],
                batch["bone_length"], batch["inv_intrinsics"],
                background=bg_color)
            lc, lm = photometric_loss(ray_idx, color, nerf_mask, batch["img"],
                                      batch["mask"], loss_type, color_coef,
                                      mask_coef)
            B = batch["mask"].shape[0]
            gt_m = jnp.take_along_axis(batch["mask"].reshape(B, -1), ray_idx,
                                       axis=1)
            diag = {
                "fg_frac_sampled": gt_m.mean(),
                "mask_at_fg": (nerf_mask * gt_m).sum() / (gt_m.sum() + 1e-8),
                "mask_at_bg": (nerf_mask * (1 - gt_m)).sum()
                              / ((1 - gt_m).sum() + 1e-8),
                "fine_density_mean": aux["fine_density"].mean(),
                "fine_density_max": aux["fine_density"].max(),
            }
            return lc + lm, (lc, lm, diag)

        (loss, (lc, lm, diag)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        gnorm = optax.global_norm(grads)
        flat = jax.tree_util.tree_flatten_with_path(grads)[0]
        d_norms = [jnp.sqrt((v ** 2).sum()) for p, v in flat
                   if "density_fc" in jax.tree_util.keystr(p)]
        plane_norms = [jnp.sqrt((v ** 2).sum()) for p, v in flat
                       if "tri_plane" in jax.tree_util.keystr(p)]
        diag.update({"loss": loss, "lc": lc, "lm": lm, "gnorm": gnorm,
                     "g_density_fc": sum(d_norms) if d_norms else jnp.float32(-1),
                     "g_tri_plane": sum(plane_norms) if plane_norms
                     else jnp.float32(-1)})
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return {"params": params, **rest}, opt_state, diag

    return step


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=32)
    ap.add_argument("--iters", type=int, default=300)
    ap.add_argument("--tile", type=int, default=0)
    ap.add_argument("--lr", type=float, default=0.02)
    ap.add_argument("--log-every", type=int, default=20)
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        ".bench_work", "diag_learning"))
    args = ap.parse_args()

    root = os.path.join(args.out, f"synth{args.size}")
    if not os.path.exists(os.path.join(root, "cache.npz")):
        make_synthetic_human_cache(root, size=args.size, n_frames=1,
                                   n_camera=1)
    config = quality_config(root, args.out, args.size, args.iters, args.tile,
                            args.lr)
    ds = SSODataset(config.dataset.train, size=args.size,
                    return_bone_params=True, return_mask=True,
                    num_repeat_in_epoch=config.num_iter)
    loader = DataLoader(ds, 1, seed=0)
    gen = dso.build_generator(config, ds.num_bone, ds.parents)

    first = next(iter(loader))
    rng = jax.random.PRNGKey(0)
    rng, init_rng = jax.random.split(rng)
    variables, tx, opt_state = dso.init_state(
        config, gen, ds.canonical_pose, init_rng, dso.prepare_batch(first))

    item = ds[0]
    # blank-render floor: PSNR of constant bg_color frame vs GT
    gt_img = item["img"][None]
    blank = np.full_like(gt_img, config.dataset.bg_color)
    floor = psnr_fn(gt_img, blank)
    print(f"[C] blank-render PSNR floor : {float(floor):.3f} dB")

    stage_a_geometry(gen, variables, item, args.size)

    step = make_diag_step(gen, tx, config.loss, config.dataset.bg_color)
    it = 0
    while it < args.iters:
        for batch in loader:
            if it >= args.iters:
                break
            rng, k = jax.random.split(rng)
            variables, opt_state, diag = step(variables, opt_state, k,
                                              dso.prepare_batch(batch))
            it += 1
            if it % args.log_every == 0 or it == 1:
                d = jax.device_get(diag)
                print(f"[B] it {it:4d} loss {d['loss']:.4f} "
                      f"(c {d['lc']:.4f} m {d['lm']:.4f}) "
                      f"fg_sampled {d['fg_frac_sampled']:.3f} "
                      f"mask@fg {d['mask_at_fg']:.3f} "
                      f"mask@bg {d['mask_at_bg']:.3f} "
                      f"dens(mu/max) {d['fine_density_mean']:.3f}/"
                      f"{d['fine_density_max']:.1f} "
                      f"|g| {d['gnorm']:.2e} "
                      f"|g_dens| {d['g_density_fc']:.2e} "
                      f"|g_tp| {d['g_tri_plane']:.2e}")

    out = dso.validate(gen, variables, config, {"train": loader},
                       jax.random.PRNGKey(5), num_data=1)
    psnr_db = out["train"]["color_PSNR"]
    print(f"[C] final train PSNR        : {psnr_db:.3f} dB "
          f"(floor {float(floor):.3f})")


if __name__ == "__main__":
    main()
