"""DSO (dynamic scene overfitting) training — jitted steps + driver.

Re-designs reference train_DSO.py:173-333: one jitted train step
(forward render of a masked ray batch + photometric loss + Adam with
per-step exponential LR decay), data sharded over the mesh's ``data`` axis,
npz checkpoints, log.json metrics.
"""
from __future__ import annotations

import functools
import os
import time
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from enarf_gan_tpu.models.generator import (DSONARFGenerator,
                                            dso_render_entire_img,
                                            make_dso_full_renderer,
                                            register_canonical_pose)
from enarf_gan_tpu.models.narf import NARFParams
from enarf_gan_tpu.training import checkpoint as ckpt
from enarf_gan_tpu.training.losses import photometric_loss
from enarf_gan_tpu.eval_lib.metrics import psnr as psnr_fn, ssim as ssim_fn, mse
from enarf_gan_tpu.parallel.mesh import make_mesh, shard_batch, replicate
from enarf_gan_tpu.utils.logging import JsonLog, MetricsWriter, save_img_grid


def build_generator(config, num_bone: int, parent_id) -> DSONARFGenerator:
    gp = config.generator_params
    params = NARFParams.from_config(gp.nerf_params)
    return DSONARFGenerator(nerf_params=params, size=config.dataset.image_size,
                            num_bone=num_bone,
                            parent_id=tuple(int(x) for x in parent_id),
                            use_triplane=bool(gp.use_triplane),
                            ray_batchsize=int(gp.ray_batchsize))


def init_variables(gen: DSONARFGenerator, canonical_pose: np.ndarray,
                   rng: jax.Array, sample_batch: Dict[str, np.ndarray]):
    """Model variables with the canonical-pose buffers filled.

    The variables do not depend on the batch size, so one compiled forward
    of the first sample creates them.
    """
    one = {k: jnp.asarray(sample_batch[k])[:1] for k in (
        "pose_3d", "camera_rotation", "mask", "frame_time", "bone_length",
        "inv_intrinsics")}
    variables = jax.jit(gen.init)(
        rng, rng, one["pose_3d"], one["camera_rotation"], one["mask"],
        one["frame_time"], one["bone_length"], one["inv_intrinsics"])
    return register_canonical_pose(
        variables, canonical_pose, gen.nerf_params.origin_location,
        np.asarray(gen.parent_id))


def init_state(config, gen: DSONARFGenerator, canonical_pose: np.ndarray,
               rng: jax.Array, sample_batch: Dict[str, np.ndarray]):
    """Init variables + optimizer (reference train_DSO.py:188-207)."""
    variables = init_variables(gen, canonical_pose, rng, sample_batch)
    schedule = optax.exponential_decay(config.lr, transition_steps=1,
                                       decay_rate=config.scheduler_gamma) \
        if config.scheduler_gamma < 1 else config.lr
    # apply_if_finite = the reference's try/except iteration skip
    # (train_ENARF_GAN.py:261-268) done in-graph: non-finite grads are
    # dropped instead of corrupting the params.
    tx = optax.apply_if_finite(optax.adam(schedule, b1=0.9, b2=0.99), 100)
    opt_state = tx.init(variables["params"])
    return variables, tx, opt_state


def make_train_step(gen: DSONARFGenerator, tx, loss_cfg, bg_color: float,
                    n_accum: int = 1):
    """Jitted DSO step; ``n_accum`` > 1 scans micro-batches accumulating
    grads (reference train_ENARF_GAN.py:105-128's trick applied to DSO).

    The point is memory: the sampling tables are packed per batch sample
    inside the generator apply, so with micro-batches the tables for only
    ``bs / n_accum`` samples are live at once."""
    loss_type = loss_cfg.nerf_loss_type
    color_coef = float(loss_cfg.color_coef)
    mask_coef = float(loss_cfg.mask_coef)

    def micro_loss(params, rest, rng, micro):
        color, nerf_mask, ray_idx, _ = gen.apply(
            {"params": params, **rest}, rng, micro["pose_3d"],
            micro["camera_rotation"], micro["mask"], micro["frame_time"],
            micro["bone_length"], micro["inv_intrinsics"],
            background=bg_color)
        lc, lm = photometric_loss(ray_idx, color, nerf_mask, micro["img"],
                                  micro["mask"], loss_type, color_coef,
                                  mask_coef)
        return lc + lm, (lc, lm)

    @jax.jit
    def train_step(variables, opt_state, rng, batch):
        params = variables["params"]
        rest = {k: v for k, v in variables.items() if k != "params"}

        if n_accum <= 1:
            (loss, (lc, lm)), grads = jax.value_and_grad(
                micro_loss, has_aux=True)(params, rest, rng, batch)
        else:
            def split(x):
                return x.reshape((n_accum, x.shape[0] // n_accum)
                                 + x.shape[1:])

            micro_batches = jax.tree_util.tree_map(split, batch)
            keys = jax.random.split(rng, n_accum)

            def body(acc, inp):
                key, micro = inp
                (l, (lc, lm)), g = jax.value_and_grad(
                    micro_loss, has_aux=True)(params, rest, key, micro)
                acc = jax.tree_util.tree_map(jnp.add, acc, g)
                return acc, (l, lc, lm)

            zeros = jax.tree_util.tree_map(jnp.zeros_like, params)
            grads, (ls, lcs, lms) = jax.lax.scan(
                body, zeros, (keys, micro_batches))
            grads = jax.tree_util.tree_map(lambda g: g / n_accum, grads)
            loss, lc, lm = ls.mean(), lcs.mean(), lms.mean()

        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return {"params": params, **rest}, opt_state, \
            {"loss": loss, "loss_color": lc, "loss_mask": lm}

    return train_step


def prepare_batch(batch: Dict[str, np.ndarray], mesh=None) -> Dict[str, jnp.ndarray]:
    out = {
        "img": batch["img"], "mask": batch["mask"],
        "pose_3d": batch["pose_3d"], "frame_time": batch["frame_time"],
        "bone_length": batch["bone_length"],
        "camera_rotation": batch["camera_rotation"],
        "inv_intrinsics": np.linalg.inv(batch["intrinsics"]),
    }
    if mesh is not None:
        return shard_batch(mesh, out)
    return {k: jnp.asarray(v) for k, v in out.items()}


def validate(gen, variables, config, val_loaders, rng, iteration: int = 0,
             num_data: Optional[int] = None, crop: bool = False,
             metrics=("SSIM", "PSNR"), save_dir: Optional[str] = None,
             lpips_fn=None) -> Dict:
    """Full-image validation (reference train_DSO.py:75-170)."""
    size = config.dataset.image_size
    bg_color = config.dataset.bg_color
    renderer = make_dso_full_renderer(gen, size)  # jitted once, reused
    out = {}
    for key, loader in val_loaders.items():
        if num_data != 1 and key == "train":
            continue
        n_total = len(loader.dataset.imgs)
        n_eval = n_total if num_data is None else min(num_data, n_total)
        acc = {"color": 0.0, "mask": 0.0}
        acc.update({f"color_{m}": 0.0 for m in metrics})
        done = 0
        for i in range(n_eval):
            item = loader.dataset[i]
            img = item["img"][None]
            mask = item["mask"][None]
            # render the full frame (fixed shapes → one compile), crop on host
            color, gmask, _ = renderer(
                variables, rng, jnp.asarray(item["pose_3d"][None]),
                jnp.linalg.inv(jnp.asarray(item["intrinsics"]))[None],
                jnp.asarray(item["frame_time"][None]),
                jnp.asarray(item["bone_length"][None]),
                jnp.asarray(item["camera_rotation"][None]))
            color = np.asarray(color)[None]
            gmask = np.asarray(gmask)[None]
            if crop:
                ys, xs = np.where(item["mask"] > 0)
                if len(xs) == 0:
                    continue
                bbox = (int(xs.min()), int(ys.min()),
                        int(xs.max()), int(ys.max()))
                mask = mask[:, bbox[1]:bbox[3], bbox[0]:bbox[2]]
                img = img[:, :, bbox[1]:bbox[3], bbox[0]:bbox[2]]
                color = color[:, :, bbox[1]:bbox[3], bbox[0]:bbox[2]]
                gmask = gmask[:, bbox[1]:bbox[3], bbox[0]:bbox[2]]
            if np.isnan(color).any():
                print("NaN is detected")
            color = color + bg_color * (1 - gmask[:, None])
            acc["mask"] += mse(mask, gmask)
            acc["color"] += mse(img, color)
            for m in metrics:
                if m == "PSNR":
                    acc["color_PSNR"] += psnr_fn(img, color)
                elif m == "SSIM":
                    acc["color_SSIM"] += ssim_fn(img[0], color[0])
                elif m == "LPIPS" and lpips_fn is not None:
                    acc["color_LPIPS"] += float(lpips_fn(img, color))
            done += 1
            if save_dir and i == n_eval - 1:
                side = np.concatenate([color, img], axis=-1)
                save_img_grid(side, os.path.join(
                    save_dir, f"{key}_{iteration // 5000 * 5000}.png"))
        out[key] = {k: v / max(done, 1) for k, v in acc.items()}
    return out


def train_loop(config, gen, datasets, loaders, canonical_pose,
               max_iterations: Optional[int] = None, use_mesh: bool = False,
               verbose: bool = True):
    """Reference train_DSO.py train_func, functional-style.

    Returns final (variables, opt_state, log) — also used by the overfit
    smoke tests with ``max_iterations`` small.
    """
    out_dir = os.path.join(config.out_root, "result", config.out)
    os.makedirs(out_dir, exist_ok=True)
    writer = MetricsWriter(os.path.join(config.out_root, "runs", config.out))
    jlog = JsonLog(os.path.join(out_dir, "log.json"))

    train_loader, val_loaders = loaders
    rng = jax.random.PRNGKey(getattr(config, "seed", 0))
    rng, init_rng = jax.random.split(rng)
    first = next(iter(train_loader))
    mesh = make_mesh() if use_mesh else None
    variables, tx, opt_state = init_state(config, gen, canonical_pose,
                                          init_rng, prepare_batch(first))
    iteration = 0
    # resume
    if getattr(config, "resume", None) or getattr(config, "resume_latest", False):
        path = os.path.join(out_dir, "snapshot_latest.npz") \
            if config.resume_latest else config.resume
        if path and os.path.exists(path):
            template = {"iteration": 0, "gen": variables, "gen_opt": opt_state}
            loaded = ckpt.load_checkpoint(path, template)
            variables = loaded["gen"]
            iteration = int(loaded["iteration"])
            # optimizer state deliberately not restored (reference parity)

    train_step = make_train_step(gen, tx, config.loss, config.dataset.bg_color,
                                 n_accum=int(getattr(config, "n_accum_step", 1)))
    num_iter = max_iterations or config.num_iter
    start = time.time()
    accum_time = 0.0
    train_losses = {"color": 0.0, "mask": 0.0}
    history = []
    pending = []  # device-side metrics awaiting bulk host fetch
    flush_interval = max(1, min(int(config.print_interval),
                                int(config.tensorboard_interval)))

    while iteration < num_iter:
        for batch in train_loader:
            if iteration >= num_iter:
                break
            rng, step_rng = jax.random.split(rng)
            jbatch = prepare_batch(batch, mesh)
            variables, opt_state, metrics = train_step(variables, opt_state,
                                                       step_rng, jbatch)
            # metrics stay on device; fetching every step serializes dispatch.
            # Bulk-fetch at print_interval (reference cadence,
            # train_DSO.py:252-253) and at val/save boundaries.
            pending.append(metrics)
            iteration += 1
            flush_due = (iteration % flush_interval == 0
                         or iteration >= num_iter
                         or iteration % config.print_interval == 0
                         or iteration % config.tensorboard_interval == 0
                         or iteration % config.save_interval == 0
                         or iteration % config.val_interval == 0)
            if flush_due and pending:
                for m in jax.device_get(pending):
                    train_losses["color"] += float(m["loss_color"])
                    train_losses["mask"] += float(m["loss_mask"])
                    history.append(float(m["loss"]))
                pending.clear()
            if verbose and iteration % config.print_interval == 0:
                print(f"{iteration} iter, "
                      f"{(time.time() - start) / max(iteration, 1):.3f} s/iter, "
                      f"loss {history[-1]:.4f}")
            if iteration % config.tensorboard_interval == 0 and history:
                writer.scalar(iteration, history[-1], "gen")
            if iteration % config.save_interval == 0:
                ckpt.save_checkpoint(out_dir,
                                     {"iteration": iteration,
                                      "gen": variables, "gen_opt": opt_state},
                                     iteration)
            if iteration % config.val_interval == 0 and val_loaders:
                accum_time += time.time() - start
                rng, vrng = jax.random.split(rng)
                vloss = validate(gen, variables, config, val_loaders, vrng,
                                 iteration, num_data=1, save_dir=out_dir)
                entry = {"accumulated_train_time": accum_time,
                         "train_loss_color":
                             train_losses["color"] / config.val_interval,
                         "train_loss_mask":
                             train_losses["mask"] / config.val_interval}
                for k, metrics_d in vloss.items():
                    for m, v in metrics_d.items():
                        entry[f"val_loss_{k}_{m}"] = v
                jlog.update(iteration, entry)
                train_losses = {"color": 0.0, "mask": 0.0}
                start = time.time()
    writer.close()
    return variables, opt_state, history
