"""ENARF-GAN adversarial training — jitted G/D/R1 steps + driver.

Re-designs reference train_ENARF_GAN.py:102-297:

* G step: gradient accumulation over ``n_accum_step`` micro-batches as a
  ``lax.scan`` inside one jit (reference python loop + repeated backward,
  train_ENARF_GAN.py:105-128);
* D step on fake (stop-grad) + real;
* lazy R1 every 16 iterations with x16 coefficient via jax.grad-of-jax.grad
  (reference :155-168);
* Adam(0, 0.99), lr scaled by batch/32 (reference :210-214);
* all steps take mesh-sharded batches — gradient all-reduce and the
  minibatch-std global batch semantics fall out of GSPMD.
"""
from __future__ import annotations

import os
import time
from functools import partial
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from enarf_gan_tpu.models.generator import (TriNARFGenerator,
                                            register_canonical_pose)
from enarf_gan_tpu.models.narf import NARFParams
from enarf_gan_tpu.nn.stylegan2 import Discriminator
from enarf_gan_tpu.training import checkpoint as ckpt
from enarf_gan_tpu.training.losses import (adv_loss_dis, adv_loss_gen,
                                           nerf_patch_loss, r1_penalty,
                                           triplane_l2_reg)
from enarf_gan_tpu.parallel.mesh import make_mesh, shard_batch
from enarf_gan_tpu.utils.logging import MetricsWriter, record_command, save_img_grid

R1_INTERVAL = 16  # reference train_ENARF_GAN.py:155


def build_models(config, num_bone: int, parent_id
                 ) -> Tuple[TriNARFGenerator, Discriminator]:
    gp = config.generator_params
    # the reference GAN generator never threads no_ray_direction — its
    # TriPlaneNARF keeps the view-independent default (reference
    # models/generator.py:29 vs :164 for DSO)
    params = NARFParams.from_config(gp.nerf_params, view_dependent=False)
    gen = TriNARFGenerator(
        nerf_params=params, size=config.dataset.image_size, num_bone=num_bone,
        parent_id=tuple(int(x) for x in parent_id), z_dim=int(gp.z_dim),
        crop_background=bool(gp.crop_background),
        pretrained_background=bool(gp.get("pretrained_background", False)),
        pretrained_bg_size=int(gp.get("pretrained_bg_size", 256)),
        background_ratio=float(gp.background_ratio),
        channel_max=int(gp.get("channel_max", 512)),
        train_ray_chunk=int(gp.get("train_ray_chunk", 4096)))
    dis = Discriminator(size=config.dataset.image_size,
                        minibatch_std=bool(config.discriminator_params.minibatch_std),
                        channel_max=int(config.discriminator_params.get(
                            "channel_max", 512)))
    return gen, dis


def init_gan_state(config, gen, dis, canonical_pose, rng, sample_batch):
    batchsize = config.dataset.bs
    z_dim = config.generator_params.z_dim
    rng, g_rng, d_rng, z_rng = jax.random.split(rng, 4)
    # the variables do not depend on the batch size: one compiled,
    # unchunked forward of the first sample creates them
    one = {k: jnp.asarray(sample_batch[k])[:1] for k in (
        "pose_to_camera", "pose_to_world", "bone_length", "intrinsics")}
    z = jax.random.normal(z_rng, (1, z_dim * 4))
    gen_vars = jax.jit(gen.init)(g_rng, g_rng, one["pose_to_camera"],
                                 one["pose_to_world"], one["bone_length"], z,
                                 jnp.linalg.inv(one["intrinsics"]))
    gen_vars = register_canonical_pose(
        gen_vars, canonical_pose, gen.nerf_params.origin_location,
        np.asarray(gen.parent_id))
    dummy = jnp.zeros((sample_batch["pose_to_camera"].shape[0], 3,
                       config.dataset.image_size, config.dataset.image_size))
    dis_vars = dis.init(d_rng, dummy)

    gen_lr = 1e-3 * batchsize / 32
    dis_lr = 2e-3 * batchsize / 32
    # non-finite grads are dropped in-graph (reference's try/except skip)
    gen_tx = optax.apply_if_finite(optax.adam(gen_lr, b1=0.0, b2=0.99), 100)
    dis_tx = optax.apply_if_finite(optax.adam(dis_lr, b1=0.0, b2=0.99), 100)
    return {
        "gen": gen_vars, "dis": dis_vars,
        "gen_opt": gen_tx.init(gen_vars["params"]),
        "dis_opt": dis_tx.init(dis_vars["params"]),
    }, gen_tx, dis_tx


def make_gan_steps(config, gen: TriNARFGenerator, dis: Discriminator,
                   gen_tx, dis_tx):
    n_accum = int(getattr(config, "n_accum_step", 1))
    adv_loss_type = config.loss.adv_loss_type
    bone_coef = float(config.loss.bone_guided_coef)
    r1_coef = float(config.loss.r1_loss_coef)
    reg_coef = float(config.loss.tri_plane_reg_coef)
    z_dim = int(config.generator_params.z_dim)
    bg_ratio = gen.background_ratio

    def gen_forward(gen_vars, rng, micro, train=True):
        z_rng, f_rng = jax.random.split(rng)
        z = jax.random.normal(
            z_rng, (micro["pose_to_camera"].shape[0], z_dim * 4))
        (img, mask, aux), mut = gen.apply(
            gen_vars, f_rng, micro["pose_to_camera"], micro["pose_to_world"],
            micro["bone_length"], z, micro["inv_intrinsics"], train=train,
            mutable=["stats"])
        return img, mask, aux, mut

    @jax.jit
    def g_step(state, rng, batch):
        """Accumulate generator grads over micro-batches (lax.scan)."""
        gen_vars = state["gen"]
        gen_params = gen_vars["params"]
        gen_rest = {k: v for k, v in gen_vars.items() if k != "params"}
        dis_vars = state["dis"]

        # reshape batch into (n_accum, micro_bs, ...)
        def split(x):
            return x.reshape((n_accum, x.shape[0] // n_accum) + x.shape[1:])

        micro_batches = jax.tree_util.tree_map(split, batch)
        keys = jax.random.split(rng, n_accum)

        def micro_loss(params, stats, key, micro):
            img, mask, aux, mut = gen_forward(
                {"params": params, "stats": stats["stats"],
                 **{k: v for k, v in gen_rest.items() if k != "stats"}},
                key, micro)
            dis_fake = dis.apply(dis_vars, img)
            loss = adv_loss_gen(dis_fake, adv_loss_type)
            loss_bone = nerf_patch_loss(mask, micro["bone_mask"], bg_ratio,
                                        coef=bone_coef)
            loss = loss + loss_bone
            if reg_coef > 0:
                loss = loss + triplane_l2_reg(aux["tri_plane_feature"]) * reg_coef
            aux_out = {"adv_loss_gen": adv_loss_gen(dis_fake, adv_loss_type),
                       "bone_loss": loss_bone, "img": img, "stats": mut["stats"]}
            return loss / n_accum, aux_out

        def scan_body(carry, inp):
            grads_acc, stats = carry
            key, micro = inp
            (loss, aux_out), grads = jax.value_and_grad(
                micro_loss, has_aux=True)(gen_params, stats, key, micro)
            grads_acc = jax.tree_util.tree_map(jnp.add, grads_acc, grads)
            return (grads_acc, {"stats": aux_out["stats"]}), \
                (loss, aux_out["adv_loss_gen"], aux_out["bone_loss"],
                 aux_out["img"])

        zero_grads = jax.tree_util.tree_map(jnp.zeros_like, gen_params)
        (grads, new_stats), (losses, adv_losses, bone_losses, imgs) = \
            jax.lax.scan(scan_body, (zero_grads, {"stats": gen_vars["stats"]}),
                         (keys, micro_batches))
        updates, gen_opt = gen_tx.update(grads, state["gen_opt"], gen_params)
        gen_params = optax.apply_updates(gen_params, updates)
        fake_img = imgs.reshape((-1,) + imgs.shape[2:])
        new_state = dict(state)
        new_state["gen"] = {"params": gen_params, **gen_rest,
                            "stats": new_stats["stats"]}
        new_state["gen_opt"] = gen_opt
        metrics = {"loss_gen": losses.sum(),
                   "adv_loss_gen": adv_losses.mean(),
                   "bone_loss": bone_losses.mean()}
        return new_state, fake_img, metrics

    @jax.jit
    def d_step(state, fake_img, real_img):
        dis_params = state["dis"]["params"]
        dis_rest = {k: v for k, v in state["dis"].items() if k != "params"}

        def loss_fn(params):
            dv = {"params": params, **dis_rest}
            dis_fake = dis.apply(dv, jax.lax.stop_gradient(fake_img))
            dis_real = dis.apply(dv, real_img)
            return adv_loss_dis(dis_real, dis_fake, adv_loss_type)

        loss, grads = jax.value_and_grad(loss_fn)(dis_params)
        updates, dis_opt = dis_tx.update(grads, state["dis_opt"], dis_params)
        new_state = dict(state)
        new_state["dis"] = {"params": optax.apply_updates(dis_params, updates),
                            **dis_rest}
        new_state["dis_opt"] = dis_opt
        return new_state, {"adv_loss_dis": loss}

    @jax.jit
    def r1_step(state, real_img):
        dis_params = state["dis"]["params"]
        dis_rest = {k: v for k, v in state["dis"].items() if k != "params"}

        def loss_fn(params):
            r1 = r1_penalty(lambda p, x: dis.apply({"params": p, **dis_rest}, x),
                            params, real_img)
            return 0.5 * r1 * R1_INTERVAL * r1_coef, r1

        (loss, r1), grads = jax.value_and_grad(loss_fn, has_aux=True)(dis_params)
        updates, dis_opt = dis_tx.update(grads, state["dis_opt"], dis_params)
        new_state = dict(state)
        new_state["dis"] = {"params": optax.apply_updates(dis_params, updates),
                            **dis_rest}
        new_state["dis_opt"] = dis_opt
        return new_state, {"r1_reg": r1}

    return g_step, d_step, r1_step


def prepare_gan_batch(img_batch, pose_batch, mesh=None):
    out = {
        "real_img": img_batch["img"],
        "bone_mask": pose_batch["bone_mask"],
        "pose_to_camera": pose_batch["pose_to_camera"],
        "bone_length": pose_batch["bone_length"],
        "pose_to_world": pose_batch["pose_to_world"],
        "inv_intrinsics": np.linalg.inv(pose_batch["intrinsics"]),
    }
    if mesh is not None:
        return shard_batch(mesh, out)
    return {k: jnp.asarray(v) for k, v in out.items()}


def train_loop(config, gen, dis, datasets, loaders, canonical_pose,
               max_iterations: Optional[int] = None, use_mesh: bool = False,
               verbose: bool = True):
    """Reference train_ENARF_GAN.py:173-297, functional."""
    out_dir = os.path.join(config.out_root, "result", config.out)
    os.makedirs(out_dir, exist_ok=True)
    record_command(out_dir)
    writer = MetricsWriter(os.path.join(config.out_root, "runs", config.out))

    loader_img, loader_pose = loaders
    rng = jax.random.PRNGKey(getattr(config, "seed", 0))
    rng, init_rng = jax.random.split(rng)
    mesh = make_mesh() if use_mesh else None

    first_pose = next(iter(loader_pose))
    state, gen_tx, dis_tx = init_gan_state(config, gen, dis, canonical_pose,
                                           init_rng, first_pose)
    iteration = 0
    if getattr(config, "resume", None) or getattr(config, "resume_latest", False):
        path = os.path.join(out_dir, "snapshot_latest.npz") \
            if config.resume_latest else config.resume
        if path and os.path.exists(path):
            template = {"iteration": 0, **state}
            loaded = ckpt.load_checkpoint(path, template)
            iteration = int(loaded.pop("iteration"))
            state = loaded

    g_step, d_step, r1_step = make_gan_steps(config, gen, dis, gen_tx, dis_tx)
    num_iter = max_iterations or config.num_iter
    batchsize = config.dataset.bs
    # reference cadences: losses printed every 10 iters, scalars logged
    # every 100 (train_ENARF_GAN.py:241)
    print_interval = int(config.get("print_interval", 10))
    tensorboard_interval = int(config.get("tensorboard_interval", 100))
    start = time.time()
    history = []
    pending = []  # device-side metric dicts awaiting bulk host fetch

    img_iter = iter(loader_img)
    pose_iter = iter(loader_pose)
    while iteration < num_iter:
        try:
            img_batch = next(img_iter)
        except StopIteration:
            img_iter = iter(loader_img)
            img_batch = next(img_iter)
        try:
            pose_batch = next(pose_iter)
        except StopIteration:
            pose_iter = iter(loader_pose)
            pose_batch = next(pose_iter)
        if img_batch["img"].shape[0] != batchsize or \
                pose_batch["bone_mask"].shape[0] != batchsize:
            continue

        batch = prepare_gan_batch(img_batch, pose_batch, mesh)
        real_img = batch.pop("real_img")
        rng, g_rng = jax.random.split(rng)
        state, fake_img, g_metrics = g_step(state, g_rng, batch)
        state, d_metrics = d_step(state, fake_img, real_img)
        metrics = {**g_metrics, **d_metrics}
        if iteration % R1_INTERVAL == 0:
            state, r1_metrics = r1_step(state, real_img)
            metrics.update(r1_metrics)
        # keep metrics on device; a per-step float() fetch would serialize
        # dispatch (one host round-trip per iteration). Flush at the print
        # cadence.
        pending.append(metrics)
        iteration += 1

        if (iteration % print_interval == 0
                or iteration % tensorboard_interval == 0
                or iteration >= num_iter):
            history.extend({k: float(v) for k, v in m.items()}
                           for m in jax.device_get(pending))
            pending.clear()
            if verbose and iteration % print_interval == 0:
                print(f"{iteration} iter, "
                      f"{(time.time() - start) / iteration:.3f} s/iter, "
                      f"G {history[-1]['loss_gen']:.3f} "
                      f"D {history[-1]['adv_loss_dis']:.3f}")
        if iteration % tensorboard_interval == 0:
            for k, v in history[-1].items():
                writer.scalar(iteration, v, k)
        if iteration == 10:
            with open(os.path.join(out_dir, "iter_10_succeeded.txt"), "w") as f:
                f.write("ok")
        if (iteration - 1) % 50 == 0:  # first iteration included (ref iter 0)
            save_img_grid(np.asarray(fake_img), os.path.join(
                out_dir, f"rgb_{iteration // 5000 * 5000}.png"))
            save_img_grid(np.asarray(real_img), os.path.join(out_dir, "real.png"))
            save_img_grid(np.asarray(batch["bone_mask"]) * 2 - 1,
                          os.path.join(out_dir, f"bone_{iteration // 5000 * 5000}.png"))
        # reference cadence is a fixed 200 (train_ENARF_GAN.py:278-294);
        # configurable here + final-iteration save so short runs (tests,
        # budget-bounded jobs) still leave a resumable/demo-able snapshot
        if (iteration % config.get("save_interval", 200) == 0
                or iteration >= num_iter):
            ckpt.save_checkpoint(out_dir, {"iteration": iteration, **state},
                                 iteration)
    writer.close()
    return state, history
