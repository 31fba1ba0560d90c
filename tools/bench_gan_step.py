"""Time the jitted GAN G/D/R1 steps on one GPU.

Reference-scale geometry per image (128² = 16384 rays, Nc48/Nf64); batch,
accumulation and sampler from GAN_* env knobs. Synthetic data and outputs
go under ``<repo>/.bench_work``.
"""
from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    from enarf_gan_tpu.utils.platform import REPO_ROOT, require_gpu, setup_jax
    setup_jax()
    require_gpu()
    import jax
    import jax.numpy as jnp
    from enarf_gan_tpu.config import AttrDict
    from enarf_gan_tpu.data.fixtures import make_synthetic_human_cache
    from enarf_gan_tpu.data.datasets import HumanDataset, HumanPoseDataset
    from enarf_gan_tpu.training import gan
    from enarf_gan_tpu.training.gan import prepare_gan_batch

    bs = int(os.environ.get("GAN_BS", 4))
    size = int(os.environ.get("GAN_SIZE", 128))
    work = os.path.join(REPO_ROOT, ".bench_work")
    root = os.path.join(work, f"gan_synth_{size}")
    if not os.path.exists(os.path.join(root, "cache.npz")):
        make_synthetic_human_cache(root, size=size, n_frames=max(bs, 4),
                                   n_camera=2)
    config = AttrDict({
        "out_root": work, "out": "gan_bench",
        "dataset": {"bs": bs, "image_size": size,
                    "train": {"data_root": root}},
        "generator_params": {
            "z_dim": 256, "patch_size": 24, "background_ratio": 0.3,
            "use_triplane": True, "crop_background": True,
            "pretrained_background": False, "channel_max": 512,
            "train_ray_chunk": int(os.environ.get("GAN_RAY_CHUNK", 4096)),
            "nerf_params": {
                # GAN_PLANES/GAN_NC/GAN_NF shrink the graph for CPU smokes
                "w_dim": 512,
                "tri_plane_size": int(os.environ.get("GAN_PLANES", 256)),
                "hidden_size": 256,
                "Nc": int(os.environ.get("GAN_NC", 48)),
                "Nf": int(os.environ.get("GAN_NF", 64)),
                "no_ray_direction": False,
                "origin_location": "center_fixed", "coordinate_scale": 3,
                "plane_sample_dtype": "bfloat16",
                # patch-window fast path; GAN_TILED=0 for the exact path
                "tile_patch": int(os.environ.get("GAN_TILED", 4)),
            }},
        "discriminator_params": {"minibatch_std": True, "channel_max": 512},
        "loss": {"adv_loss_type": "ce", "bone_guided_coef": 10,
                 "r1_loss_coef": 10, "tri_plane_reg_coef": 0.001},
        "n_accum_step": int(os.environ.get("GAN_ACCUM", 4)), "num_iter": 10, "resume": None,
    })
    img_ds = HumanDataset(AttrDict({"data_root": root}), size=size,
                          num_repeat_in_epoch=1)
    pose_ds = HumanPoseDataset(size=size, data_root=root, num_repeat_in_epoch=1)
    gen, dis = gan.build_models(config, pose_ds.num_bone, pose_ds.parents)

    def stack(ds, keys):
        items = [ds[i % len(ds)] for i in range(bs)]
        return {k: np.stack([it[k] for it in items]) for k in keys}

    img_b = stack(img_ds, ["img"])
    pose_b = stack(pose_ds, ["bone_mask", "pose_to_camera", "bone_length",
                             "pose_to_world", "intrinsics"])
    batch = prepare_gan_batch(img_b, pose_b)
    rng = jax.random.PRNGKey(0)
    sample = {k: np.asarray(v)[:1] for k, v in pose_b.items()}
    state, gen_tx, dis_tx = gan.init_gan_state(config, gen, dis,
                                               pose_ds.canonical_pose, rng,
                                               sample)
    g_step, d_step, r1_step = gan.make_gan_steps(config, gen, dis, gen_tx,
                                                 dis_tx)

    def timed(fn, *args, iters=3):
        out = jax.block_until_ready(fn(*args))
        t0 = time.perf_counter()
        for _ in range(iters):
            jax.block_until_ready(fn(*args))
        return (time.perf_counter() - t0) / iters, out

    gb = {k: batch[k] for k in ("pose_to_camera", "pose_to_world",
                                "bone_length", "inv_intrinsics", "bone_mask")}
    t0 = time.perf_counter()
    s_g, (state2, fake, gm) = timed(lambda: g_step(state, rng, gb))
    print(f"G step (bs{bs}, {size}², n_accum {config.n_accum_step}): {s_g:.3f} s  "
          f"(first call incl compile {time.perf_counter()-t0:.0f}s)",
          flush=True)
    s_d, _ = timed(lambda: d_step(state2, fake, batch["real_img"]))
    print(f"D step: {s_d:.3f} s", flush=True)
    s_r, _ = timed(lambda: r1_step(state2, batch["real_img"]))
    print(f"R1 step: {s_r:.3f} s", flush=True)
    per_iter = s_g + s_d + s_r / 16
    print(f"amortized train iter (R1/16): {per_iter:.3f} s  -> "
          f"{bs * size * size / per_iter / 1e6:.3f} Mrays/s train", flush=True)


if __name__ == "__main__":
    main()
