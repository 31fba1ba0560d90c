"""DSO full-image inference demo (mirrors reference DSO_demo.py).

Loads a trained snapshot + sample_data, renders each sample to PNG.
"""
import argparse
import os

import numpy as np


def main(argv=None):
    from enarf_gan_tpu.utils.platform import setup_jax
    setup_jax()
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--default_config", type=str,
                        default="configs/DSO_demo/default.yml")
    parser.add_argument("--render_bs", type=int, default=16384)
    args = parser.parse_args(argv)

    import jax
    import jax.numpy as jnp
    from enarf_gan_tpu.config import yaml_config
    from enarf_gan_tpu.data.cache import load_sample_data
    from enarf_gan_tpu.geometry.smpl import SMPL_PARENTS
    from enarf_gan_tpu.models.generator import make_dso_full_renderer
    from enarf_gan_tpu.training import dso, checkpoint as ckpt
    from PIL import Image

    config = yaml_config(args.config, args.default_config)
    size = config.dataset.image_size
    config.generator_params.nerf_params.render_bs = args.render_bs

    num_bone = 24
    parents = SMPL_PARENTS
    canonical_pose = np.load(config.get("canonical_pose_path",
                                        "smpl_data/neutral_canonical.npy"))
    gen = dso.build_generator(config, num_bone, parents)

    samples = load_sample_data(os.path.join(config.sample_path, "sample_data.pickle")
                               if os.path.exists(os.path.join(
                                   config.sample_path, "sample_data.pickle"))
                               else os.path.join(config.sample_path,
                                                 "sample_data.npz"))
    rng = jax.random.PRNGKey(0)
    first = samples[0]
    sample_batch = {
        "pose_3d": np.asarray(first["pose_3d"], np.float32)[None],
        "camera_rotation": np.eye(3, dtype=np.float32)[None],
        "mask": np.ones((1, size, size), np.float32),
        "frame_time": np.array([1.0], np.float32),
        "bone_length": np.asarray(first["bone_length"], np.float32)[None],
        "inv_intrinsics": np.linalg.inv(
            np.asarray(first["intrinsics"], np.float32))[None],
    }
    variables = dso.init_variables(gen, canonical_pose, rng, sample_batch)
    out_dir = os.path.join(config.out_root, "result", config.out)
    snap = ckpt.latest_checkpoint(out_dir)
    if snap is None:
        raise Exception("model not loaded")
    variables = ckpt.load_checkpoint(snap, {"gen": variables})["gen"]

    bg_color = config.dataset.bg_color
    frame_time = jnp.array([1.0], jnp.float32)
    save_dir = os.path.join(out_dir, "samples")
    os.makedirs(save_dir, exist_ok=True)
    renderer = make_dso_full_renderer(gen, size, ray_batchsize=args.render_bs)
    for idx, batch in enumerate(samples):
        pose = jnp.asarray(batch["pose_3d"], jnp.float32)[None]
        bl = jnp.asarray(batch["bone_length"], jnp.float32)[None]
        inv_K = jnp.linalg.inv(jnp.asarray(batch["intrinsics"], jnp.float32))[None]
        color, mask, _ = renderer(variables, jax.random.PRNGKey(idx), pose,
                                  inv_K, frame_time, bl, None)
        img = np.asarray(color) + bg_color * (1 - np.asarray(mask))
        img = np.clip(img.transpose(1, 2, 0) * 127.5 + 127.5, 0, 255).astype("uint8")
        Image.fromarray(img).save(os.path.join(save_dir, f"{idx:0>4}.png"))
    print(f"Images are saved to {save_dir}")


if __name__ == "__main__":
    main()
