"""ENARF-GAN generation demo (mirrors reference ENARF_GAN_demo.py).

Samples z, renders pose-conditioned humans (optionally with mesh extraction),
saves PNGs.
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
                        default="configs/enarfgan_demo/default.yml")
    parser.add_argument("--truncation", type=float, default=0.4)
    parser.add_argument("--num_samples", type=int, default=10)
    parser.add_argument("--black_bg", action="store_true")
    parser.add_argument("--mesh", action="store_true",
                        help="also extract + rasterize a mesh per sample")
    parser.add_argument("--mesh_voxel_size", type=float, default=0.003,
                        help="marching-tetrahedra voxel size (reference "
                             "mesh_rendering.py:52 voxel 3mm)")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    import jax
    import jax.numpy as jnp
    from enarf_gan_tpu.config import yaml_config
    from enarf_gan_tpu.data.cache import load_sample_data
    from enarf_gan_tpu.geometry.smpl import SMPL_PARENTS
    from enarf_gan_tpu.models.generator import register_canonical_pose
    from enarf_gan_tpu.training import gan, checkpoint as ckpt
    from enarf_gan_tpu.utils.logging import save_img_grid
    from PIL import Image

    config = yaml_config(args.config, args.default_config)
    size = config.dataset.image_size
    canonical_pose = np.load(config.get("canonical_pose_path",
                                        "smpl_data/neutral_canonical.npy"))
    gen, dis = gan.build_models(config, 24, SMPL_PARENTS)

    sample_path = config.sample_path
    for cand in (os.path.join(sample_path, "sample_data.pickle"),
                 os.path.join(sample_path, "sample_data.npz")):
        if os.path.exists(cand):
            samples = load_sample_data(cand)
            break
    else:
        raise FileNotFoundError(f"no sample_data under {sample_path}")

    rng = jax.random.PRNGKey(args.seed)
    first = samples[0]
    sample_batch = {
        "pose_to_camera": np.asarray(first["pose_to_camera"], np.float32)[None],
        "pose_to_world": np.asarray(first["pose_to_world"], np.float32)[None],
        "bone_length": np.asarray(first["bone_length"], np.float32)[None],
        "intrinsics": np.asarray(first["intrinsics"], np.float32)[None],
    }
    state, _, _ = gan.init_gan_state(config, gen, dis, canonical_pose, rng,
                                     sample_batch)
    out_dir = os.path.join(config.out_root, "result", config.out)
    snap = ckpt.latest_checkpoint(out_dir)
    if snap is None:
        raise Exception("model not loaded")
    template = {"iteration": 0, **state}
    state = ckpt.load_checkpoint(snap, template)
    gen_vars = state["gen"]

    save_dir = os.path.join(out_dir, "samples")
    os.makedirs(save_dir, exist_ok=True)
    z_dim = config.generator_params.z_dim

    @jax.jit
    def generate(gen_vars, f_rng, pose, world, bl, inv_K, z, psi):
        return gen.apply(gen_vars, f_rng, pose, world, bl, z, inv_K,
                         truncation_psi=psi,
                         black_bg_if_possible=args.black_bg)

    for idx in range(min(args.num_samples, len(samples))):
        batch = samples[idx]
        rng, z_rng, f_rng = jax.random.split(rng, 3)
        z = jax.random.normal(z_rng, (1, z_dim * 4))
        pose = jnp.asarray(batch["pose_to_camera"], jnp.float32)[None]
        world = jnp.asarray(batch["pose_to_world"], jnp.float32)[None]
        bl = jnp.asarray(batch["bone_length"], jnp.float32)[None]
        inv_K = jnp.linalg.inv(jnp.asarray(batch["intrinsics"], jnp.float32))[None]
        img, mask, aux = generate(gen_vars, f_rng, pose, world, bl, inv_K, z,
                                  args.truncation)
        arr = np.clip(np.asarray(img)[0].transpose(1, 2, 0) * 127.5 + 127.5,
                      0, 255).astype("uint8")
        Image.fromarray(arr).save(os.path.join(save_dir, f"img_{idx:0>4}.png"))
        marr = np.clip(np.asarray(mask)[0] * 255, 0, 255).astype("uint8")
        Image.fromarray(marr).save(os.path.join(save_dir, f"mask_{idx:0>4}.png"))

        if args.mesh:
            from enarf_gan_tpu.mesh.extract import gan_create_mesh
            from enarf_gan_tpu.mesh.raster import render_mesh_image
            verts, faces = gan_create_mesh(gen, gen_vars, pose, bl, z,
                                           voxel_size=args.mesh_voxel_size,
                                           truncation_psi=args.truncation)
            mesh_img = render_mesh_image(
                verts, faces, np.asarray(batch["intrinsics"], np.float32),
                img_size=size, render_size=512)
            Image.fromarray(mesh_img).save(
                os.path.join(save_dir, f"mesh_{idx:0>4}.png"))
    print(f"Images are saved to {save_dir}")


if __name__ == "__main__":
    main()
