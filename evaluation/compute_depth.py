"""Disparity-MSE evaluation vs SURREAL GT inverse depth
(mirrors reference evaluation/compute_depth.py)."""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    from enarf_gan_tpu.utils.platform import setup_jax
    setup_jax()
    parser = argparse.ArgumentParser()
    parser.add_argument("--surreal_path", type=str, default="data/surreal")
    parser.add_argument("--config", type=str,
                        default="configs/enarfgan_train/SURREAL/config.yml")
    parser.add_argument("--default_config", type=str,
                        default="configs/enarfgan_train/default.yml")
    parser.add_argument("--num_workers", type=int, default=1)
    parser.add_argument("--iteration", type=int, default=-1)
    parser.add_argument("--truncation", type=float, default=1.0)
    parser.add_argument("--num_sample", type=int, default=10000)
    parser.add_argument("--batch_size", type=int, default=4)
    args = parser.parse_args()

    import jax
    import jax.numpy as jnp
    from enarf_gan_tpu.config import yaml_config, AttrDict
    from enarf_gan_tpu.data.datasets import SurrealPoseDepthDataset
    from enarf_gan_tpu.data.loader import DataLoader, infinite_batches
    from enarf_gan_tpu.training import gan, checkpoint as ckpt

    config = yaml_config(args.config, args.default_config,
                         num_workers=args.num_workers)
    size = config.dataset.image_size
    data_cfg = AttrDict({"data_root":
                         f"{args.surreal_path}/NARF_GAN_depth_cache"})
    ds = SurrealPoseDepthDataset(data_cfg, size=size)
    gen, dis = gan.build_models(config, ds.num_bone, ds.parents)

    rng = jax.random.PRNGKey(0)
    first = ds[0]
    sample_batch = {
        "pose_to_camera": first["pose_3d"][None],
        "pose_to_world": first["pose_3d_world"][None],
        "bone_length": first["bone_length"][None],
        "intrinsics": first["intrinsics"][None],
    }
    state, _, _ = gan.init_gan_state(config, gen, dis, ds.canonical_pose, rng,
                                     sample_batch)
    out_dir = os.path.join(config.out_root, "result", config.out)
    snap = ckpt.latest_checkpoint(out_dir) if args.iteration <= 0 else \
        os.path.join(out_dir, f"snapshot_{args.iteration}.npz")
    assert snap and os.path.exists(snap), "pretrained model is not loading"
    state = ckpt.load_checkpoint(snap, {"iteration": 0, **state})
    gen_vars = state["gen"]

    z_dim = config.generator_params.z_dim
    loader = infinite_batches(DataLoader(ds, args.batch_size, shuffle=True,
                                         drop_last=True, seed=0))
    se_sum, count = 0.0, 0
    for batch in loader:
        rng, z_rng, f_rng = jax.random.split(rng, 3)
        z = jax.random.normal(z_rng, (args.batch_size, z_dim * 4))
        img, mask, aux = gen.apply(
            gen_vars, f_rng, jnp.asarray(batch["pose_3d"]),
            jnp.asarray(batch["pose_3d_world"]),
            jnp.asarray(batch["bone_length"]), z,
            jnp.linalg.inv(jnp.asarray(batch["intrinsics"])),
            truncation_psi=args.truncation, return_disparity=True)
        gen_disp = np.asarray(aux["disparity"])
        gt = np.asarray(batch["img"])
        se_sum += ((gen_disp - gt) ** 2).sum()
        count += gt.size
        if count / (size * size) >= args.num_sample:
            break
    disp_mse = se_sum / count

    suffix = "" if args.truncation == 1 else f"_trunc{args.truncation}"
    path = os.path.join(out_dir, f"disparity_mse{suffix}.txt")
    with open(path, "w") as f:
        f.write(f"{disp_mse}")
    print(path, disp_mse)


if __name__ == "__main__":
    main()
