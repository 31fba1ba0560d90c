"""Zero-pose canonical joint transforms → {gender}_canonical.npy.

Port of reference data_preprocess/prepare_canonical_pose.py using this
framework's jnp SMPL forward kinematics and the .npz model format (see
convert_smpl_pkl.py). Hip-centers translations exactly like the reference.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--smpl_dir", type=str, default="smpl_data",
                        help="directory with SMPL_{GENDER}.npz models")
    parser.add_argument("--out_dir", type=str, default="smpl_data")
    args = parser.parse_args()

    import jax.numpy as jnp
    from enarf_gan_tpu.geometry.smpl import smpl_pose_transforms
    from enarf_gan_tpu.utils.platform import setup_jax
    setup_jax()

    for gender in ["MALE", "FEMALE", "NEUTRAL"]:
        path = os.path.join(args.smpl_dir, f"SMPL_{gender}.npz")
        if not os.path.exists(path):
            print(f"skip {gender}: {path} not found")
            continue
        model = np.load(path)
        poses = np.zeros((1, 24 * 3), np.float32)
        betas = np.zeros((1, model["shapedirs"].shape[-1]), np.float32)
        A = np.array(smpl_pose_transforms(
            jnp.asarray(betas), jnp.asarray(poses),
            jnp.asarray(model["v_template"]), jnp.asarray(model["shapedirs"]),
            jnp.asarray(model["J_regressor"]), model["parents"]))[0]
        A[:, :3, 3] -= A[[1, 2], :3, 3].mean(axis=0, keepdims=True)
        out = os.path.join(args.out_dir, f"{gender.lower()}_canonical.npy")
        np.save(out, A.astype(np.float32))
        print("wrote", out)


if __name__ == "__main__":
    main()
