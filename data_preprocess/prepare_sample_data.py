"""Extract demo sample_data from a dataset cache.

Generic replacement for the per-dataset prepare_sample_data.py scripts in the
reference: takes N samples (pose, bone_length, intrinsics) from any cache
directory and writes sample_data.npz for the demo CLIs.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_root", type=str, required=True)
    parser.add_argument("--out", type=str, required=True)
    parser.add_argument("--num", type=int, default=20)
    parser.add_argument("--stride", type=int, default=1)
    args = parser.parse_args(argv)

    from enarf_gan_tpu.data.cache import load_cache
    from enarf_gan_tpu.data.datasets import SMPL_PARENTS

    data = load_cache(args.data_root)
    smpl_pose = np.asarray(data["smpl_pose"])
    intr = np.asarray(data["camera_intrinsic"])
    n = len(smpl_pose)
    idx = np.arange(0, n, args.stride)[:args.num]

    pose_world = smpl_pose[idx]
    if "camera_rotation" in data:
        extr = np.tile(np.eye(4, dtype=np.float64), (len(idx), 1, 1))
        extr[:, :3, :3] = np.asarray(data["camera_rotation"])[idx]
        extr[:, :3, 3:] = np.asarray(data["camera_translation"])[idx]
        pose_cam = np.matmul(extr[:, None], pose_world)
    else:
        pose_cam = pose_world

    coord = pose_world[:, :, :3, 3]
    bl = np.linalg.norm(coord[:, 1:] - coord[:, SMPL_PARENTS[1:]],
                        axis=2)[:, :, None]

    os.makedirs(args.out, exist_ok=True)
    np.savez(os.path.join(args.out, "sample_data.npz"),
             pose_3d=pose_cam.astype(np.float32),
             pose_to_camera=pose_cam.astype(np.float32),
             pose_to_world=pose_world.astype(np.float32),
             bone_length=bl.astype(np.float32),
             intrinsics=intr[idx].astype(np.float32))
    print("wrote", os.path.join(args.out, "sample_data.npz"), len(idx), "samples")


if __name__ == "__main__":
    main()
