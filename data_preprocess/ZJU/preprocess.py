"""ZJU-MoCap preprocessing → native cache.npz.

Port of reference data_preprocess/ZJU/preprocess.py:17-128 on this
framework's SMPL FK and cache codec. Semantics preserved: annots.npy cameras
(T/1000), per-frame new_params SMPL with Rh/Th root transform, undistortion,
512² resize with intrinsics rebase, background-masked RGB + mask channel,
train / novel-view / novel-pose splits (interval 30 for test splits).
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import numpy as np

IMAGE_SIZE = 512


def smpl_forward(model, poses, betas):
    import jax.numpy as jnp
    from enarf_gan_tpu.geometry.smpl import smpl_pose_transforms
    from enarf_gan_tpu.utils.platform import setup_jax
    setup_jax()
    return np.asarray(smpl_pose_transforms(
        jnp.asarray(betas, jnp.float32),
        jnp.asarray(poses.reshape(1, -1), jnp.float32),
        jnp.asarray(model["v_template"]), jnp.asarray(model["shapedirs"]),
        jnp.asarray(model["J_regressor"]), model["parents"]))[0]


def read_annots(dir_path, person_id):
    annot = np.load(f"{dir_path}/CoreView_{person_id}/annots.npy",
                    allow_pickle=True)
    cams = annot[()]["cams"]
    K = np.array(cams["K"])
    R = np.array(cams["R"])
    T = np.array(cams["T"]) / 1000
    D = np.array(cams["D"])
    image_paths = annot[()]["ims"]
    return K, R, T, D, image_paths, len(K)


def save_cache(dir_path, write_path, smpl_model, person_id, n_frame, views,
               image_paths, K, R, T, D, prefix="train", start_frame_idx=0,
               interval=1):
    import cv2
    from enarf_gan_tpu.data.cache import save_cache_npz

    imgs, intr, rots, trans_l, poses, frame_ids = [], [], [], [], [], []
    for frame_id in range(start_frame_idx, start_frame_idx + n_frame, interval):
        smpl_idx = frame_id + 1 if person_id in ("313", "315") else frame_id
        param = np.load(
            f"{dir_path}/CoreView_{person_id}/new_params/{smpl_idx}.npy",
            allow_pickle=True)[()]
        pose_aa = param["poses"].reshape(1, 24, 3)
        shapes = np.asarray(param["shapes"], np.float32)
        trans = np.eye(4)
        trans[:3, :3] = cv2.Rodrigues(np.asarray(param["Rh"], np.float64))[0]
        trans[:3, 3] = param["Th"]
        pose = smpl_forward(smpl_model, pose_aa.astype(np.float32), shapes)
        pose_to_world = np.matmul(trans, pose)

        for view in views:
            img_path = image_paths[frame_id]["ims"][view]
            image = cv2.imread(f"{dir_path}/CoreView_{person_id}/{img_path}")
            image = cv2.undistort(image, K[view], D[view])
            mask = cv2.imread(
                f"{dir_path}/CoreView_{person_id}/mask/{img_path[:-3]}png")
            mask = cv2.undistort(mask, K[view], D[view])

            h = image.shape[0]
            image = cv2.resize(image, (IMAGE_SIZE, IMAGE_SIZE),
                               interpolation=cv2.INTER_AREA)
            mask = cv2.resize(mask, (IMAGE_SIZE, IMAGE_SIZE),
                              interpolation=cv2.INTER_NEAREST)[:, :, :1]
            K_new = K[view].copy()
            K_new[:2] *= IMAGE_SIZE / h
            image = image * (mask > 0)
            image = np.concatenate([image[:, :, ::-1],
                                    (mask > 0).astype("uint8") * 255], axis=-1)
            imgs.append(image.transpose(2, 0, 1).astype(np.uint8))
            intr.append(K_new.astype(np.float32))
            rots.append(R[view].astype(np.float32))
            trans_l.append(T[view].astype(np.float32))
            poses.append(pose_to_world.astype(np.float32))
            frame_ids.append(frame_id)

    out_dir = f"{write_path}/CoreView_{person_id}/{prefix}_cache_{n_frame}"
    save_cache_npz(out_dir, imgs=np.stack(imgs),
                   camera_intrinsic=np.stack(intr),
                   camera_rotation=np.stack(rots),
                   camera_translation=np.stack(trans_l).reshape(-1, 3, 1),
                   smpl_pose=np.stack(poses),
                   frame_id=np.array(frame_ids, np.int64))
    print("wrote", out_dir)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_path", type=str, required=True)
    parser.add_argument("--write_path", type=str, default="data/ZJU_DSO")
    parser.add_argument("--smpl_dir", type=str, default="smpl_data")
    # overrides for small runs / smoke fixtures (default: the reference's
    # shipped person configs, reference ZJU/preprocess.py main)
    parser.add_argument("--person_id", type=str, default=None)
    parser.add_argument("--n_train_frame", type=int, default=None)
    parser.add_argument("--n_test_frame", type=int, default=None)
    parser.add_argument("--training_views", type=str, default=None,
                        help="comma-separated view ids")
    args = parser.parse_args()

    model = dict(np.load(os.path.join(args.smpl_dir, "SMPL_NEUTRAL.npz")))
    configs = [
        {"person_id": "313", "n_train_frame": 1176, "n_test_frame": 294,
         "training_view": [0, 6, 12, 18]},
        {"person_id": "315", "n_train_frame": 1748, "n_test_frame": 437,
         "training_view": [0, 6, 12, 18]},
        {"person_id": "386", "n_train_frame": 516, "n_test_frame": 130,
         "training_view": [0, 6, 12, 18]},
    ]
    if args.person_id is not None:
        configs = [{
            "person_id": args.person_id,
            "n_train_frame": args.n_train_frame or 4,
            "n_test_frame": args.n_test_frame or 2,
            "training_view": [int(v) for v in
                              (args.training_views or "0").split(",")],
        }]
    for conf in configs:
        pid = conf["person_id"]
        K, R, T, D, image_paths, n_cam = read_annots(args.data_path, pid)
        train_views = conf["training_view"]
        test_views = [i for i in range(n_cam) if i not in train_views]
        save_cache(args.data_path, args.write_path, model, pid,
                   conf["n_train_frame"], train_views, image_paths, K, R, T, D,
                   prefix="train")
        save_cache(args.data_path, args.write_path, model, pid,
                   conf["n_train_frame"], test_views, image_paths, K, R, T, D,
                   prefix="test_novel_view", interval=30)
        save_cache(args.data_path, args.write_path, model, pid,
                   conf["n_test_frame"], test_views, image_paths, K, R, T, D,
                   prefix="test_novel_pose", interval=30,
                   start_frame_idx=conf["n_train_frame"])


if __name__ == "__main__":
    main()
