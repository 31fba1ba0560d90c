"""SURREAL preprocessing → native cache.npz.

Port of reference data_preprocess/surreal/preprocess.py:18-156 using this
framework's SMPL FK (.npz models) instead of smplx, and the npz cache codec
instead of pickle+blosc. Semantics preserved: first video frame (+ optional
segmentation mask channel), SMPL forward with zrot, joints3D-based shift,
axis permutation [1,2,0,3]·[-1,-1,-1,1], spine crop 180→128 with intrinsics
rebase (K = [[600,0,160],[0,600,120]]).
"""
import argparse
import glob
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import numpy as np

IMG_SIZE = 128
CROP_SIZE = 180
K_FULL = np.array([[600, 0, 160], [0, 600, 120], [0, 0, 1]], dtype=np.float64)


def load_smpl_models(smpl_dir):
    models = {}
    for gender in ("male", "female"):
        path = os.path.join(smpl_dir, f"SMPL_{gender.upper()}.npz")
        if os.path.exists(path):
            models[gender] = dict(np.load(path))
    if not models:
        raise FileNotFoundError(
            f"no SMPL_*.npz under {smpl_dir}; run convert_smpl_pkl.py first")
    return models


def smpl_forward(model, poses, betas):
    import jax.numpy as jnp
    from enarf_gan_tpu.geometry.smpl import smpl_pose_transforms
    from enarf_gan_tpu.utils.platform import setup_jax
    setup_jax()
    return np.asarray(smpl_pose_transforms(
        jnp.asarray(betas, jnp.float32),
        jnp.asarray(poses.reshape(1, -1), jnp.float32),
        jnp.asarray(model["v_template"]), jnp.asarray(model["shapedirs"]),
        jnp.asarray(model["J_regressor"]), model["parents"]))


def first_video_frame(video_path):
    """Decode frame 0 of a SURREAL clip (BGR uint8, 240x320)."""
    import cv2
    cap = cv2.VideoCapture(video_path)
    try:
        ok, frame = cap.read()
    finally:
        cap.release()
    return frame if ok else None


def foreground_mask(video_path):
    """Person mask of frame 0 from the clip's ``*_segm.mat`` sidecar."""
    import scipy.io
    segm = scipy.io.loadmat(video_path[:-4] + "_segm.mat", squeeze_me=True)
    return segm["segm_1"] > 0


def read_frame(video_path, return_mask=False):
    frame = first_video_frame(video_path)
    if frame is None or not return_mask:
        return frame, None
    mask = foreground_mask(video_path)
    return frame * mask[:, :, None], mask


def read_pose_and_crop(video_path, smpl_models):
    import scipy.io
    annot = scipy.io.loadmat(video_path[:-4] + "_info.mat")
    gender = ["female", "male"][int(annot["gender"][0, 0])]
    poses = annot["pose"][:, 0].reshape(1, 24, 3)
    betas = annot["shape"][None, :, 0]
    zrot = float(annot["zrot"][0, 0])

    A = smpl_forward(smpl_models[gender], poses, betas)
    trans = np.array([[np.cos(zrot), -np.sin(zrot), 0, 0],
                      [np.sin(zrot), np.cos(zrot), 0, 0],
                      [0, 0, 1, 0], [0, 0, 0, 1]])
    A_new = np.matmul(trans, A)

    if annot["joints3D"].ndim != 3:
        return (None,) * 4
    joints3D = annot["joints3D"][:, :, 0]
    camLoc = annot["camLoc"]
    j3D = (joints3D - camLoc).mean(axis=1)
    j3D = j3D * np.array([1, -1, 1])
    j3D = j3D[[0, 2, 1]]
    shift = j3D - A_new[0, :, :3, 3].mean(axis=0)
    A_new[:, :, :3, 3] += shift
    # axis transform (reference surreal/preprocess.py:78)
    A_new = A_new[:, :, [1, 2, 0, 3]] * np.array([-1, -1, -1, 1])[:, None]

    pose_3d = A_new[0, :, :3, 3:]
    pose_2d = np.matmul(K_FULL, pose_3d)
    pose_2d = pose_2d[:, :2, 0] / pose_2d[:, 2:, 0]
    center = pose_2d[[1, 2]].mean(axis=0).astype(int)
    x1, y1 = center[0] - CROP_SIZE // 2, center[1] - CROP_SIZE // 2
    crop = (x1, x1 + CROP_SIZE, y1, y1 + CROP_SIZE)
    resized_K = K_FULL.copy()
    resized_K[:2, 2] -= np.array([x1, y1])
    resized_K[:2] *= IMG_SIZE / CROP_SIZE
    return crop, A_new, resized_K, pose_2d


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_path", type=str, required=True)
    parser.add_argument("--write_path", type=str, default="data/surreal")
    parser.add_argument("--smpl_dir", type=str, default="smpl_data")
    parser.add_argument("--segmentation", action="store_true", default=True)
    args = parser.parse_args()

    import cv2
    smpl_models = load_smpl_models(args.smpl_dir)
    videos = sorted(glob.glob(f"{args.data_path}/*/*/*/*.mp4"))
    print(len(videos), "videos")

    imgs, poses, intrinsics = [], [], []
    for path in videos:
        try:
            frame, mask = read_frame(path, args.segmentation)
            crop, A_new, K, _ = read_pose_and_crop(path, smpl_models)
        except Exception as e:
            print("invalid data:", path, e)
            continue
        if crop is None or frame is None:
            print("invalid data:", path)
            continue
        x1, x2, y1, y2 = crop
        if x1 < 0 or y1 < 0 or x2 > frame.shape[1] or y2 > frame.shape[0]:
            print("crop out of bounds:", path)
            continue
        cropped = frame[y1:y2, x1:x2]
        resized = cv2.resize(cropped, (IMG_SIZE, IMG_SIZE),
                             interpolation=cv2.INTER_AREA)
        img = resized[:, :, ::-1].transpose(2, 0, 1)  # BGR→RGB, CHW
        if args.segmentation and mask is not None:
            m = cv2.resize(mask[y1:y2, x1:x2].astype("uint8"),
                           (IMG_SIZE, IMG_SIZE),
                           interpolation=cv2.INTER_NEAREST)
            img = np.concatenate([img, m[None] * 255], axis=0)
        imgs.append(img.astype(np.uint8))
        poses.append(A_new[0].astype(np.float32))
        intrinsics.append(K.astype(np.float32))

    from enarf_gan_tpu.data.cache import save_cache_npz
    name = "VAE_cache" if args.segmentation else "GAN_cache"
    out_dir = os.path.join(args.write_path, name)
    save_cache_npz(out_dir, imgs=np.stack(imgs),
                   camera_intrinsic=np.stack(intrinsics),
                   smpl_pose=np.stack(poses))
    canon_src = os.path.join(args.smpl_dir, "neutral_canonical.npy")
    if os.path.exists(canon_src):
        np.save(os.path.join(out_dir, "canonical.npy"), np.load(canon_src))
    print("wrote", out_dir)


if __name__ == "__main__":
    main()
