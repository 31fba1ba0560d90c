"""AIST++ preprocessing → native cache.npz.

Port of reference data_preprocess/AIST/preprocess.py:22-237 on this
framework's SMPL FK and npz codec. Semantics preserved: 3fps ffmpeg decode,
undistortion, **aligned_crop** (crop size ∝ focal/1500, centered on the spine
joint, reflect-padded, resized to 128² with intrinsics rebase), SMPL forward
× scaling + translation, /100 unit normalization, per-person caches merged
into ``all_all``. Requires the ``aist_plusplus`` SDK (external dataset SDK —
gate: install from the AIST++ release to run this script).
"""
import argparse
import glob
import math
import os
import sys
from contextlib import redirect_stdout

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import numpy as np

ALGO = "aligned_crop"
CROP_SIZE = 600
SAVE_SIZE = 128
STANDARD_FOCAL = 1500
N_PER_PERSON = 3000  # default; --n_per_person overrides for small runs


def smpl_forward_batch(model, poses):
    import jax.numpy as jnp
    from enarf_gan_tpu.geometry.smpl import smpl_pose_transforms
    from enarf_gan_tpu.utils.platform import setup_jax
    setup_jax()
    betas = np.zeros((len(poses), model["shapedirs"].shape[-1]), np.float32)
    return np.array(smpl_pose_transforms(
        jnp.asarray(betas), jnp.asarray(poses.reshape(len(poses), -1),
                                        jnp.float32),
        jnp.asarray(model["v_template"]), jnp.asarray(model["shapedirs"]),
        jnp.asarray(model["J_regressor"]), model["parents"]))


def _project_joints(pose, rot, trans, intrinsic):
    """Per-joint world→image projection → (n_joints, 2) pixel coords."""
    cam_pts = np.matmul(rot[None], pose[:, :3, 3:]) + trans[None]
    px = np.matmul(intrinsic[None], cam_pts)
    return px[:, :2, 0] / px[:, 2:, 0]


def _all_joints_visible(joints_2d, height, width):
    return bool(joints_2d.min() >= 0 and joints_2d[:, 0].max() < width
                and joints_2d[:, 1].max() < height)


def _square_crop_reflect(img, center, side):
    """Crop a ``side``-pixel square centered at ``center`` (reflect-padded
    where it leaves the image); returns (crop, top_left)."""
    h, w, _ = img.shape
    x1 = math.floor(center[0]) - side // 2
    y1 = math.floor(center[1]) - side // 2
    grow = ((max(0, -y1), max(0, y1 + side - h)),
            (max(0, -x1), max(0, x1 + side - w)), (0, 0))
    padded = np.pad(img, grow, mode="reflect")
    crop = padded[max(0, y1):max(0, y1) + side,
                  max(0, x1):max(0, x1) + side]
    return crop, (x1, y1)


def _rebase_intrinsics(intrinsic, top_left, side):
    """Intrinsics for the crop resized to SAVE_SIZE."""
    out = intrinsic.copy()
    out[:2, 2] -= np.asarray(top_left)
    out[:2] /= (side / SAVE_SIZE)
    return out


def aligned_crop(img, intrinsic, rot, trans, pose):
    """Focal-normalized square crop centered on the spine joint.

    Behavioral spec — the crop geometry is the dataset wire format and must
    match the reference byte-for-byte (reference AIST/preprocess.py:30-64):
    crop side = CROP_SIZE·focal/1500 (even), reflect padding, bicubic resize
    to SAVE_SIZE, BGR→RGB, intrinsics shifted+scaled to the crop.
    """
    import cv2
    focal = (intrinsic[0, 0] + intrinsic[1, 1]) / 2
    side = int(CROP_SIZE * focal / STANDARD_FOCAL) // 2 * 2
    joints_2d = _project_joints(pose, rot, trans, intrinsic)
    validity = _all_joints_visible(joints_2d, *img.shape[:2])
    if validity:
        crop, top_left = _square_crop_reflect(img, joints_2d[0], side)
        out = cv2.resize(crop, (SAVE_SIZE, SAVE_SIZE),
                         interpolation=cv2.INTER_CUBIC)[:, :, ::-1]
    else:
        out, top_left = np.zeros((SAVE_SIZE, SAVE_SIZE, 3), np.uint8), (0, 0)
    return out, _rebase_intrinsics(intrinsic, top_left, side), validity


def read_frames(video_dir, aist_dataset, smpl_model, person_id,
                n_per_person=N_PER_PERSON):
    import cv2
    from aist_plusplus import utils
    from aist_plusplus.loader import AISTDataset

    paths = sorted(glob.glob(f"{video_dir}/*_d{person_id:0>2}_*.mp4"))
    vids, intrs, valids, rmats, tvecs, smpls = [], [], [], [], [], []
    for video_path in paths:
        video_name = os.path.splitext(os.path.basename(video_path))[0]
        seq_name, view = AISTDataset.get_seq_name(video_name)
        view_idx = AISTDataset.VIEWS.index(view)
        env_name = aist_dataset.mapping_seq2env[seq_name]
        cgroup = AISTDataset.load_camera_group(aist_dataset.camera_dir, env_name)
        with redirect_stdout(open(os.devnull, "w")):
            frames3fps = utils.ffmpeg_video_read(video_path, 3)[:, :, :, ::-1]

        cam = cgroup.cameras[view_idx]
        camera_mat = cam.matrix
        rmat = cv2.Rodrigues(cam.rvec)[0]
        tvec = cam.tvec[:, None]
        dist = cam.dist

        smpl_poses, smpl_scaling, smpl_trans = AISTDataset.load_motion(
            aist_dataset.motion_dir, seq_name)
        poses = smpl_poses.reshape(-1, 24, 3)
        A = smpl_forward_batch(smpl_model, poses)
        A[:, :, :3, 3] *= smpl_scaling
        A[:, :, :3, 3] += smpl_trans[:, None]

        video_len = len(frames3fps)
        rmats.append(np.tile(rmat, (video_len, 1, 1)))
        tvecs.append(np.tile(tvec, (video_len, 1, 1)))
        smpls.append(A[19:20 * video_len:20])

        fr, ins, vals = [], [], []
        for i in range(video_len):
            idx_60fps = (i + 1) * 20 - 1
            frame = cv2.undistort(frames3fps[i], camera_mat, dist)
            frame, intri, validity = aligned_crop(frame, camera_mat, rmat,
                                                  tvec, A[idx_60fps])
            fr.append(frame)
            ins.append(intri)
            vals.append(validity)
        vids.append(np.array(fr))
        intrs.append(np.array(ins))
        valids.append(np.array(vals))

    video = np.concatenate(vids)
    intrinsic = np.concatenate(intrs)
    validity = np.concatenate(valids)
    rmat = np.concatenate(rmats)
    tvec = np.concatenate(tvecs)
    smpl = np.concatenate(smpls)

    video, intrinsic = video[validity], intrinsic[validity]
    rmat, tvec, smpl = rmat[validity], tvec[validity], smpl[validity]
    idx = np.linspace(0, len(video) - 1, n_per_person, dtype=int)
    video, intrinsic = video[idx], intrinsic[idx]
    rmat, tvec, smpl = rmat[idx], tvec[idx].copy(), smpl[idx].copy()
    tvec /= 100
    smpl[:, :, :3, 3] /= 100
    return video, rmat, tvec, smpl, intrinsic


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_path", type=str, required=True)
    parser.add_argument("--write_path", type=str, default="data/aist++")
    parser.add_argument("--annotation_path", type=str, required=True)
    parser.add_argument("--smpl_dir", type=str, default="smpl_data")
    parser.add_argument("--person_ids", type=str, default=None,
                        help="comma-separated dancer ids (default: all 30)")
    parser.add_argument("--n_per_person", type=int, default=N_PER_PERSON)
    args = parser.parse_args()

    from aist_plusplus.loader import AISTDataset
    from enarf_gan_tpu.data.cache import save_cache_npz

    smpl_model = dict(np.load(os.path.join(args.smpl_dir, "SMPL_MALE.npz")))
    aist_dataset = AISTDataset(args.annotation_path)
    cache_root = (f"{args.write_path}/cache{SAVE_SIZE}_{ALGO}_"
                  f"fl{STANDARD_FOCAL}")

    person_ids = np.concatenate([np.arange(7, 31), np.arange(1, 7)]) \
        if args.person_ids is None else \
        [int(p) for p in args.person_ids.split(",")]
    merged = {}
    for pid in person_ids:
        video, rmat, tvec, smpl, intrinsic = read_frames(
            args.data_path, aist_dataset, smpl_model, pid,
            args.n_per_person)
        arrays = dict(imgs=video.transpose(0, 3, 1, 2).astype(np.uint8),
                      camera_intrinsic=intrinsic.astype(np.float32),
                      camera_rotation=rmat.astype(np.float32),
                      camera_translation=tvec.astype(np.float32),
                      smpl_pose=smpl.astype(np.float32))
        save_cache_npz(f"{cache_root}/{pid:0>2}", **arrays)
        for k, v in arrays.items():
            merged.setdefault(k, []).append(v)
        print(f"person {pid}: {len(video)} frames")

    merged = {k: np.concatenate(v) for k, v in merged.items()}
    out = f"{cache_root}/all_all"
    save_cache_npz(out, **merged)
    canon = os.path.join(args.smpl_dir, "male_canonical.npy")
    if os.path.exists(canon):
        np.save(os.path.join(out, "canonical.npy"), np.load(canon))
    print("wrote", out)


if __name__ == "__main__":
    main()
