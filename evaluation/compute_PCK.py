"""PCK evaluation (mirrors reference evaluation/compute_PCK.py).

Protocol: run a 2-D pose estimator on GT renders and on generated images for
the same poses, then report PCK@thr with interocular normalization
(reference compute_PCK.py:170-179, thr=0.5).

The reference uses an mmdet person detector + mmpose HRNet — external
pretrained torch models outside the render stack (SURVEY.md §2.3). Here the
estimator is pluggable:
  * ``--estimator mmpose`` uses mmpose/mmdet if importable (same as reference);
  * ``--estimator projected`` scores the generator against the *projected
    SMPL joints* (pose_2d) using itself — a detector-free consistency PCK
    useful without external checkpoints (numbers not comparable to the paper).

The PCK math itself (keypoint_pck_accuracy) is implemented here and unit
tested in tests/test_eval.py.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def keypoint_pck_accuracy(pred: np.ndarray, gt: np.ndarray, mask: np.ndarray,
                          thr: float, normalize: np.ndarray):
    """PCK: fraction of keypoints with ||pred-gt|| / normalize < thr.

    Args:
        pred, gt: (N, K, 2); mask: (N, K) bool; normalize: (N, 2).
    Returns:
        (per-keypoint acc (K,), mean acc, num valid keypoints)
    """
    N, K, _ = pred.shape
    norm = np.where(normalize <= 0, 1e6, normalize)
    dist = np.linalg.norm((pred - gt) / norm[:, None, :], axis=-1)  # (N, K)
    valid = mask.astype(bool) & (normalize > 0).all(axis=1)[:, None]
    acc_per_kpt = np.full(K, -1.0)
    for k in range(K):
        v = valid[:, k]
        if v.any():
            acc_per_kpt[k] = (dist[v, k] < thr).mean()
    have = acc_per_kpt >= 0
    avg = acc_per_kpt[have].mean() if have.any() else 0.0
    cnt = int(have.sum())
    return acc_per_kpt, float(avg), cnt


def interocular_distance(gt: np.ndarray, left_eye: int = 1, right_eye: int = 2):
    """(N, K, 2) → (N, 2) normalization (reference uses interocular norm)."""
    d = np.linalg.norm(gt[:, left_eye] - gt[:, right_eye], axis=-1)
    return np.stack([d, d], axis=1)


def main():
    from enarf_gan_tpu.utils.platform import setup_jax
    setup_jax()
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str,
                        default="configs/enarfgan_train/AIST/config.yml")
    parser.add_argument("--default_config", type=str,
                        default="configs/enarfgan_train/default.yml")
    parser.add_argument("--num_sample", type=int, default=10000)
    parser.add_argument("--batch_size", type=int, default=4)
    parser.add_argument("--truncation", type=float, default=0.4)
    parser.add_argument("--thr", type=float, default=0.5)
    parser.add_argument("--estimator",
                        choices=["mmpose", "vitpose", "projected", "stub"],
                        default="projected")
    parser.add_argument("--vitpose_dir", type=str, default="",
                        help="local VitPose checkpoint dir "
                             "(--estimator vitpose)")
    args = parser.parse_args()

    import jax
    import jax.numpy as jnp
    from enarf_gan_tpu.config import yaml_config
    from enarf_gan_tpu.data.datasets import HumanPoseDataset
    from enarf_gan_tpu.data.loader import DataLoader, infinite_batches
    from enarf_gan_tpu.training import gan, checkpoint as ckpt

    config = yaml_config(args.config, args.default_config)
    size = config.dataset.image_size
    pose_ds = HumanPoseDataset(size=size,
                               data_root=config.dataset.train.data_root,
                               num_repeat_in_epoch=1)
    gen, dis = gan.build_models(config, pose_ds.num_bone, pose_ds.parents)

    rng = jax.random.PRNGKey(0)
    first = pose_ds[0]
    sample_batch = {k: np.asarray(v)[None] for k, v in first.items()}
    state, _, _ = gan.init_gan_state(config, gen, dis, pose_ds.canonical_pose,
                                     rng, sample_batch)
    out_dir = os.path.join(config.out_root, "result", config.out)
    snap = ckpt.latest_checkpoint(out_dir)
    assert snap, "pretrained model is not loading"
    state = ckpt.load_checkpoint(snap, {"iteration": 0, **state})
    gen_vars = state["gen"]

    if args.estimator == "mmpose":
        from evaluation.pck_estimators import MMPoseEstimator
        estimator = MMPoseEstimator()
    elif args.estimator == "vitpose":
        from evaluation.pck_estimators import VitPoseEstimator
        estimator = VitPoseEstimator(args.vitpose_dir)
    elif args.estimator == "stub":
        from evaluation.pck_estimators import StubEstimator
        estimator = StubEstimator(num_keypoints=pose_ds[0]["pose_2d"].shape[0])
    else:
        estimator = None  # use projected joints as GT, estimator-free score

    z_dim = config.generator_params.z_dim
    loader = infinite_batches(DataLoader(pose_ds, args.batch_size,
                                         shuffle=True, drop_last=True, seed=0))
    preds, gts = [], []
    n_done = 0
    for batch in loader:
        rng, z_rng, f_rng = jax.random.split(rng, 3)
        z = jax.random.normal(z_rng, (args.batch_size, z_dim * 4))
        img, mask, aux = gen.apply(
            gen_vars, f_rng, jnp.asarray(batch["pose_to_camera"]),
            jnp.asarray(batch["pose_to_world"]),
            jnp.asarray(batch["bone_length"]), z,
            jnp.linalg.inv(jnp.asarray(batch["intrinsics"])),
            truncation_psi=args.truncation)
        img_np = np.clip(np.asarray(img), -1, 1)
        if estimator is not None:
            preds.append(estimator(img_np))
            gts.append(batch["pose_2d"])
        else:
            # detector-free: foreground-mask centroid consistency per joint
            # region is not meaningful; instead compare projected joints vs
            # mask coverage: a joint "detected" at its projection if the
            # rendered mask is foreground there.
            m = np.asarray(mask)  # (B, H, W)
            p2d = np.asarray(batch["pose_2d"])  # (B, K, 2)
            xi = np.clip(p2d[..., 0].round().astype(int), 0, size - 1)
            yi = np.clip(p2d[..., 1].round().astype(int), 0, size - 1)
            hit = m[np.arange(len(m))[:, None], yi, xi] > 0.5
            # "pred" = gt where covered, far away otherwise
            pred = np.where(hit[..., None], p2d, p2d + size)
            preds.append(pred)
            gts.append(p2d)
        n_done += args.batch_size
        if n_done >= args.num_sample:
            break
    preds = np.concatenate(preds)[:args.num_sample]
    gts = np.concatenate(gts)[:args.num_sample]
    norm = interocular_distance(gts, 16, 17)  # shoulders as a robust proxy
    maskv = np.ones(preds.shape[:2], bool)
    _, pck, _ = keypoint_pck_accuracy(preds, gts, maskv, args.thr, norm)

    path = os.path.join(out_dir, f"pck_{args.estimator}.txt")
    with open(path, "w") as f:
        f.write(f"{pck}")
    print(path, pck)


if __name__ == "__main__":
    main()
