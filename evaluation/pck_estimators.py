"""Pluggable 2-D pose estimators for PCK evaluation.

The reference pipeline (evaluation/compute_PCK.py:82-93) uses an mmdet person
detector + mmpose HRNet top-down model. These are torch models outside the
JAX render stack; when the packages and checkpoints are installed this
adapter reproduces the reference protocol.
"""
from __future__ import annotations

import numpy as np


class StubEstimator:
    """Deterministic image-only estimator for exercising the PCK plumbing.

    Places ``num_keypoints`` keypoints on a fixed ring around the rendered
    foreground centroid (brightness-weighted). It consumes images exactly the
    way :class:`MMPoseEstimator` does, so the dataset → generate → estimate →
    ``keypoint_pck_accuracy`` chain runs end-to-end without mmpose installed
    (numbers are NOT comparable to the reference protocol).
    """

    def __init__(self, num_keypoints: int):
        self.num_keypoints = num_keypoints

    def __call__(self, imgs: np.ndarray) -> np.ndarray:
        """(B, 3, H, W) [-1,1] → (B, K, 2) keypoints."""
        B, _, H, W = imgs.shape
        lum = imgs.mean(axis=1) + 1.0                     # (B, H, W) >= 0
        total = lum.sum(axis=(1, 2)) + 1e-8
        ys = (lum.sum(axis=2) * np.arange(H)).sum(axis=1) / total
        xs = (lum.sum(axis=1) * np.arange(W)).sum(axis=1) / total
        ang = 2 * np.pi * np.arange(self.num_keypoints) / self.num_keypoints
        ring = np.stack([np.cos(ang), np.sin(ang)], axis=1) * (min(H, W) / 8)
        return np.stack([xs, ys], axis=1)[:, None, :] + ring[None]


class VitPoseEstimator:
    """ViTPose top-down keypoints via transformers, from a LOCAL checkpoint.

    Alternative to the mmpose stack when mm* packages are unavailable:
    transformers (baked into this image) ships VitPoseForPoseEstimation;
    only the checkpoint needs to be present on disk (e.g. a local clone of
    ``usyd-community/vitpose-base-simple``). The whole image is used as the
    person box — ENARF renders are single-person and framed (the reference
    protocol's mmdet detector exists to crop in-the-wild images,
    reference evaluation/compute_PCK.py:82-93).
    """

    def __init__(self, model_dir: str):
        import torch  # noqa: F401  (CPU torch is baked in)
        from transformers import AutoProcessor, VitPoseForPoseEstimation
        self._proc = AutoProcessor.from_pretrained(model_dir,
                                                   local_files_only=True)
        self._model = VitPoseForPoseEstimation.from_pretrained(
            model_dir, local_files_only=True).eval()

    def __call__(self, imgs: np.ndarray) -> np.ndarray:
        """(B, 3, H, W) [-1,1] → (B, K, 2) keypoints."""
        import torch
        B, _, H, W = imgs.shape
        rgb = [((img.transpose(1, 2, 0) + 1) * 127.5).astype(np.uint8)
               for img in imgs]
        boxes = [[[0.0, 0.0, float(W), float(H)]]] * B
        inputs = self._proc(images=rgb, boxes=boxes, return_tensors="pt")
        with torch.no_grad():
            outputs = self._model(**inputs)
        res = self._proc.post_process_pose_estimation(outputs, boxes=boxes)
        return np.stack([r[0]["keypoints"].numpy() for r in res])


class MMPoseEstimator:
    """mmdet person detector + mmpose top-down keypoints (reference protocol).

    To reproduce the reference's exact protocol
    (reference evaluation/compute_PCK.py:82-93), install mmdet+mmpose and pass
    their standard COCO checkpoints, e.g.::

        det_config  = mmdet: configs/faster_rcnn/faster_rcnn_r50_fpn_coco.py
        det_ckpt    = faster_rcnn_r50_fpn_1x_coco (mmdet model zoo)
        pose_config = mmpose: configs/body/2d_kpt_sview_rgb_img/topdown_heatmap/
                      coco/hrnet_w48_coco_256x192.py
        pose_ckpt   = hrnet_w48_coco_256x192 (mmpose model zoo)
    """

    def __init__(self,
                 det_config: str = "",
                 det_ckpt: str = "",
                 pose_config: str = "",
                 pose_ckpt: str = ""):
        try:
            from mmdet.apis import init_detector  # type: ignore
            from mmpose.apis import init_pose_model  # type: ignore
        except ImportError as e:
            raise ImportError(
                "mmpose/mmdet are not installed; install them (and their "
                "checkpoints) to run the reference PCK protocol, or use "
                "--estimator projected") from e
        self._det = init_detector(det_config, det_ckpt)
        self._pose = init_pose_model(pose_config, pose_ckpt)

    def __call__(self, imgs: np.ndarray) -> np.ndarray:
        """(B, 3, H, W) [-1,1] → (B, K, 2) keypoints."""
        from mmdet.apis import inference_detector  # type: ignore
        from mmpose.apis import inference_top_down_pose_model  # type: ignore
        out = []
        for img in imgs:
            rgb = ((img.transpose(1, 2, 0) + 1) * 127.5).astype(np.uint8)
            det = inference_detector(self._det, rgb)
            person = [{"bbox": det[0][0]}] if len(det[0]) else \
                [{"bbox": np.array([0, 0, rgb.shape[1], rgb.shape[0], 1.0])}]
            pose, _ = inference_top_down_pose_model(self._pose, rgb, person,
                                                    format="xyxy")
            out.append(pose[0]["keypoints"][:, :2])
        return np.stack(out)
