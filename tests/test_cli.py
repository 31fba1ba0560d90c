"""CLI-surface smoke tests: the shipped entry points run end-to-end on
synthetic data with reference-style two-file YAML configs."""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from enarf_gan_tpu.data.fixtures import make_synthetic_human_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, JAX_PLATFORMS="cpu",
           XLA_FLAGS="--xla_force_host_platform_device_count=2")


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_synth")
    make_synthetic_human_cache(str(root), size=32, n_frames=2, n_camera=2)
    return str(root)


def run_cli(script, args, cwd=REPO, extra_env=None):
    cmd = [sys.executable, script] + args
    env = dict(ENV, **extra_env) if extra_env else ENV
    res = subprocess.run(cmd, cwd=cwd, env=env, capture_output=True,
                         text=True, timeout=1200)
    assert res.returncode == 0, res.stdout + "\n" + res.stderr
    return res


def test_train_dso_cli(synth, tmp_path):
    default = tmp_path / "default.yml"
    default.write_text(textwrap.dedent(f"""
        out_root: {tmp_path}/out
        out: cli_dso
        dataset:
          bs: 2
          image_size: 32
          bg_color: -1
          train:
            data_root: {synth}
            n_frames: 2
          val:
            novel_pose:
              data_root: {synth}
              n_frames: 2
        generator_params:
          use_triplane: True
          ray_batchsize: 64
          nerf_params:
            w_dim: 32
            tri_plane_size: 16
            hidden_size: 16
            Nc: 4
            Nf: 4
            no_ray_direction: True
            origin_location: center_fixed
            coordinate_scale: 3
            render_bs: 256
            model_type: narf
            multiply_density_with_triplane_wieght: False
            clamp_mask: False
            constant_triplane: True
            constant_trimask: False
            selector_mlp: False
            deformation_field: False
            no_selector: False
            time_conditional: True
            pose_conditional: False
            constant_trimask_lr_mul: 1
        loss:
          color_coef: 1
          mask_coef: 1
          nerf_loss_type: mse
        num_iter: 100000
        lr: 0.01
        scheduler_gamma: 0.99995
        val_interval: 6
        print_interval: 100
        tensorboard_interval: 5
        save_interval: 5
        resume:
    """))
    override = tmp_path / "override.yml"
    override.write_text("out: cli_dso\n")
    run_cli("train_DSO.py", ["--config", str(override),
                             "--default_config", str(default),
                             "--iterations", "7"])
    out_dir = f"{tmp_path}/out/result/cli_dso"
    assert os.path.exists(f"{out_dir}/snapshot_latest.npz")
    assert os.path.exists(f"{out_dir}/log.json")
    with open(f"{out_dir}/log.json") as f:
        log = json.load(f)
    entry = log[list(log.keys())[0]]
    assert "val_loss_novel_pose_color_PSNR" in entry

    # resume from the snapshot
    run_cli("train_DSO.py", ["--config", str(override),
                             "--default_config", str(default),
                             "--resume_latest", "--iterations", "8"])


def test_pose_interpolation():
    from enarf_gan_tpu.geometry.pose import interpolate_pose
    from enarf_gan_tpu.data.fixtures import (synthetic_rest_joints,
                                             synthetic_pose_sequence)
    from enarf_gan_tpu.geometry.smpl import SMPL_PARENTS
    rest = synthetic_rest_joints()
    poses = synthetic_pose_sequence(rest, 4)
    out = interpolate_pose(poses.astype(np.float64), SMPL_PARENTS, num=20,
                           loop=True)
    assert out.shape == (20, 24, 4, 4)
    # interpolation passes near the key poses
    np.testing.assert_allclose(out[0], poses[0], atol=1e-4)
    # rotations stay orthonormal
    R = out[:, :, :3, :3]
    eye = np.einsum("fkij,fkil->fkjl", R, R)
    np.testing.assert_allclose(eye, np.tile(np.eye(3), (20, 24, 1, 1)),
                               atol=1e-5)


def test_train_gan_cli(synth, tmp_path):
    default = tmp_path / "gan_default.yml"
    default.write_text(textwrap.dedent(f"""
        out_root: {tmp_path}/out
        out: cli_gan
        dataset:
          bs: 2
          image_size: 32
          train:
            data_root: {synth}
            pose_prior_root:
        generator_params:
          z_dim: 16
          patch_size: 24
          background_ratio: 0.3
          use_triplane: True
          crop_background: True
          pretrained_background: False
          channel_max: 32
          nerf_params:
            w_dim: 32
            tri_plane_size: 16
            final_activation: tanh
            hidden_size: 16
            out_dim: 16
            Nc: 4
            Nf: 4
            no_ray_direction: False
            mask_input: False
            origin_location: center_fixed
            coordinate_scale: 3
            multiply_density_with_triplane_wieght: False
            clamp_mask: False
            constant_triplane: False
            constant_trimask: False
            constant_trimask_lr_mul: 1
            deformation_field: False
            selector_mlp: False
            no_selector: False
        discriminator_params:
          minibatch_std: True
          channel_max: 32
        loss:
          adv_loss_type: ce
          bone_guided_coef: 10
          r1_loss_coef: 0.01
          tri_plane_reg_coef: 0.001
        replace: True
        num_iter: 1000000
        n_accum_step: 2
        resume:
    """))
    override = tmp_path / "gan_override.yml"
    override.write_text("out: cli_gan\n")
    run_cli("train_ENARF_GAN.py", ["--config", str(override),
                                   "--default_config", str(default),
                                   "--iterations", "3"])
    out_dir = f"{tmp_path}/out/result/cli_gan"
    assert os.path.exists(f"{out_dir}/real.png")
    assert os.path.exists(f"{out_dir}/command.txt")


def test_compute_depth_chain(tmp_path):
    """Depth-eval chain end-to-end: synthetic NARF_GAN_depth_cache →
    SurrealPoseDepthDataset → evaluation/compute_depth.py → disparity_mse.txt
    (reference evaluation/compute_depth.py + surreal/preprocess_depth.py)."""
    from enarf_gan_tpu.data.fixtures import make_synthetic_depth_cache
    surreal_root = tmp_path / "surreal"
    make_synthetic_depth_cache(str(surreal_root / "NARF_GAN_depth_cache"),
                               size=32, n_items=2)

    default = tmp_path / "gan_default.yml"
    default.write_text(textwrap.dedent(f"""
        out_root: {tmp_path}/out
        out: depth_eval
        dataset:
          bs: 2
          image_size: 32
          train:
            data_root:
        generator_params:
          z_dim: 16
          patch_size: 24
          background_ratio: 0.3
          use_triplane: True
          crop_background: True
          pretrained_background: False
          channel_max: 32
          nerf_params:
            w_dim: 32
            tri_plane_size: 16
            final_activation: tanh
            hidden_size: 16
            out_dim: 16
            Nc: 4
            Nf: 4
            no_ray_direction: False
            mask_input: False
            origin_location: center_fixed
            coordinate_scale: 3
        discriminator_params:
          minibatch_std: True
          channel_max: 32
        loss:
          adv_loss_type: ce
          bone_guided_coef: 10
          r1_loss_coef: 0.01
          tri_plane_reg_coef: 0.001
        n_accum_step: 1
        num_iter: 10
        resume:
    """))

    # author a snapshot for the eval to load (untrained weights suffice to
    # prove the plumbing)
    import jax
    from enarf_gan_tpu.config import yaml_config, AttrDict
    from enarf_gan_tpu.data.datasets import SurrealPoseDepthDataset
    from enarf_gan_tpu.training import gan, checkpoint as ckpt
    config = yaml_config(str(default), str(default))
    ds = SurrealPoseDepthDataset(
        AttrDict({"data_root": f"{surreal_root}/NARF_GAN_depth_cache"}),
        size=32)
    assert len(ds) == 2 and ds[0]["img"].shape == (32, 32)
    gen, dis = gan.build_models(config, ds.num_bone, ds.parents)
    first = ds[0]
    sample_batch = {
        "pose_to_camera": first["pose_3d"][None],
        "pose_to_world": first["pose_3d_world"][None],
        "bone_length": first["bone_length"][None],
        "intrinsics": first["intrinsics"][None],
    }
    state, _, _ = gan.init_gan_state(config, gen, dis, ds.canonical_pose,
                                     jax.random.PRNGKey(0), sample_batch)
    out_dir = f"{tmp_path}/out/result/depth_eval"
    ckpt.save_checkpoint(out_dir, {"iteration": 0, **state}, 0)

    run_cli("evaluation/compute_depth.py",
            ["--surreal_path", str(surreal_root),
             "--config", str(default), "--default_config", str(default),
             "--num_sample", "2", "--batch_size", "1"])
    mse_path = f"{out_dir}/disparity_mse.txt"
    assert os.path.exists(mse_path)
    assert np.isfinite(float(open(mse_path).read()))

def test_compute_pck_chain(synth, tmp_path):
    """PCK chain end-to-end with the stub estimator: pose dataset → generate
    → estimate keypoints → keypoint_pck_accuracy → pck_stub.txt (reference
    evaluation/compute_PCK.py; estimator adapter documented in
    evaluation/pck_estimators.py)."""
    default = tmp_path / "gan_default.yml"
    default.write_text(textwrap.dedent(f"""
        out_root: {tmp_path}/out
        out: pck_eval
        dataset:
          bs: 2
          image_size: 32
          train:
            data_root: {synth}
        generator_params:
          z_dim: 16
          patch_size: 24
          background_ratio: 0.3
          use_triplane: True
          crop_background: True
          pretrained_background: False
          channel_max: 32
          nerf_params:
            w_dim: 32
            tri_plane_size: 16
            final_activation: tanh
            hidden_size: 16
            out_dim: 16
            Nc: 4
            Nf: 4
            no_ray_direction: False
            mask_input: False
            origin_location: center_fixed
            coordinate_scale: 3
        discriminator_params:
          minibatch_std: True
          channel_max: 32
        loss:
          adv_loss_type: ce
          bone_guided_coef: 10
          r1_loss_coef: 0.01
          tri_plane_reg_coef: 0.001
        n_accum_step: 1
        num_iter: 10
        resume:
    """))

    # author a snapshot for the eval to load (untrained weights suffice)
    import jax
    from enarf_gan_tpu.config import yaml_config
    from enarf_gan_tpu.data.datasets import HumanPoseDataset
    from enarf_gan_tpu.training import gan, checkpoint as ckpt
    config = yaml_config(str(default), str(default))
    ds = HumanPoseDataset(size=32, data_root=synth, num_repeat_in_epoch=1)
    gen, dis = gan.build_models(config, ds.num_bone, ds.parents)
    first = ds[0]
    sample_batch = {k: np.asarray(v)[None] for k, v in first.items()}
    state, _, _ = gan.init_gan_state(config, gen, dis, ds.canonical_pose,
                                     jax.random.PRNGKey(0), sample_batch)
    out_dir = f"{tmp_path}/out/result/pck_eval"
    ckpt.save_checkpoint(out_dir, {"iteration": 0, **state}, 0)

    run_cli("evaluation/compute_PCK.py",
            ["--config", str(default), "--default_config", str(default),
             "--num_sample", "2", "--batch_size", "1", "--estimator", "stub"])
    pck_path = f"{out_dir}/pck_stub.txt"
    assert os.path.exists(pck_path)
    v = float(open(pck_path).read())
    assert 0.0 <= v <= 1.0


def test_compute_fid_chain(synth, tmp_path):
    """FID chain end-to-end: pose dataset → generate → InceptionV3 features
    (deterministic random:0 weight set, eval_lib/fid.py weight policy) →
    dataset-stats cache → Fréchet distance → fid.txt (reference
    evaluation/compute_fid.py:76-225)."""
    default = tmp_path / "gan_default.yml"
    default.write_text(textwrap.dedent(f"""
        out_root: {tmp_path}/out
        out: fid_eval
        dataset:
          bs: 2
          image_size: 32
          train:
            data_root: {synth}
        generator_params:
          z_dim: 16
          patch_size: 24
          background_ratio: 0.3
          use_triplane: True
          crop_background: True
          pretrained_background: False
          channel_max: 32
          nerf_params:
            w_dim: 32
            tri_plane_size: 16
            final_activation: tanh
            hidden_size: 16
            out_dim: 16
            Nc: 4
            Nf: 4
            no_ray_direction: False
            mask_input: False
            origin_location: center_fixed
            coordinate_scale: 3
        discriminator_params:
          minibatch_std: True
          channel_max: 32
        loss:
          adv_loss_type: ce
          bone_guided_coef: 10
          r1_loss_coef: 0.01
          tri_plane_reg_coef: 0.001
        n_accum_step: 1
        num_iter: 10
        resume:
    """))

    # author a snapshot for the eval to load (untrained weights suffice)
    import jax
    from enarf_gan_tpu.config import yaml_config
    from enarf_gan_tpu.data.datasets import HumanPoseDataset
    from enarf_gan_tpu.training import gan, checkpoint as ckpt
    config = yaml_config(str(default), str(default))
    ds = HumanPoseDataset(size=32, data_root=synth, num_repeat_in_epoch=1)
    gen, dis = gan.build_models(config, ds.num_bone, ds.parents)
    first = ds[0]
    sample_batch = {k: np.asarray(v)[None] for k, v in first.items()}
    state, _, _ = gan.init_gan_state(config, gen, dis, ds.canonical_pose,
                                     jax.random.PRNGKey(0), sample_batch)
    out_dir = f"{tmp_path}/out/result/fid_eval"
    ckpt.save_checkpoint(out_dir, {"iteration": 0, **state}, 0)

    run_cli("evaluation/compute_fid.py",
            ["--config", str(default), "--default_config", str(default),
             "--num_sample", "2", "--batch_size", "1"],
            extra_env={"INCEPTION_WEIGHTS_NPZ": "random:0"})
    fid_path = f"{out_dir}/fid.txt"
    assert os.path.exists(fid_path)
    v = float(open(fid_path).read())
    assert np.isfinite(v) and v >= 0.0
    # stats cache is keyed by weight set — never mixes with real-weight FIDs
    # (wtag derivation mirrors compute_fid.py: splitext of the basename)
    wtag = os.path.splitext(os.path.basename("random:0"))[0]
    assert os.path.exists(os.path.join(synth, f"fid_stats_32_{wtag}.npz"))
    assert not os.path.exists(os.path.join(synth,
                                           "fid_stats_32_torchvision.npz"))
