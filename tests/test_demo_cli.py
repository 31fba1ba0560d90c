"""Demo-CLI smoke tests: train a few iters → snapshot → demo renders PNGs.

Covers the two inference entry points the reference ships (DSO_demo.py:15-71,
ENARF_GAN_demo.py:17-84): snapshot load → sample_data → full-image render →
PNG (+ mesh extraction/raster for the GAN demo), end to end via subprocess.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from enarf_gan_tpu.data.fixtures import make_synthetic_human_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, JAX_PLATFORMS="cpu")


def run_cli(script, args):
    res = subprocess.run([sys.executable, script] + args, cwd=REPO, env=ENV,
                         capture_output=True, text=True, timeout=1200)
    assert res.returncode == 0, res.stdout + "\n" + res.stderr
    return res


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = tmp_path_factory.mktemp("demo_synth")
    make_synthetic_human_cache(str(root), size=32, n_frames=2, n_camera=2)
    return str(root)


@pytest.fixture(scope="module")
def sample_data(synth, tmp_path_factory):
    out = tmp_path_factory.mktemp("demo_samples")
    run_cli("data_preprocess/prepare_sample_data.py",
            ["--data_root", synth, "--out", str(out), "--num", "2"])
    assert os.path.exists(os.path.join(out, "sample_data.npz"))
    return str(out)


def _png_ok(path):
    from PIL import Image
    assert os.path.exists(path), path
    arr = np.asarray(Image.open(path))
    assert arr.size > 0 and np.isfinite(arr.astype(np.float64)).all()
    return arr


def test_dso_demo_cli(synth, sample_data, tmp_path):
    default = tmp_path / "default.yml"
    default.write_text(textwrap.dedent(f"""
        out_root: {tmp_path}/out
        out: demo_dso
        sample_path: {sample_data}
        canonical_pose_path: {synth}/canonical.npy
        dataset:
          bs: 1
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
            constant_triplane: True
            time_conditional: True
            pose_conditional: False
        loss:
          color_coef: 1
          mask_coef: 1
          nerf_loss_type: mse
        num_iter: 100000
        lr: 0.01
        scheduler_gamma: 0.99995
        val_interval: 1000
        print_interval: 100
        tensorboard_interval: 1000
        save_interval: 2
        resume:
    """))
    run_cli("train_DSO.py", ["--config", str(default),
                             "--default_config", str(default),
                             "--iterations", "3"])
    out_dir = f"{tmp_path}/out/result/demo_dso"
    assert os.path.exists(f"{out_dir}/snapshot_latest.npz")

    run_cli("DSO_demo.py", ["--config", str(default),
                            "--default_config", str(default),
                            "--render_bs", "256"])
    for idx in range(2):
        _png_ok(f"{out_dir}/samples/{idx:0>4}.png")


def test_dso_demo_cli_tiled(synth, sample_data, tmp_path):
    """Same train->demo chain through the tilewin fast path
    (plane_sample_dtype bfloat16 + tile_patch)."""
    default = tmp_path / "default.yml"
    default.write_text(textwrap.dedent(f"""
        out_root: {tmp_path}/out
        out: demo_dso_tiled
        sample_path: {sample_data}
        canonical_pose_path: {synth}/canonical.npy
        dataset:
          bs: 1
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
            constant_triplane: True
            time_conditional: True
            pose_conditional: False
            plane_sample_dtype: bfloat16
            tile_patch: 4
        loss:
          color_coef: 1
          mask_coef: 1
          nerf_loss_type: mse
        num_iter: 100000
        lr: 0.01
        scheduler_gamma: 0.99995
        val_interval: 1000
        print_interval: 100
        tensorboard_interval: 1000
        save_interval: 2
        resume:
    """))
    run_cli("train_DSO.py", ["--config", str(default),
                             "--default_config", str(default),
                             "--iterations", "3"])
    out_dir = f"{tmp_path}/out/result/demo_dso_tiled"
    run_cli("DSO_demo.py", ["--config", str(default),
                            "--default_config", str(default),
                            "--render_bs", "256"])
    for idx in range(2):
        _png_ok(f"{out_dir}/samples/{idx:0>4}.png")


@pytest.fixture(scope="module")
def gan_run(synth, sample_data, tmp_path_factory):
    """Train the tiny GAN config 2 iters → (config path, out_dir)."""
    tmp_path = tmp_path_factory.mktemp("gan_run")
    default = tmp_path / "gan_default.yml"
    default.write_text(textwrap.dedent(f"""
        out_root: {tmp_path}/out
        out: demo_gan
        sample_path: {sample_data}
        canonical_pose_path: {synth}/canonical.npy
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
        n_accum_step: 1
        resume:
    """))
    run_cli("train_ENARF_GAN.py", ["--config", str(default),
                                   "--default_config", str(default),
                                   "--iterations", "2"])
    return str(default), f"{tmp_path}/out/result/demo_gan"


def test_enarf_gan_demo_cli(gan_run):
    default, out_dir = gan_run
    run_cli("ENARF_GAN_demo.py", ["--config", default,
                                  "--default_config", default,
                                  "--num_samples", "1", "--mesh",
                                  "--mesh_voxel_size", "0.2"])
    _png_ok(f"{out_dir}/samples/img_0000.png")
    mask = _png_ok(f"{out_dir}/samples/mask_0000.png")
    assert mask.max() <= 255
    _png_ok(f"{out_dir}/samples/mesh_0000.png")


def test_compute_fid_e2e(gan_run):
    """Snapshot → generate → Inception features → fid.txt, end to end
    (reference evaluation/compute_fid.py:156-225) with the seeded-random
    weight set (INCEPTION_WEIGHTS_NPZ=random — real weights need a
    connected export, eval_lib/fid.py policy)."""
    default, out_dir = gan_run
    env = dict(ENV, INCEPTION_WEIGHTS_NPZ="random")
    res = subprocess.run(
        [sys.executable, "evaluation/compute_fid.py", "--config", default,
         "--default_config", default, "--num_sample", "4",
         "--batch_size", "2"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=1200)
    assert res.returncode == 0, res.stdout + "\n" + res.stderr
    with open(f"{out_dir}/fid.txt") as f:
        fid = float(f.read())
    assert np.isfinite(fid) and fid >= 0
