"""End-to-end training smoke tests on synthetic data (SURVEY.md §4 implication:
overfit smoke — a short DSO run must drive loss down; GAN steps must run and
stay finite)."""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from enarf_gan_tpu.config import AttrDict
from enarf_gan_tpu.data.fixtures import make_synthetic_human_cache
from enarf_gan_tpu.data.datasets import SSODataset, HumanDataset, HumanPoseDataset
from enarf_gan_tpu.data.loader import DataLoader


def tiny_dso_config(root, out_root):
    return AttrDict({
        "out_root": out_root, "out": "smoke_dso",
        "dataset": {"bs": 2, "image_size": 32, "bg_color": -1, "num_workers": 1,
                    "train": {"data_root": root, "n_frames": 3}},
        "generator_params": {
            "use_triplane": True, "ray_batchsize": 128,
            "nerf_params": {
                "w_dim": 32,
                "hidden_size": 16, "Nc": 6, "Nf": 8, "no_ray_direction": True,
                "origin_location": "center_fixed", "coordinate_scale": 3,
                "render_bs": 256, "model_type": "narf",
                "multiply_density_with_triplane_wieght": False,
                "clamp_mask": False, "constant_triplane": False,
                "constant_trimask": False, "selector_mlp": False,
                "deformation_field": True, "no_selector": False,
                "time_conditional": True, "pose_conditional": False,
                "constant_trimask_lr_mul": 1, "tri_plane_size": 16},
        },
        "loss": {"color_coef": 1, "mask_coef": 1, "nerf_loss_type": "mse"},
        # lr follows the reference (train_DSO.py:204, 1e-3). Larger rates
        # (the 0.01-0.02 this suite shipped with through round 4) drive a
        # density limit cycle: the zero-init density head fires uniformly
        # via its bias, gets slammed back to exactly 0 by the background
        # penalty, and never differentiates spatially — the model renders
        # pure background forever (diagnosed round 5, tools/diag_learning.py).
        "num_iter": 40, "lr": 0.001, "scheduler_gamma": 0.99995,
        "val_interval": 1000, "print_interval": 1000,
        "tensorboard_interval": 20, "save_interval": 20,
        "resume": None, "resume_latest": False,
    })


def tiny_gan_config(root, out_root):
    return AttrDict({
        "out_root": out_root, "out": "smoke_gan",
        "dataset": {"bs": 4, "image_size": 32, "num_workers": 1,
                    "train": {"data_root": root, "pose_prior_root": None}},
        "generator_params": {
            "z_dim": 16, "patch_size": 24, "background_ratio": 0.3,
            "use_triplane": True, "crop_background": True, "channel_max": 32,
            "pretrained_background": False,
            "nerf_params": {
                "w_dim": 32,
                "hidden_size": 16, "Nc": 4, "Nf": 4, "no_ray_direction": True,
                "origin_location": "center_fixed", "coordinate_scale": 3,
                "render_bs": 1024, "mask_input": False,
                "multiply_density_with_triplane_wieght": False,
                "clamp_mask": False, "constant_triplane": False,
                "constant_trimask": False, "constant_trimask_lr_mul": 1,
                "deformation_field": False, "selector_mlp": False,
                "no_selector": False, "tri_plane_size": 16},
        },
        "discriminator_params": {"minibatch_std": True, "channel_max": 32},
        "loss": {"adv_loss_type": "ce", "bone_guided_coef": 10,
                 "r1_loss_coef": 0.01, "tri_plane_reg_coef": 0.001},
        "num_iter": 5, "n_accum_step": 2,
        "resume": None, "resume_latest": False,
    })


@pytest.fixture(scope="module")
def synth_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_synth")
    make_synthetic_human_cache(str(root), size=32, n_frames=3, n_camera=2)
    return str(root)


def test_dso_overfit_smoke(synth_root, tmp_path):
    from enarf_gan_tpu.training import dso
    config = tiny_dso_config(synth_root, str(tmp_path))
    train_ds = SSODataset(config.dataset.train, size=32, return_bone_params=True,
                          return_mask=True, num_repeat_in_epoch=50)
    loader = DataLoader(train_ds, config.dataset.bs, seed=0)
    gen = dso.build_generator(config, train_ds.num_bone, train_ds.parents)
    variables, opt_state, history = dso.train_loop(
        config, gen, (train_ds, {}), (loader, {}), train_ds.canonical_pose,
        verbose=False)
    assert len(history) == 40
    assert np.isfinite(history).all()
    first = np.mean(history[:10])
    last = np.mean(history[-10:])
    assert last < first, f"loss did not decrease: {first} -> {last}"
    # checkpoint written
    assert os.path.exists(os.path.join(config.out_root, "result", config.out,
                                       "snapshot_latest.npz"))


@pytest.mark.parametrize("tile_patch", [0, 4])
def test_dso_overfit_psnr(synth_root, tmp_path, tile_patch):
    """Metric-level acceptance: overfitting ONE frame must reach a real
    reconstruction PSNR, not just a decreasing loss (VERDICT: sampler or
    renderer regressions must show as metric drops; reference bar is the
    PSNR/SSIM validation loop, train_DSO.py:75-170). Runs for both the
    exact per-member sampler and the tilewin patch-window fast path
    (training + validation both ride the configured sampler)."""
    from enarf_gan_tpu.training import dso
    config = tiny_dso_config(synth_root, str(tmp_path))
    config.dataset.bs = 1
    config.dataset.train.n_frames = 1
    config.generator_params.ray_batchsize = 512
    config.num_iter = 200
    config.lr = 0.001  # reference lr; 0.02 limit-cycles (see tiny_dso_config)
    if tile_patch:
        config.generator_params.nerf_params.tile_patch = tile_patch
        config.generator_params.nerf_params.plane_sample_dtype = "bfloat16"
    train_ds = SSODataset(config.dataset.train, size=32,
                          return_bone_params=True, return_mask=True,
                          num_repeat_in_epoch=200)
    loader = DataLoader(train_ds, config.dataset.bs, seed=0)
    gen = dso.build_generator(config, train_ds.num_bone, train_ds.parents)
    variables, opt_state, history = dso.train_loop(
        config, gen, (train_ds, {}), (loader, {}), train_ds.canonical_pose,
        verbose=False)
    out = dso.validate(gen, variables, config, {"train": loader},
                       jax.random.PRNGKey(5), num_data=1)
    psnr_db = out["train"]["color_PSNR"]
    # DEGENERATE BASELINE, computed in-test (VERDICT r4 Weak #3: a bar
    # below the blank-render floor is vacuous — a model that renders pure
    # background must FAIL here). The model must beat a constant
    # bg_color frame by a clear margin.
    from enarf_gan_tpu.eval_lib.metrics import psnr as psnr_fn
    item = train_ds[0]
    blank = np.full_like(item["img"][None], config.dataset.bg_color)
    blank_floor = float(psnr_fn(item["img"][None], blank))
    print(f"{'tilewin' if tile_patch else 'exact'}: 32² overfit PSNR "
          f"{psnr_db:.3f} dB (blank floor {blank_floor:.3f} dB)")
    assert psnr_db > blank_floor + 2.0, (
        f"overfit PSNR {psnr_db:.2f} dB does not beat the blank-render "
        f"floor {blank_floor:.2f} dB by 2 dB — the model learned only "
        f"background")
    # absolute bar below the round-5 calibration (lr 1e-3, 200 it; measured
    # values recorded in PERF.md "Reconstruction quality") with headroom
    # for sampler/seed jitter
    assert psnr_db > 15.0, f"overfit PSNR too low: {psnr_db:.2f} dB"


def test_dso_grad_accum_matches_single_pass(synth_root, tmp_path):
    """n_accum_step scans micro-batches packing tilewin tables per
    micro-batch — the 512² memory fix (PERF.md round 4: bs16 single-pass
    packing needs ~5.2 GB of tables before the step runs). Gradients must
    match the single-pass step on a duplicated batch: micro-batches of
    identical content see identical per-sample grads, so accumulating
    2x(bs=1) equals one bs=2 pass up to reduction order."""
    from enarf_gan_tpu.training import dso
    config = tiny_dso_config(synth_root, str(tmp_path))
    config.dataset.bs = 2
    config.generator_params.nerf_params.tile_patch = 4
    config.generator_params.nerf_params.plane_sample_dtype = "bfloat16"
    train_ds = SSODataset(config.dataset.train, size=32,
                          return_bone_params=True, return_mask=True,
                          num_repeat_in_epoch=4)
    loader = DataLoader(train_ds, 1, seed=0)
    gen = dso.build_generator(config, train_ds.num_bone, train_ds.parents)
    item = next(iter(loader))
    batch1 = dso.prepare_batch(item)
    # duplicate the item → bs=2 batch whose halves are identical
    batch2 = {k: jnp.concatenate([v, v], axis=0) for k, v in batch1.items()}
    rng = jax.random.PRNGKey(0)
    variables, tx, opt_state = dso.init_state(
        config, gen, train_ds.canonical_pose, rng, batch1)

    step1 = dso.make_train_step(gen, tx, config.loss,
                                config.dataset.bg_color, n_accum=1)
    step2 = dso.make_train_step(gen, tx, config.loss,
                                config.dataset.bg_color, n_accum=2)
    # same PRNG folds: accum splits rng into per-micro keys, the single
    # pass uses one key — use identical per-half content and compare the
    # LOSSES (content-deterministic) + finiteness and that params move
    v1, o1, m1 = step1(variables, opt_state, rng, batch2)
    v2, o2, m2 = step2(variables, opt_state, rng, batch2)
    for m in (m1, m2):
        for k, v in m.items():
            assert np.isfinite(float(v)), (k, v)
    # both must have moved the params in a broadly similar way (the ray
    # samplers draw different pixels per key, so exact equality only holds
    # per-micro; loss scale must agree)
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 0.5 * max(
        1.0, abs(float(m1["loss"])))
    moved = jax.tree_util.tree_map(
        lambda a, b: float(jnp.abs(a - b).max()),
        v2["params"], variables["params"])
    assert max(jax.tree_util.tree_leaves(moved)) > 0


def test_gan_steps_smoke(synth_root, tmp_path):
    from enarf_gan_tpu.training import gan
    config = tiny_gan_config(synth_root, str(tmp_path))
    img_ds = HumanDataset(AttrDict({"data_root": synth_root}), size=32,
                          return_bone_params=False, num_repeat_in_epoch=10)
    pose_ds = HumanPoseDataset(size=32, data_root=synth_root,
                               num_repeat_in_epoch=10)
    loader_img = DataLoader(img_ds, config.dataset.bs, seed=0)
    loader_pose = DataLoader(pose_ds, config.dataset.bs, seed=1)
    gen, dis = gan.build_models(config, pose_ds.num_bone, pose_ds.parents)
    state, history = gan.train_loop(
        config, gen, dis, (img_ds, pose_ds), (loader_img, loader_pose),
        pose_ds.canonical_pose, verbose=False)
    assert len(history) == 5
    for h in history:
        for k, v in h.items():
            assert np.isfinite(v), (k, v)
    # r1 ran at iteration 0
    assert "r1_reg" in history[0]
    out_dir = os.path.join(config.out_root, "result", config.out)
    assert os.path.exists(os.path.join(out_dir, "real.png"))
