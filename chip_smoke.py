"""Smoke run of the main path on one GPU, at the reference models' widths.

Usage, from the repository root: ``python chip_smoke.py``

One process, one card. Phases, in order:

  1. device          platform, kind, count, the card's name and power limit
                     (nvidia-smi), JAX versions, compile cache, matmul
                     precision;
  2. sampler parity  the quad (f32), unirow (bf16) and tilewin4 (bf16)
                     tri-plane samplers, forward and VJP, against the f32
                     grid-sample oracle (ops/triplane.py + ops/grid_sample.py)
                     on one 4096-ray x 48-sample chunk of 256² planes, F=32,
                     24 joints, M=4 candidates, each timed as XLA compiles it;
  3. render          the bench.py scene (128² dense frame, Nc48/Nf64, hidden
                     256): exact and tilewin4 ms/frame; exact at the default
                     matmul precision vs "highest"; tilewin vs exact;
  4. DSO train       train_DSO.main on configs/DSO_train/ZJU/313_denarf.yml
                     (512², bs 16) over synthetic data made from a seed;
  5. DSO demo        DSO_demo.main renders one frame from phase 4's snapshot;
  6. GAN train       train_ENARF_GAN.main on configs/enarfgan_train/AIST/
                     config.yml (128², bs 12, n_accum_step 2), R1 at iter 0.

Each phase prints one line with its numbers and wall time; any failure
raises. The last line is ``{"ok": true, "device": {...}}``. Exits non-zero,
without that line, unless JAX runs on a GPU.
"""
import argparse
import importlib
import importlib.util
import json
import os
import shutil
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, ".chip_smoke_work")

# Tolerances. bf16 keeps ~3 significant digits, hence 3e-2 for the bf16
# samplers (tests/test_tilewin.py uses the same); quad in f32 and the oracle
# both run at "highest" matmul precision, so they agree to f32 rounding.
QUAD_ATOL = 1e-4
BF16_TOL = 3e-2
# VJP: max |grad - oracle grad| relative to max |oracle grad|. The bf16
# samplers scatter-add bf16 cotangents into the packed tables.
QUAD_VJP_REL = 1e-4
BF16_VJP_REL = 3e-2
# exact frame at the default matmul precision vs "highest": a float32
# matmul may run in TF32 on this card (10-bit mantissa, ~1e-3 relative) in
# the StyleGAN planes and the MLP heads, and the inverse-CDF fine sampler
# turns a small change of the coarse weights into shifted fine depths at
# silhouette pixels. Colour lives in [-1, 1]; an H100 80GB HBM3 (400 W)
# measured max|Δ| 0.047, so the bound is 0.1.
PRECISION_COLOR_ATOL = 1e-1
# tilewin vs exact full frame: tests/test_tiled_render.py's metric bar
TILE_PSNR_MIN, TILE_MASK_MAD_MAX = 24.0, 0.15


def _say(msg: str):
    print(msg, flush=True)


def _peak_bytes() -> str:
    import jax
    stats = jax.devices()[0].memory_stats()
    if not stats or "peak_bytes_in_use" not in stats:
        return "peak_bytes_in_use=n/a"
    return f"peak_bytes_in_use={stats['peak_bytes_in_use']}"


# --------------------------------------------------------------------- #
# 1. device
# --------------------------------------------------------------------- #
def phase_device() -> dict:
    import jax
    import jaxlib
    from enarf_gan_tpu.utils.platform import compile_cache_dir, setup_jax
    dev = setup_jax(report=False)
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()), "jax": jax.__version__,
            "jaxlib": jaxlib.__version__,
            "compile_cache": compile_cache_dir(),
            "matmul_precision":
                str(jax.config.jax_default_matmul_precision or "default")}


# --------------------------------------------------------------------- #
# 2. sampler parity
# --------------------------------------------------------------------- #
def _oracle(planes, cand_pos, cand_idx, cand_valid, F):
    """f32 grid-sample reference: (feature (B,F,n), cand_w (B,n,M))."""
    from enarf_gan_tpu.ops.triplane import (sample_part_prob_candidates,
                                            sample_weighted_feature_candidates)
    w = sample_part_prob_candidates(planes[:, F * 3:], cand_idx, cand_pos)
    f = sample_weighted_feature_candidates(F, planes[:, :F * 3], cand_pos, w,
                                           cand_valid)
    return f, w


def _close(a, b, atol, rtol, mask=None):
    """(max |a-b|, all |a-b| <= atol + rtol |b|) over ``mask``."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if mask is not None:
        a, b = a[mask], b[mask]
    d = np.abs(a - b)
    return float(d.max()), bool((d <= atol + rtol * np.abs(b)).all())


def _timed(fn, *args, reps=3):
    """(compile + first call s, steady ms/call, output); block_until_ready."""
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(reps):
        out = jax.block_until_ready(fn(*args))
    return first, (time.perf_counter() - t0) / reps * 1e3, out


def phase_sampler_parity(plane_size=256, feat_dim=32, num_bone=23, n_cand=4,
                         n_rays=4096, n_samples=48, patch=4, seed=0) -> dict:
    """Every sampler the configs can reach vs the oracle, forward and VJP.

    quad/unirow/oracle take per-point candidates (B, n, M, 3); tilewin takes
    per-(patch, sample) slots whose member positions cluster within ~1.5
    texels (the locality it is built for), converted to the same per-point
    candidates for its oracle. Returns max |Δ| per comparison and ms per
    forward as XLA compiles it on this device. Every array is a jit
    argument: closed-over arrays would be folded into the program as
    constants.
    """
    import jax
    import jax.numpy as jnp
    from enarf_gan_tpu.ops.quadtable import (pack_quadtable,
                                             sample_candidates_quadtable)
    from enarf_gan_tpu.ops.tilewin import pack_tilewin, sample_tilewin
    from enarf_gan_tpu.ops.unirow import pack_unirow, sample_candidates_unirow

    F, K, M, TS, B = feat_dim, num_bone, n_cand, plane_size, 1
    n = n_rays * n_samples
    ks = jax.random.split(jax.random.PRNGKey(seed), 12)
    planes = jax.random.normal(ks[0], (B, (F + K) * 3, TS, TS), jnp.float32)
    valid = jax.random.uniform(ks[1], (B, n, M)) > 0.25
    pos = jax.random.uniform(ks[2], (B, n, M, 3), minval=-0.99, maxval=0.99)
    pos = jnp.where(valid[..., None], pos, 2.0)  # invalid slots sit outside
    idx = jax.random.randint(ks[3], (B, n, M), 0, K, jnp.int32)
    cot = (jax.random.normal(ks[4], (B, F, n)),
           jax.random.normal(ks[5], (B, n, M)))

    samplers = {
        "quad": lambda pl, p, i, v: sample_candidates_quadtable(
            pack_quadtable(pl, F, K, jnp.float32), p, i, v, F, K, TS, TS),
        "unirow": lambda pl, p, i, v: sample_candidates_unirow(
            pack_unirow(pl, F, K), p, i, v, F, K, TS, TS),
        "gridsample": lambda pl, p, i, v: _oracle(pl, p, i, v, F),
    }

    def vjp(name):
        """jitted d/dplanes of <cot, (feature, valid * cand_w)>."""
        def loss(pl, p, i, v, cot):
            f, w = samplers[name](pl, p, i, v)
            return (f * cot[0]).sum() + (w * v * cot[1]).sum()
        return jax.jit(jax.grad(loss))

    args = (planes, pos, idx, valid)
    out, checks = {}, []
    with jax.default_matmul_precision("highest"):
        _, out["gridsample_ms"], (f_ref, w_ref) = _timed(
            jax.jit(samplers["gridsample"]), *args)
        g_ref = np.asarray(vjp("gridsample")(*args, cot))
        fq, wq = jax.jit(samplers["quad"])(*args)
        g_q = np.asarray(vjp("quad")(*args, cot))
    _, out["quad_ms"], _ = _timed(jax.jit(samplers["quad"]), *args)
    gmax = float(np.abs(g_ref).max())
    d, ok = _close(fq, f_ref, QUAD_ATOL, 0)
    checks.append(("quad_feature", d, QUAD_ATOL, ok))
    d, ok = _close(wq, w_ref, QUAD_ATOL, 0)
    checks.append(("quad_w", d, QUAD_ATOL, ok))
    d = float(np.abs(g_q - g_ref).max()) / gmax
    checks.append(("quad_vjp_rel", d, QUAD_VJP_REL, d <= QUAD_VJP_REL))

    _, out["unirow_ms"], (fu, wu) = _timed(jax.jit(samplers["unirow"]), *args)
    g_u = np.asarray(vjp("unirow")(*args, cot))
    d, ok = _close(fu, f_ref, BF16_TOL, BF16_TOL)
    checks.append(("unirow_feature", d, BF16_TOL, ok))
    d, ok = _close(wu, w_ref, BF16_TOL, BF16_TOL)
    checks.append(("unirow_w", d, BF16_TOL, ok))
    d = float(np.abs(g_u - g_ref).max()) / gmax
    checks.append(("unirow_vjp_rel", d, BF16_VJP_REL, d <= BF16_VJP_REL))

    # tilewin: clustered members per (patch, sample, slot)
    m, n_patch = patch * patch, n_rays // (patch * patch)
    centers = jax.random.uniform(ks[6], (B, 3, M, n_patch, 1, n_samples),
                                 minval=-0.85, maxval=0.85)
    jitter = jax.random.uniform(ks[7], (B, 3, M, n_patch, m, n_samples),
                                minval=-1.5 / TS, maxval=1.5 / TS)
    tpos = jnp.clip(centers + jitter, -0.99, 0.99)
    slot = jax.random.randint(ks[8], (B, M, n_patch, n_samples), 0, K,
                              jnp.int32)
    tvalid = jax.random.uniform(ks[9], (B, M, n_patch, m, n_samples)) > 0.25
    # the same candidates per point, point order (patch*m + member)*S + s
    c_pos = tpos.transpose(0, 3, 4, 5, 2, 1).reshape(B, n, M, 3)
    c_idx = jnp.broadcast_to(slot.transpose(0, 2, 3, 1)[:, :, None],
                             (B, n_patch, m, n_samples, M)).reshape(B, n, M)
    c_valid = tvalid.transpose(0, 2, 3, 4, 1).reshape(B, n, M)

    def tile_fwd(pl, p, sl, v):
        f, w, stats = sample_tilewin(pack_tilewin(pl, F, K), p, sl, v,
                                     with_stats=True)
        return f, w.transpose(0, 2, 3, 4, 1).reshape(B, n, M), stats

    def tile_loss(pl, p, sl, v, cv, cot):
        f, w, _ = tile_fwd(pl, p, sl, v)
        return (f * cot[0]).sum() + (w * cv * cot[1]).sum()

    c_args = (planes, c_pos, c_idx, c_valid)
    t_args = (planes, tpos, slot, tvalid)
    with jax.default_matmul_precision("highest"):
        f_tref, w_tref = jax.jit(samplers["gridsample"])(*c_args)
        g_tref = np.asarray(vjp("gridsample")(*c_args, cot))
    _, out["tilewin4_ms"], (ft, wt, stats) = _timed(jax.jit(tile_fwd), *t_args)
    g_t = np.asarray(jax.jit(jax.grad(tile_loss))(*t_args, c_valid, cot))
    if float(stats["clamped"]) != 0.0:
        raise AssertionError(f"tilewin clamped {float(stats['clamped'])} of "
                             "member fetches; parity inputs must fit windows")
    d, ok = _close(ft, f_tref, BF16_TOL, BF16_TOL)
    checks.append(("tilewin4_feature", d, BF16_TOL, ok))
    d, ok = _close(wt, w_tref, BF16_TOL, BF16_TOL, mask=np.asarray(c_valid))
    checks.append(("tilewin4_w", d, BF16_TOL, ok))
    d = float(np.abs(g_t - g_tref).max()) / float(np.abs(g_tref).max())
    checks.append(("tilewin4_vjp_rel", d, BF16_VJP_REL, d <= BF16_VJP_REL))

    for name, d, lim, ok in checks:
        out[name] = d
        out[name + "_limit"] = lim
    bad = [f"{name} {d:.3g} > {lim:g}" for name, d, lim, ok in checks if not ok]
    if bad:
        raise AssertionError("sampler parity failed: " + "; ".join(bad)
                             + " | " + _fmt(out))
    return out


# --------------------------------------------------------------------- #
# 3. full-frame render
# --------------------------------------------------------------------- #
def _perturb_params(variables, scale=0.3, seed=7):
    """Jitter every parameter: a fresh DSO model renders an all-zero mask
    (zero-init density head), which would make frame comparisons vacuous."""
    import jax
    leaves, treedef = jax.tree_util.tree_flatten(variables["params"])
    keys = jax.random.split(jax.random.PRNGKey(seed), len(leaves))
    leaves = [x + scale * jax.random.normal(k, x.shape, x.dtype)
              for x, k in zip(leaves, keys)]
    return dict(variables, params=jax.tree_util.tree_unflatten(treedef, leaves))


def _psnr(a, b) -> float:
    mse = float(((np.asarray(a, np.float64) - np.asarray(b)) ** 2).mean())
    return 20 * np.log10(2.0) - 10 * np.log10(max(mse, 1e-12))


def phase_render(render_size=128, Nc=48, Nf=64, plane_size=256, hidden=256,
                 ray_chunk=4096, reps=5) -> dict:
    import jax
    from bench import build_renderer, time_renderer

    renderer_e, args = build_renderer(0, render_size, ray_chunk, Nc, Nf,
                                      plane_size, hidden)
    renderer_t, _ = build_renderer(4, render_size, ray_chunk, Nc, Nf,
                                   plane_size, hidden)
    args = (_perturb_params(args[0]),) + args[1:]
    out = {}
    for name, renderer in (("exact", renderer_e), ("tilewin4", renderer_t)):
        first, dt, frame = time_renderer(renderer, args, reps)
        if not all(np.isfinite(np.asarray(x)).all()
                   for x in jax.tree_util.tree_leaves(frame)):
            raise FloatingPointError(f"{name}: non-finite frame")
        out[f"{name}_compile_first_s"] = first
        out[f"{name}_ms_per_frame"] = dt * 1e3

    c_e, m_e, _ = renderer_e(*args)
    c_t, m_t, _ = renderer_t(*args)
    with jax.default_matmul_precision("highest"):
        c_h, _, _ = renderer_e(*args)
    c_e, m_e, c_t, m_t, c_h = map(np.asarray, (c_e, m_e, c_t, m_t, c_h))
    fg = float((m_e > 0.05).mean())
    if fg < 0.05:
        raise AssertionError(f"degenerate foreground: {fg:.3f} of pixels")
    out["fg_fraction"] = fg
    out["precision_color_max_abs"] = float(np.abs(c_e - c_h).max())
    out["precision_color_limit"] = PRECISION_COLOR_ATOL
    out["precision_color_mean_abs"] = float(np.abs(c_e - c_h).mean())
    out["tile_vs_exact_psnr_db"] = _psnr(c_t, c_e)
    out["tile_vs_exact_mask_mad"] = float(np.abs(m_t - m_e).mean())
    if out["precision_color_max_abs"] > PRECISION_COLOR_ATOL:
        raise AssertionError("default vs highest precision: " + _fmt(out))
    if not (out["tile_vs_exact_psnr_db"] > TILE_PSNR_MIN
            and out["tile_vs_exact_mask_mad"] < TILE_MASK_MAD_MAX):
        raise AssertionError("tilewin vs exact: " + _fmt(out))
    return out


# --------------------------------------------------------------------- #
# 4-6. the training and demo CLIs, in-process
# --------------------------------------------------------------------- #
def _write_config(path, config, default, overrides):
    """Merge ``config`` over ``default`` and then ``overrides``; write the
    full result as one YAML file for a CLI's --config."""
    import yaml
    from enarf_gan_tpu.config import merge_config, yaml_config
    cfg = merge_config(overrides, yaml_config(config, default))
    for injected in ("resume_latest", "num_workers"):
        cfg.pop(injected, None)
        cfg.get("dataset", {}).pop(injected, None)
    with open(path, "w") as f:
        yaml.safe_dump(cfg.to_dict(), f)
    return cfg


def _read_metrics(path):
    """metrics.jsonl → ({iter: {name: value}}, {iter: last timestamp})."""
    by_iter, t_iter = {}, {}
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            it, t = rec.pop("iter"), rec.pop("t")
            by_iter.setdefault(it, {}).update(rec)
            t_iter[it] = max(t, t_iter.get(it, t))
    return by_iter, t_iter


def _steady_s_per_iter(t_iter) -> float:
    its = sorted(t_iter)
    return (t_iter[its[-1]] - t_iter[its[0]]) / (its[-1] - its[0])


def _run_cli(module_name, argv):
    """Call a root-level CLI's main(argv) in this process."""
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    importlib.import_module(module_name).main(argv)


def phase_dso_train(work, size=512, n_frames=4, n_camera=4, iters=6,
                    n_accum=1, overrides=None) -> dict:
    from enarf_gan_tpu.data.fixtures import make_synthetic_human_cache
    synth = os.path.join(work, "dso_data")
    make_synthetic_human_cache(synth, size=size, n_frames=n_frames,
                               n_camera=n_camera, seed=0)
    run = {"out_root": os.path.join(work, "out"), "out": "dso",
           "n_accum_step": n_accum,
           "print_interval": 1, "tensorboard_interval": 1,
           "save_interval": iters, "val_interval": iters + 1,
           "dataset": {"image_size": size,
                       "train": {"data_root": synth, "n_frames": n_frames,
                                 "n_camera": n_camera},
                       "val": {k: {"data_root": None} for k in
                               ("train", "novel_view", "novel_pose")}}}
    default = os.path.join(REPO, "configs/DSO_train/default.yml")
    path = os.path.join(work, "dso_train.yml")
    from enarf_gan_tpu.config import merge_config
    cfg = _write_config(path, os.path.join(
        REPO, "configs/DSO_train/ZJU/313_denarf.yml"), default,
        merge_config(overrides or {}, run))
    _run_cli("train_DSO", ["--config", path, "--default_config", default,
                           "--iterations", str(iters)])
    by_iter, t_iter = _read_metrics(os.path.join(work, "out", "runs", "dso",
                                                 "metrics.jsonl"))
    losses = [by_iter[i]["gen"] for i in sorted(by_iter)]
    if len(losses) != iters or not np.isfinite(losses).all():
        raise AssertionError(f"DSO losses: {losses}")
    return {"bs": cfg.dataset.bs, "size": size, "n_accum_step": n_accum,
            "hidden": cfg.generator_params.nerf_params.hidden_size,
            "iters": iters, "loss_first": losses[0], "loss_last": losses[-1],
            "s_per_iter_after_first": _steady_s_per_iter(t_iter)}


def phase_dso_demo(work, overrides=None) -> dict:
    spec = importlib.util.spec_from_file_location(
        "prepare_sample_data",
        os.path.join(REPO, "data_preprocess/prepare_sample_data.py"))
    prep = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(prep)
    synth = os.path.join(work, "dso_data")
    samples = os.path.join(work, "dso_samples")
    prep.main(["--data_root", synth, "--out", samples, "--num", "1"])

    from enarf_gan_tpu.config import merge_config
    run = {"out_root": os.path.join(work, "out"), "out": "dso",
           "sample_path": samples,
           "canonical_pose_path": os.path.join(synth, "canonical.npy")}
    default = os.path.join(REPO, "configs/DSO_demo/default.yml")
    path = os.path.join(work, "dso_demo.yml")
    cfg = _write_config(path, os.path.join(
        REPO, "configs/DSO_demo/ZJU/313_denarf.yml"), default,
        merge_config(overrides or {}, run))
    t0 = time.perf_counter()
    _run_cli("DSO_demo", ["--config", path, "--default_config", default,
                          "--render_bs",
                          str(cfg.generator_params.nerf_params.render_bs)])
    png = os.path.join(work, "out", "result", "dso", "samples", "0000.png")
    from PIL import Image
    img = np.asarray(Image.open(png))
    size = cfg.dataset.image_size
    if img.shape != (size, size, 3):
        raise AssertionError(f"demo frame {png}: shape {img.shape}")
    return {"size": size, "frame_png": os.path.relpath(png, work),
            "demo_main_s": time.perf_counter() - t0,
            "pixel_mean": float(img.mean())}


def phase_gan_train(work, size=128, n_frames=4, n_camera=4, iters=3,
                    overrides=None) -> dict:
    from enarf_gan_tpu.config import merge_config
    from enarf_gan_tpu.data.fixtures import make_synthetic_human_cache
    synth = os.path.join(work, "gan_data")
    make_synthetic_human_cache(synth, size=size, n_frames=n_frames,
                               n_camera=n_camera, seed=1)
    run = {"out_root": os.path.join(work, "out"), "out": "gan",
           "print_interval": 1, "tensorboard_interval": 1,
           "dataset": {"image_size": size,
                       "train": {"data_root": synth, "pose_prior_root": None}}}
    default = os.path.join(REPO, "configs/enarfgan_train/default.yml")
    path = os.path.join(work, "gan_train.yml")
    cfg = _write_config(path, os.path.join(
        REPO, "configs/enarfgan_train/AIST/config.yml"), default,
        merge_config(overrides or {}, run))
    _run_cli("train_ENARF_GAN", ["--config", path, "--default_config",
                                 default, "--iterations", str(iters)])
    by_iter, t_iter = _read_metrics(os.path.join(work, "out", "runs", "gan",
                                                 "metrics.jsonl"))
    if sorted(by_iter) != list(range(1, iters + 1)):
        raise AssertionError(f"GAN metrics for iterations {sorted(by_iter)}")
    first = by_iter[1]
    vals = [v for m in by_iter.values() for v in m.values()]
    if "r1_reg" not in first or not np.isfinite(vals).all():
        raise AssertionError(f"GAN metrics: {by_iter}")
    return {"bs": cfg.dataset.bs, "size": size,
            "n_accum_step": cfg.n_accum_step,
            "z_dim": cfg.generator_params.z_dim,
            "hidden": cfg.generator_params.nerf_params.hidden_size,
            "iters": iters, "G_last": by_iter[iters]["loss_gen"],
            "D_last": by_iter[iters]["adv_loss_dis"],
            "R1_iter0": first["r1_reg"],
            "s_per_iter_after_first": _steady_s_per_iter(t_iter)}


# --------------------------------------------------------------------- #
def _fmt(d: dict) -> str:
    return " ".join(f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
                    for k, v in d.items())


def main(argv=None):
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args(argv)
    from enarf_gan_tpu.utils.platform import nvidia_smi_gpu, require_gpu
    t_all = time.perf_counter()
    t0 = time.perf_counter()
    info = phase_device()
    dev = require_gpu()
    _say(nvidia_smi_gpu())
    _say(f"phase 1 device: {_fmt(info)} wall={time.perf_counter() - t0:.1f}s")

    phases = [("2 sampler parity", phase_sampler_parity),
              ("3 render", phase_render),
              ("4 DSO train", lambda: phase_dso_train(WORK)),
              ("5 DSO demo", lambda: phase_dso_demo(WORK)),
              ("6 GAN train", lambda: phase_gan_train(WORK))]
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    try:
        for name, fn in phases:
            t0 = time.perf_counter()
            res = fn()
            _say(f"phase {name}: {_fmt(res)} {_peak_bytes()} "
                 f"wall={time.perf_counter() - t0:.1f}s")
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    import jax
    _say(f"total wall={time.perf_counter() - t_all:.1f}s")
    print(json.dumps({"ok": True, "device": {"platform": dev.platform,
                                             "kind": dev.device_kind,
                                             "count": len(jax.devices())}}),
          flush=True)


if __name__ == "__main__":
    main()
