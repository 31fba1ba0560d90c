"""Production-shape benchmarks on one GPU.

Two workloads at the reference's shipped production scales:

* ``dso512``  — DSO training step at 512² images, ray_batchsize 4096,
  Nc48/Nf64, deformation field, 256² planes
  (configs/DSO_train/ZJU/313_denarf.yml: bs 16, size 512). Batch size
  comes from BENCH_BS (try 16 first; record what fits).
* ``demo1024`` — full-image 1024² demo frame (1.05M rays), render_bs 8192
  (configs/DSO_demo/NeuralActor/lan_denarf.yml:16, DSO_demo.py:23).

Synthetic in-memory batches (the data pipeline is not under test).
Prints one JSON line per workload with s/iter or s/frame and peak device
memory. Every timed call ends in block_until_ready.

Env: BENCH_WORKLOAD=dso512|demo1024|all, BENCH_BS, BENCH_ITERS,
BENCH_TILED (tile_patch, default 4; 0 = exact per-member sampler).
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def _params(render_bs, tile_patch):
    from enarf_gan_tpu.models.narf import NARFParams
    return NARFParams(Nc=48, Nf=64, hidden_size=256, tri_plane_size=256,
                      render_bs=render_bs, coordinate_scale=3.0,
                      view_dependent=False, origin_location="center_fixed",
                      deformation_field=True, time_conditional=True,
                      pose_conditional=False, plane_sample_dtype="bfloat16",
                      tile_patch=tile_patch)


def _peak_hbm_gb():
    from enarf_gan_tpu.utils.introspect import device_memory_stats
    stats = device_memory_stats() or {}
    peak = stats.get("peak_bytes_in_use") or stats.get("bytes_in_use") or 0
    return round(peak / 2**30, 2)


def _scene(bs, size):
    from __graft_entry__ import _tiny_scene
    import jax.numpy as jnp
    pose_cam, world, bl, inv_K, canonical, K = _tiny_scene(bs, size)
    return (jnp.asarray(pose_cam), jnp.asarray(world[:, 0, :3, :3]),
            jnp.asarray(bl), jnp.asarray(inv_K), canonical)


def bench_dso512(tile_patch):
    import jax
    import jax.numpy as jnp
    import optax
    from enarf_gan_tpu.config import AttrDict
    from enarf_gan_tpu.geometry.smpl import SMPL_PARENTS
    from enarf_gan_tpu.models.generator import (DSONARFGenerator,
                                                register_canonical_pose)
    from enarf_gan_tpu.training import dso

    size = 512
    bs = int(os.environ.get("BENCH_BS", 16))
    iters = int(os.environ.get("BENCH_ITERS", 30))
    gen = DSONARFGenerator(nerf_params=_params(4096, tile_patch), size=size,
                           num_bone=24,
                           parent_id=tuple(int(x) for x in SMPL_PARENTS),
                           use_triplane=True, ray_batchsize=4096)
    pose_cam, cam_rot, bl, inv_K, canonical = _scene(bs, size)
    rng = jax.random.PRNGKey(0)
    rs = np.random.RandomState(0)
    batch = {
        "img": jnp.asarray(rs.uniform(-1, 1, (bs, 3, size, size))
                           .astype(np.float32)),
        "mask": jnp.asarray((rs.uniform(0, 1, (bs, size, size)) > 0.6)
                            .astype(np.float32)),
        "pose_3d": pose_cam, "camera_rotation": cam_rot,
        "frame_time": jnp.asarray(np.linspace(0, 1, bs, dtype=np.float32)),
        "bone_length": bl, "inv_intrinsics": inv_K,
    }
    variables = gen.init(rng, rng, batch["pose_3d"],
                         batch["camera_rotation"], batch["mask"],
                         batch["frame_time"], batch["bone_length"],
                         batch["inv_intrinsics"])
    variables = register_canonical_pose(variables, canonical, "center_fixed",
                                        np.asarray(SMPL_PARENTS))
    tx = optax.adam(1e-3, b1=0.9, b2=0.99)
    opt_state = tx.init(variables["params"])
    loss_cfg = AttrDict({"nerf_loss_type": "mse", "color_coef": 1.0,
                         "mask_coef": 1.0})
    step = dso.make_train_step(gen, tx, loss_cfg, bg_color=-1.0)

    t0 = time.perf_counter()
    variables, opt_state, metrics = step(variables, opt_state,
                                         jax.random.PRNGKey(1), batch)
    jax.block_until_ready(metrics)
    compile_s = time.perf_counter() - t0
    print(f"# dso512 compile+first step: {compile_s:.1f}s", file=sys.stderr)

    t0 = time.perf_counter()
    for i in range(iters):
        variables, opt_state, metrics = step(variables, opt_state,
                                             jax.random.PRNGKey(2 + i), batch)
    jax.block_until_ready((variables, metrics))
    dt = (time.perf_counter() - t0) / iters
    loss = float(metrics["loss"])
    assert np.isfinite(loss), loss
    print(json.dumps({
        "metric": "dso512_train_s_per_iter", "value": round(dt, 4),
        "unit": "s/iter", "bs": bs, "tile_patch": tile_patch,
        "peak_hbm_gb": _peak_hbm_gb(), "compile_s": round(compile_s, 1),
        "loss": round(loss, 4)}))


def bench_demo1024(tile_patch):
    import jax
    import jax.numpy as jnp
    from enarf_gan_tpu.geometry.smpl import SMPL_PARENTS
    from enarf_gan_tpu.models.generator import (DSONARFGenerator,
                                                register_canonical_pose,
                                                make_dso_full_renderer)

    size = 1024
    render_bs = int(os.environ.get("BENCH_RENDER_BS", 8192))
    reps = int(os.environ.get("BENCH_REPS", 3))
    gen = DSONARFGenerator(nerf_params=_params(render_bs, tile_patch),
                           size=size, num_bone=24,
                           parent_id=tuple(int(x) for x in SMPL_PARENTS),
                           use_triplane=True, ray_batchsize=4096)
    pose_cam, cam_rot, bl, inv_K, canonical = _scene(1, size)
    rng = jax.random.PRNGKey(0)
    ft = jnp.array([0.5], jnp.float32)
    variables = gen.init(rng, rng, pose_cam, cam_rot,
                         jnp.ones((1, size, size)), ft, bl, inv_K)
    variables = register_canonical_pose(variables, canonical, "center_fixed",
                                        np.asarray(SMPL_PARENTS))
    renderer = make_dso_full_renderer(gen, size, ray_batchsize=render_bs,
                                      with_camera_pose=False)

    t0 = time.perf_counter()
    out = jax.block_until_ready(
        renderer(variables, jax.random.PRNGKey(1), pose_cam, inv_K, ft, bl))
    compile_s = time.perf_counter() - t0
    print(f"# demo1024 compile+first render: {compile_s:.1f}s",
          file=sys.stderr)

    t0 = time.perf_counter()
    for i in range(reps):
        out = jax.block_until_ready(
            renderer(variables, jax.random.PRNGKey(2 + i), pose_cam, inv_K,
                     ft, bl))
    dt = (time.perf_counter() - t0) / reps
    assert np.isfinite(np.asarray(out[0])).all()
    print(json.dumps({
        "metric": "demo1024_s_per_frame", "value": round(dt, 3),
        "unit": "s/frame", "mrays_per_s": round(size * size / dt / 1e6, 3),
        "tile_patch": tile_patch, "render_bs": render_bs,
        "peak_hbm_gb": _peak_hbm_gb(), "compile_s": round(compile_s, 1)}))


def main():
    from enarf_gan_tpu.utils.platform import require_gpu, setup_jax
    setup_jax()
    require_gpu()
    tile_patch = int(os.environ.get("BENCH_TILED", 4))
    which = os.environ.get("BENCH_WORKLOAD", "all")
    if which in ("dso512", "all"):
        bench_dso512(tile_patch)
    if which in ("demo1024", "all"):
        bench_demo1024(tile_patch)


if __name__ == "__main__":
    main()
