"""Volume-render throughput benchmark on one GPU.

Workload: DSO-demo-style full-image render of a 24-joint articulated
tri-plane NARF at reference scale — Nc=48 coarse + Nf=64 fine samples per ray,
256² tri-planes, 23 bone frames (configs/DSO_train/NeuralActor/lan_denarf.yml,
DSO_demo.py:23). Reports Mrays/sec on one card.

Both sampler formulations are timed and the faster one is reported:
  * tilewin patch-window shared fetches (ops/tilewin.py, tile_patch=4)
  * exact per-member unirow fused rows (ops/unirow.py)
Force one with BENCH_TILED=4 / BENCH_TILED=0. A variant that fails fails
the run. Exits non-zero unless JAX runs on a GPU.

Prints the card, then ONE JSON line:
    {"metric": "volume_render_mrays_per_sec", "value": N, "unit": "Mrays/s",
     "variant": "tilewin4|exact", "all_ms_per_frame": {...}, "device": {...}}
"""
import json
import os
import sys
import time

import numpy as np


def build_renderer(tile_patch, render_size=128, ray_chunk=4096, Nc=48, Nf=64,
                   plane_size=256, hidden=256, plane_dtype="bfloat16",
                   coarse_corners=True, focal_scale=1.2):
    """(jitted full-frame renderer, its args) for the bench scene.

    ``focal_scale`` 1.2 is the dense scene (~87% of rays valid); 0.35 gives
    a ZJU-like sparse frame (fg 10-20% of pixels).
    """
    import jax
    import jax.numpy as jnp
    from enarf_gan_tpu.models.narf import NARFParams
    from enarf_gan_tpu.models.generator import (DSONARFGenerator,
                                                register_canonical_pose,
                                                make_dso_full_renderer)
    from enarf_gan_tpu.geometry.smpl import SMPL_PARENTS
    from __graft_entry__ import _tiny_scene

    params = NARFParams(Nc=Nc, Nf=Nf, hidden_size=hidden,
                        tri_plane_size=plane_size, render_bs=ray_chunk,
                        coordinate_scale=3.0, view_dependent=False,
                        origin_location="center_fixed",
                        deformation_field=True, time_conditional=True,
                        pose_conditional=False,
                        plane_sample_dtype=plane_dtype,
                        tile_patch=tile_patch,
                        tile_coarse_corners=tile_patch > 0 and coarse_corners)
    gen = DSONARFGenerator(nerf_params=params, size=render_size, num_bone=24,
                           parent_id=tuple(int(x) for x in SMPL_PARENTS),
                           use_triplane=True, ray_batchsize=4096)
    pose_cam, world, bl, inv_K, canonical, K = _tiny_scene(
        1, render_size, focal_scale=focal_scale)
    rng = jax.random.PRNGKey(0)
    ft = jnp.array([0.5], jnp.float32)
    variables = jax.jit(gen.init)(rng, rng, jnp.asarray(pose_cam),
                                  jnp.asarray(world[:, 0, :3, :3]),
                                  jnp.ones((1, render_size, render_size)), ft,
                                  jnp.asarray(bl), jnp.asarray(inv_K))
    variables = register_canonical_pose(variables, canonical, "center_fixed",
                                        np.asarray(SMPL_PARENTS))
    renderer = make_dso_full_renderer(gen, render_size,
                                      ray_batchsize=ray_chunk,
                                      with_camera_pose=False)
    args = (variables, rng, jnp.asarray(pose_cam), jnp.asarray(inv_K), ft,
            jnp.asarray(bl))
    return renderer, args


def time_renderer(renderer, args, reps):
    """(compile + first frame s, steady s/frame, last frame). Each frame
    ends in block_until_ready; each rep uses a fresh fine-sampling key."""
    import jax
    variables, _, *rest = args
    t0 = time.perf_counter()
    out = jax.block_until_ready(renderer(*args))
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for i in range(reps):
        out = jax.block_until_ready(
            renderer(variables, jax.random.PRNGKey(i + 1), *rest))
    return compile_s, (time.perf_counter() - t0) / reps, out


def main():
    from enarf_gan_tpu.utils.platform import (nvidia_smi_gpu, require_gpu,
                                              setup_jax)
    setup_jax()
    dev = require_gpu()
    import jax
    gpu = nvidia_smi_gpu()
    print(gpu, flush=True)

    render_size = int(os.environ.get("BENCH_RENDER_SIZE", 128))
    kw = dict(render_size=render_size,
              ray_chunk=int(os.environ.get("BENCH_RAY_CHUNK", 4096)),
              Nc=int(os.environ.get("BENCH_NC", 48)),
              Nf=int(os.environ.get("BENCH_NF", 64)),
              plane_dtype=os.environ.get("BENCH_PLANE_DTYPE", "bfloat16"),
              coarse_corners=os.environ.get("BENCH_COARSE_CORNERS", "1") == "1",
              focal_scale=float(os.environ.get("BENCH_FOCAL_SCALE", 1.2)))
    reps = int(os.environ.get("BENCH_REPS", 5))
    forced = os.environ.get("BENCH_TILED")
    variants = [int(forced)] if forced is not None else [4, 0]

    ms = {}
    for tp in variants:
        name = f"tilewin{tp}" if tp else "exact"
        renderer, args = build_renderer(tp, **kw)
        compile_s, dt, out = time_renderer(renderer, args, reps)
        if not all(np.isfinite(np.asarray(o)).all()
                   for o in jax.tree_util.tree_leaves(out)):
            raise FloatingPointError(f"{name}: non-finite frame")
        print(f"# {name}: compile+first frame {compile_s:.1f} s, "
              f"{dt * 1e3:.2f} ms/frame", file=sys.stderr, flush=True)
        ms[name] = dt * 1e3
    best = min(ms, key=ms.get)
    print(json.dumps({"metric": "volume_render_mrays_per_sec",
                      "value": render_size * render_size / ms[best] / 1e3,
                      "unit": "Mrays/s", "variant": best,
                      "all_ms_per_frame": ms, "gpu": gpu,
                      "device": {"platform": dev.platform,
                                 "kind": dev.device_kind,
                                 "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
