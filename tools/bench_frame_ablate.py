"""Full-frame stage decomposition of the bench.py renderer on one GPU.

Times the bench.py workload (128² DSO frame, Nc48/Nf64, tilewin4,
corner-coarse) in three graph variants:

  full        the real frame (this is the headline number)
  nosampler   ENARF_ABLATE=sampler — window pack+gather+combine DCE'd
  noheads     ENARF_ABLATE=heads   — MLP heads DCE'd

frame = sampler + heads + rest, so the two ablations split the frame cost
directly. Each frame ends in block_until_ready. Env: BENCH_* knobs as in
bench.py, ABLATE_VARIANTS=csv subset, REPS.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))



def main():
    from enarf_gan_tpu.utils.platform import require_gpu, setup_jax
    setup_jax()
    require_gpu()
    import bench

    reps = int(os.environ.get("REPS", 3))
    render_size = int(os.environ.get("BENCH_RENDER_SIZE", 128))
    tp = int(os.environ.get("BENCH_TILED", 4))
    variants = [("full", None), ("nosampler", "sampler"),
                ("noheads", "heads")]
    sel = os.environ.get("ABLATE_VARIANTS")
    if sel:
        want = set(sel.split(","))
        variants = [v for v in variants if v[0] in want]

    results = {}
    for name, ablate in variants:
        # try/finally so ENARF_ABLATE can never leak past a variant — any
        # code run in-process afterwards would silently get stand-in
        # sampler/head outputs
        if ablate:
            os.environ["ENARF_ABLATE"] = ablate
        else:
            os.environ.pop("ENARF_ABLATE", None)
        try:
            t0 = time.perf_counter()
            renderer, args = bench.build_renderer(
                tp, render_size, int(os.environ.get("BENCH_RAY_CHUNK", 4096)),
                int(os.environ.get("BENCH_NC", 48)),
                int(os.environ.get("BENCH_NF", 64)))
            first, dt, _ = bench.time_renderer(renderer, args, reps)
            print(f"{name:10s} compile+first {first:6.1f}s", flush=True)
            results[name] = dt * 1e3
            print(f"{name:10s} {dt * 1e3:9.1f} ms/frame", flush=True)
        finally:
            os.environ.pop("ENARF_ABLATE", None)
    if "full" in results:
        full = results["full"]
        for k, v in results.items():
            if k != "full":
                print(f"# stage {k.replace('no', ''):8s} "
                      f"{full - v:8.1f} ms ({(full - v) / full * 100:.0f}%)",
                      flush=True)


if __name__ == "__main__":
    main()
