"""chip_smoke.py's phases at tiny sizes on the CPU, and the refusals.

The script itself runs on a GPU only; here each phase function runs at toy
widths to keep its control flow, CLI wiring and checks covered. Whether
there is a card is decided inside the tests (the platform JAX reports),
never at import.
"""
import json
import os
import shutil
import subprocess
import sys

import jax
import pytest

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NERF = {"generator_params": {"ray_batchsize": 64, "nerf_params": {
    "w_dim": 32, "tri_plane_size": 16, "hidden_size": 16, "Nc": 4, "Nf": 4,
    "render_bs": 256}}}


def _finite(d):
    return all(v == v and abs(v) != float("inf")
               for v in d.values() if isinstance(v, float))


def test_phase_device():
    info = chip_smoke.phase_device()
    assert info["platform"] == jax.devices()[0].platform
    assert info["count"] == len(jax.devices())
    assert info["compile_cache"]


def test_phase_sampler_parity():
    out = chip_smoke.phase_sampler_parity(plane_size=16, num_bone=6,
                                          n_rays=64, n_samples=4)
    assert _finite(out)
    for name in ("quad_feature", "unirow_vjp_rel", "tilewin4_w"):
        assert out[name] <= out[name + "_limit"]


def test_phase_render():
    out = chip_smoke.phase_render(render_size=32, Nc=8, Nf=8, plane_size=32,
                                  hidden=16, ray_chunk=1024, reps=1)
    assert _finite(out)
    assert out["tile_vs_exact_psnr_db"] > chip_smoke.TILE_PSNR_MIN


@pytest.fixture(scope="module")
def dso_run(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("smoke_dso"))
    out = chip_smoke.phase_dso_train(
        work, size=32, n_frames=2, n_camera=2, iters=3,
        overrides={"dataset": {"bs": 2}, **NERF})
    return work, out


def test_phase_dso_train(dso_run):
    _, out = dso_run
    assert out["iters"] == 3 and out["bs"] == 2
    assert _finite(out) and out["s_per_iter_after_first"] > 0


def test_phase_dso_demo(dso_run):
    work, _ = dso_run
    out = chip_smoke.phase_dso_demo(
        work, overrides={**NERF, "dataset": {"image_size": 32}})
    assert out["size"] == 32 and _finite(out)


def test_phase_gan_train(tmp_path):
    out = chip_smoke.phase_gan_train(
        str(tmp_path), size=32, n_frames=2, n_camera=2, iters=3,
        overrides={"dataset": {"bs": 2},
                   "discriminator_params": {"channel_max": 32},
                   "generator_params": {"z_dim": 16, "channel_max": 32,
                                        "nerf_params": {
                                            "w_dim": 32, "tri_plane_size": 16,
                                            "hidden_size": 16, "Nc": 4,
                                            "Nf": 4}}})
    assert out["n_accum_step"] == 2 and _finite(out)


def test_main_refuses_without_gpu(capsys):
    if jax.devices()[0].platform == "gpu":
        pytest.skip("a GPU is present: main() would run the full smoke")
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main([])
    assert exc.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_bench_refuses_without_gpu():
    if jax.devices()[0].platform == "gpu":
        pytest.skip("a GPU is present: bench.main() would run the bench")
    import bench
    with pytest.raises(SystemExit) as exc:
        bench.main()
    assert exc.value.code not in (0, None)


def test_script_alone_fails(tmp_path):
    """chip_smoke.py in a directory without the rest of the repository."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    last = (res.stdout.strip().splitlines() or [""])[-1]
    with pytest.raises(ValueError):
        json.loads(last)
