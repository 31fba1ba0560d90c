"""Process set-up shared by every entry point: compile cache and device report.

JAX's persistent compilation cache lives where ``JAX_COMPILATION_CACHE_DIR``
says (JAX reads the variable itself); when it is unset, at a fixed path
inside the checkout, ``<repo>/.jax_cache``. A fixed path matters: the
cache key includes it, so a directory that moves never hits.
"""
import os

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_CACHE_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def compile_cache_dir() -> str:
    """The directory JAX's persistent compile cache uses."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


def setup_jax(report: bool = True):
    """Configure the compile cache and print the device JAX runs on.

    Returns ``jax.devices()[0]``. Honours ``JAX_PLATFORMS`` (the tests run
    with ``JAX_PLATFORMS=cpu``).
    """
    import jax
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(DEFAULT_CACHE_DIR, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    dev = jax.devices()[0]
    if report:
        print(f"device: platform={dev.platform} kind={dev.device_kind} "
              f"count={len(jax.devices())}", flush=True)
    return dev


def nvidia_smi_gpu() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them."""
    import subprocess
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip()


def require_gpu():
    """``jax.devices()[0]`` if it is a GPU, else ``SystemExit`` (non-zero).

    For measurement entry points: a number taken on another device must
    not pass for a GPU number.
    """
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU: JAX runs on {dev.platform} "
                         f"({dev.device_kind}); this run needs a GPU")
    return dev
