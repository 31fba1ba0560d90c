"""Test configuration: run everything on a virtual 8-device CPU mesh.

All sharding tests exercise real collectives over 8 XLA host devices
("test multi-device without a cluster", SURVEY.md §4). Must run before jax
is imported anywhere.
"""
import os

os.environ.setdefault("XLA_FLAGS",
                      "--xla_force_host_platform_device_count=8")
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ.setdefault("JAX_ENABLE_X64", "0")

import jax  # noqa: E402

jax.config.update("jax_default_matmul_precision", "float32")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.RandomState(0)


def perturb_params(variables, scale=0.3, seed=7):
    """Jitter every float param leaf of a module variables tree.

    Freshly-initialized DSO models render an identically-ZERO mask (the
    density head is zero-init), which silently turned several
    render-parity tests into comparisons of constant images. Perturbing
    the params gives the renders real structure; tests must ALSO assert
    the foreground is non-empty so the vacuous regime can't return."""
    import jax
    import jax.numpy as jnp
    leaves, treedef = jax.tree_util.tree_flatten(variables)
    keys = jax.random.split(jax.random.PRNGKey(seed), len(leaves))
    leaves = [l + scale * jax.random.normal(k, l.shape, l.dtype)
              if hasattr(l, "dtype") and jnp.issubdtype(l.dtype, jnp.floating)
              else l for l, k in zip(leaves, keys)]
    return jax.tree_util.tree_unflatten(treedef, leaves)
