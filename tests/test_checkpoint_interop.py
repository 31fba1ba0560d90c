"""Reference-checkpoint interop: the explicit key bijection round-trips our
generator losslessly, accounts strictly (no silent misses), accepts the
reference's legacy ``.activate.bias`` naming, and imported weights render
identically (reference naming read at models/narf.py:29-77, NeRF/net.py,
custom_stylegan2/net.py; legacy keys: evaluation/compute_fid.py:195-199)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from enarf_gan_tpu.models.narf import NARFParams
from enarf_gan_tpu.models.generator import (DSONARFGenerator,
                                            register_canonical_pose)
from enarf_gan_tpu.geometry.smpl import SMPL_PARENTS
from enarf_gan_tpu.training.checkpoint import (export_reference_state_dict,
                                               import_reference_state_dict,
                                               jax_tree_to_dict)


@pytest.fixture(scope="module")
def dso_gen():
    params = NARFParams(Nc=2, Nf=2, hidden_size=16, tri_plane_size=16,
                        w_dim=32, view_dependent=False,
                        origin_location="center_fixed",
                        deformation_field=True, time_conditional=True)
    gen = DSONARFGenerator(nerf_params=params, size=16, num_bone=24,
                           parent_id=tuple(int(x) for x in SMPL_PARENTS),
                           use_triplane=True, ray_batchsize=16)
    rng = jax.random.PRNGKey(0)
    pose = jnp.tile(jnp.eye(4)[None, None], (1, 24, 1, 1))
    variables = gen.init(rng, rng, pose, pose[:, 0, :3, :3],
                         jnp.ones((1, 16, 16)), jnp.array([0.5]),
                         jnp.ones((1, 23, 1)), jnp.eye(3))
    canonical = np.tile(np.eye(4, dtype=np.float32), (24, 1, 1))
    canonical[:, :3, 3] = np.random.default_rng(0).normal(size=(24, 3)) * 0.2
    variables = register_canonical_pose(variables, canonical, "center_fixed",
                                        np.asarray(SMPL_PARENTS))
    # give every leaf a distinct value so mapping mistakes can't cancel
    leaves, treedef = jax.tree_util.tree_flatten(variables)
    keyed = [jnp.asarray(np.random.default_rng(i).normal(
        size=np.shape(l)).astype(np.float32)) for i, l in enumerate(leaves)]
    return gen, jax.tree_util.tree_unflatten(treedef, keyed)


def test_export_uses_reference_names(dso_gen):
    _, variables = dso_gen
    sd = export_reference_state_dict(variables)
    for expected in [
        "nerf.tri_plane",
        "nerf.canonical_pose",
        "nerf.canonical_bone_length",
        "nerf.mlp.layers.0.conv.weight",
        "nerf.mlp.layers.0.conv.modulation.weight",
        "nerf.mlp.layers.0.bias",
        "nerf.flow_generator.mapping.fc0.weight",
        "nerf.flow_generator.mapping.embed.weight",
        "nerf.flow_generator.synthesis.b4.const",
        "nerf.flow_generator.synthesis.b4.conv1.weight",
        "nerf.flow_generator.synthesis.b4.conv1.affine.weight",
        "nerf.flow_generator.synthesis.b8.conv0.weight",
        "nerf.flow_generator.synthesis.b16.torgb.bias",
    ]:
        assert expected in sd, (expected, sorted(sd)[:40])
    # torch-side shapes: StyledConv1d weight (1, out, in, 1), bias (1, out, 1)
    assert sd["nerf.mlp.layers.0.conv.weight"].ndim == 4
    assert sd["nerf.mlp.layers.0.conv.weight"].shape[-1] == 1
    assert sd["nerf.mlp.layers.0.bias"].ndim == 3


def test_roundtrip_is_lossless_and_strict(dso_gen):
    _, variables = dso_gen
    sd = export_reference_state_dict(variables)
    zero_tpl = jax.tree_util.tree_map(lambda x: np.zeros_like(x),
                                      jax_tree_to_dict(variables))
    new_vars, report = import_reference_state_dict(sd, zero_tpl, strict=True)
    assert not [m for m in report["missing"] if m.startswith("params/")], \
        report["missing"]
    assert not report["unused"], report["unused"]

    for coll in ("params", "buffers"):   # 'stats' (w_avg) is not checkpointed
        flat_a = jax.tree_util.tree_leaves_with_path(variables[coll])
        flat_b = dict((jax.tree_util.keystr(pp), l) for pp, l in
                      jax.tree_util.tree_leaves_with_path(new_vars[coll]))
        for pp, leaf in flat_a:
            key = jax.tree_util.keystr(pp)
            np.testing.assert_array_equal(np.asarray(leaf),
                                          np.asarray(flat_b[key]),
                                          err_msg=coll + key)


def test_legacy_activate_bias_accepted(dso_gen):
    _, variables = dso_gen
    sd = export_reference_state_dict(variables)
    legacy = dict(sd)
    for name in list(legacy):
        if name.startswith("nerf.mlp.layers.") and name.endswith(".bias"):
            legacy[name.replace(".bias", ".activate.bias")] = \
                legacy.pop(name).reshape(-1)
    zero_tpl = jax.tree_util.tree_map(lambda x: np.zeros_like(x),
                                      jax_tree_to_dict(variables))
    new_vars, report = import_reference_state_dict(legacy, zero_tpl,
                                                   strict=True)
    assert not report["unused"], report["unused"]
    for coll in ("params", "buffers"):
        a = jax.tree_util.tree_leaves(variables[coll])
        b = jax.tree_util.tree_leaves(new_vars[coll])
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_imported_weights_render_identically(dso_gen):
    gen, variables = dso_gen
    sd = export_reference_state_dict(variables)
    zero_tpl = jax.tree_util.tree_map(lambda x: np.zeros_like(x),
                                      jax_tree_to_dict(variables))
    new_vars, _ = import_reference_state_dict(sd, zero_tpl, strict=True)
    new_vars = jax.tree_util.tree_map(jnp.asarray, new_vars)

    pose = jnp.tile(jnp.eye(4)[None, None], (1, 24, 1, 1))
    pose = pose.at[:, :, 2, 3].add(2.0)
    out = {}
    for tag, v in (("orig", variables), ("imported", new_vars)):
        color, mask, ray_idx, _ = gen.apply(
            v, jax.random.PRNGKey(7), pose, pose[:, 0, :3, :3],
            jnp.ones((1, 16, 16)), jnp.array([0.5]), jnp.ones((1, 23, 1)),
            jnp.eye(3))
        out[tag] = (np.asarray(color), np.asarray(mask))
    np.testing.assert_array_equal(out["orig"][0], out["imported"][0])
    np.testing.assert_array_equal(out["orig"][1], out["imported"][1])


def test_gan_generator_roundtrip():
    """TriNARFGenerator (ADA tri-plane gen named tri_plane_gen + rosinality
    background) round-trips through the reference naming."""
    from enarf_gan_tpu.models.generator import TriNARFGenerator
    params = NARFParams(Nc=2, Nf=2, hidden_size=16, tri_plane_size=16,
                        w_dim=32, view_dependent=False,
                        origin_location="center_fixed")
    gen = TriNARFGenerator(nerf_params=params, size=16, num_bone=24,
                           parent_id=tuple(int(x) for x in SMPL_PARENTS),
                           z_dim=16, crop_background=True, channel_max=32)
    rng = jax.random.PRNGKey(0)
    pose = jnp.tile(jnp.eye(4)[None, None], (1, 24, 1, 1))
    pose = pose.at[:, :, 2, 3].add(2.0)
    variables = gen.init(rng, rng, pose, pose, jnp.ones((1, 23, 1)),
                         jnp.ones((1, 64)), jnp.eye(3))
    sd = export_reference_state_dict(variables)
    for expected in [
        "nerf.tri_plane_gen.mapping.fc0.weight",
        "nerf.tri_plane_gen.synthesis.b16.conv0.weight",
        "background_generator.style.1.weight",
        "background_generator.input.input",
        "background_generator.conv1.conv.weight",
        "background_generator.conv1.noise.weight",
        "background_generator.convs.0.conv.weight",
        "background_generator.convs.1.conv.modulation.bias",
        "background_generator.to_rgbs.0.bias",
    ]:
        assert expected in sd, (expected, sorted(sd)[:60])
    # rosinality conv weights carry the leading 1
    assert sd["background_generator.conv1.conv.weight"].ndim == 5
    # reference StyledConv / ToRGB biases are (1, C, 1, 1)
    # (custom_stylegan2/net.py:307,332)
    assert sd["background_generator.conv1.bias"].ndim == 4
    assert sd["background_generator.conv1.bias"].shape[0] == 1
    assert sd["background_generator.conv1.bias"].shape[2:] == (1, 1)
    assert sd["background_generator.to_rgbs.0.bias"].ndim == 4

    zero_tpl = jax.tree_util.tree_map(lambda x: np.zeros_like(x),
                                      jax_tree_to_dict(variables))
    new_vars, report = import_reference_state_dict(sd, zero_tpl, strict=True)
    assert not [m for m in report["missing"] if m.startswith("params/")], \
        report["missing"][:10]
    assert not report["unused"], report["unused"][:10]
    for coll in ("params", "buffers"):
        a = jax.tree_util.tree_leaves(variables[coll])
        b = jax.tree_util.tree_leaves(new_vars[coll])
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_selector_mlp_generator_maps_to_reference_name():
    """selector_mlp names its StyleGAN 'nerf.generator' in the reference
    (models/narf.py:59-60) and carries a 'nerf.selector' MLP."""
    params = NARFParams(Nc=2, Nf=2, hidden_size=16, tri_plane_size=16,
                        w_dim=32, view_dependent=False,
                        origin_location="center_fixed", selector_mlp=True,
                        time_conditional=True)
    gen = DSONARFGenerator(nerf_params=params, size=16, num_bone=24,
                           parent_id=tuple(int(x) for x in SMPL_PARENTS),
                           use_triplane=True, ray_batchsize=16)
    rng = jax.random.PRNGKey(0)
    pose = jnp.tile(jnp.eye(4)[None, None], (1, 24, 1, 1))
    variables = gen.init(rng, rng, pose, pose[:, 0, :3, :3],
                         jnp.ones((1, 16, 16)), jnp.array([0.5]),
                         jnp.ones((1, 23, 1)), jnp.eye(3))
    sd = export_reference_state_dict(variables)
    assert "nerf.generator.mapping.fc0.weight" in sd, sorted(sd)[:40]
    assert "nerf.generator.synthesis.b4.conv1.weight" in sd
    assert any(k.startswith("nerf.selector.") for k in sd), sorted(sd)[:40]
    assert not any(k.startswith("nerf.tri_plane_gen.") for k in sd)

    zero_tpl = jax.tree_util.tree_map(lambda x: np.zeros_like(x),
                                      jax_tree_to_dict(variables))
    new_vars, report = import_reference_state_dict(sd, zero_tpl, strict=True)
    assert not [m for m in report["missing"] if m.startswith("params/")], \
        report["missing"][:10]
    assert not report["unused"], report["unused"][:10]
    for coll in ("params", "buffers"):
        a = jax.tree_util.tree_leaves(variables[coll])
        b = jax.tree_util.tree_leaves(new_vars[coll])
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_npz_snapshot_roundtrip(dso_gen, tmp_path):
    """snapshot_latest.npz holds every leaf of {iteration, gen, gen_opt}
    keyed by path; loading into a template restores them bit-exactly, and
    a template leaf the file lacks is an error."""
    import optax
    from enarf_gan_tpu.training import checkpoint as ckpt
    _, variables = dso_gen
    tx = optax.apply_if_finite(optax.adam(1e-3), 100)
    opt = tx.init(variables["params"])
    state = {"iteration": 7, "gen": variables, "gen_opt": opt}
    path = ckpt.save_checkpoint(str(tmp_path), state, 7)
    assert path == ckpt.latest_checkpoint(str(tmp_path))
    assert path.endswith("snapshot_latest.npz")
    assert (tmp_path / "snapshot_50000.npz").exists()
    with np.load(path) as data:
        assert "gen/params/nerf/tri_plane" in data.files
    loaded = ckpt.load_checkpoint(path, state)
    assert int(loaded["iteration"]) == 7
    assert (jax.tree_util.tree_structure(loaded)
            == jax.tree_util.tree_structure(state))
    for a, b in zip(jax.tree_util.tree_leaves(loaded),
                    jax.tree_util.tree_leaves(state)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # a sub-tree loads on its own (the demos restore only "gen")
    gen_only = ckpt.load_checkpoint(path, {"gen": variables})
    assert set(gen_only) == {"gen"}
    with pytest.raises(KeyError):
        ckpt.load_checkpoint(path, {"gen": variables, "dis": {"w": 0.0}})
