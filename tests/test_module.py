"""The in-repo module layer (nn/module.py) against flax.linen.

Every model class is built twice from the same source file: as shipped (on
``enarf_gan_tpu.nn.module``) and with ``nn`` bound to ``flax.linen``.
``init`` must give the same variable tree with bit-identical values (same
submodule names, same parameter RNG derivation), and ``apply`` on those
variables the same outputs, including mutated collections. flax is a
test-only dependency.
"""
import importlib
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEY = jax.random.PRNGKey(0)

# model source files, dependency order: (short name, module, path)
_SOURCES = [
    ("layers", "enarf_gan_tpu.nn.layers", "enarf_gan_tpu/nn/layers.py"),
    ("stylegan2", "enarf_gan_tpu.nn.stylegan2", "enarf_gan_tpu/nn/stylegan2.py"),
    ("narf", "enarf_gan_tpu.models.narf", "enarf_gan_tpu/models/narf.py"),
    ("generator", "enarf_gan_tpu.models.generator",
     "enarf_gan_tpu/models/generator.py"),
    ("nerf", "enarf_gan_tpu.models.nerf", "enarf_gan_tpu/models/nerf.py"),
]


@pytest.fixture(scope="module")
def twins():
    """{short name: (shipped module, flax twin module)}."""
    pytest.importorskip("flax.linen")
    out = {}
    for short, modname, path in _SOURCES:
        with open(os.path.join(REPO, path)) as f:
            src = f.read()
        assert "from enarf_gan_tpu.nn import module as nn" in src, path
        src = src.replace("from enarf_gan_tpu.nn import module as nn",
                          "from flax import linen as nn")
        for s2, m2, _ in _SOURCES:
            src = src.replace(m2, f"_flax_twin_{s2}")
        twin = types.ModuleType(f"_flax_twin_{short}")
        twin.__file__ = path
        sys.modules[twin.__name__] = twin
        exec(compile(src, path, "exec"), twin.__dict__)
        out[short] = (importlib.import_module(modname), twin)
    return out


def _scene(B=1, size=8):
    import __graft_entry__ as ge
    pose_cam, world, bl, inv_K, canonical, K = ge._tiny_scene(B, size)
    return (jnp.asarray(pose_cam), jnp.asarray(world), jnp.asarray(bl),
            jnp.asarray(inv_K), canonical)


def _narf_params(narf, **kw):
    base = dict(Nc=4, Nf=4, hidden_size=8, tri_plane_size=8, render_bs=64,
                coordinate_scale=3.0, w_dim=16, feat_dim=8,
                max_bones_per_point=2)
    base.update(kw)
    return narf.NARFParams(**base)


def _rand(i, shape):
    return jax.random.normal(jax.random.PRNGKey(100 + i), shape)


# (file, class, ctor(mod) -> kwargs, args() -> tuple, init/apply kwargs)
def _cases():
    return [
        ("layers", "EqualLinear", lambda m: dict(out_dim=8, bias_init=0.5,
                                                 lr_mul=0.1),
         lambda: (_rand(0, (4, 16)),), {}),
        ("layers", "EqualConv1d", lambda m: dict(out_channels=6, groups=3),
         lambda: (_rand(0, (2, 12, 9)),), {}),
        ("layers", "EqualConv2d", lambda m: dict(out_channels=5, padding=1),
         lambda: (_rand(0, (2, 3, 8, 8)),), {}),
        ("layers", "ModulatedConv1d", lambda m: dict(out_channels=6,
                                                     style_dim=4),
         lambda: (_rand(0, (3, 8, 11)), _rand(1, (3, 4))), {}),
        ("layers", "StyledConv1d", lambda m: dict(out_channels=6, style_dim=4),
         lambda: (_rand(0, (3, 8, 11)), _rand(1, (3, 4))), {}),
        ("layers", "StyledMLP", lambda m: dict(hidden_dim=8, out_dim=3,
                                               style_dim=4),
         lambda: (_rand(0, (2, 5, 7)), _rand(1, (2, 4))), {}),
        ("layers", "MLP", lambda m: dict(hidden_dim=8, out_dim=4,
                                         num_layers=4, skips=(2,)),
         lambda: (_rand(0, (2, 6, 5)),), {}),
        ("layers", "GroupedConv1dReLUSelector", lambda m: dict(num_bone=3),
         lambda: (_rand(0, (2, 18, 5)),), {}),
        ("stylegan2", "MappingNetwork", lambda m: dict(style_dim=16,
                                                       num_layers=2, c_dim=4),
         lambda: (_rand(0, (2, 16)), _rand(1, (2, 4))),
         {"update_w_avg": True, "_mutable": ["stats"]}),
        ("stylegan2", "_ModulatedConv2d", lambda m: dict(out_channels=4,
                                                         upsample=True),
         lambda: (_rand(0, (2, 3, 8, 8)), _rand(1, (2, 5))), {}),
        ("stylegan2", "StyledConv2d", lambda m: dict(out_channels=4),
         lambda: (_rand(0, (2, 3, 8, 8)), _rand(1, (2, 5)),
                  jax.random.PRNGKey(7)), {}),
        ("stylegan2", "ToRGB", lambda m: dict(out_channels=3),
         lambda: (_rand(0, (2, 4, 8, 8)), _rand(1, (2, 5)),
                  _rand(2, (2, 3, 4, 4))), {}),
        ("stylegan2", "SynthesisNetwork", lambda m: dict(size=8,
                                                         channel_max=16),
         lambda: (_rand(0, (2, 4, 16)), jax.random.PRNGKey(3)), {}),
        ("stylegan2", "StyleGAN2Generator",
         lambda m: dict(size=8, style_dim=16, n_mlp=2, channel_max=16,
                        crop_background=True),
         lambda: ([_rand(0, (2, 16)), _rand(1, (2, 16))],),
         {"train": True, "crop_rng": jax.random.PRNGKey(5),
          "update_w_avg": True, "_mutable": ["stats"]}),
        ("stylegan2", "ConvLayer", lambda m: dict(out_channels=4,
                                                  downsample=True),
         lambda: (_rand(0, (2, 3, 8, 8)),), {}),
        ("stylegan2", "ResBlock", lambda m: dict(out_channels=4),
         lambda: (_rand(0, (2, 3, 8, 8)),), {}),
        ("stylegan2", "Discriminator", lambda m: dict(size=8, channel_max=16),
         lambda: (_rand(0, (4, 3, 8, 8)),), {}),
        ("stylegan2", "PretrainedStyleGAN",
         lambda m: dict(size=8, style_dim=16, n_mlp=2, gen_size=16,
                        channel_max=16),
         lambda: ([_rand(0, (2, 8)), _rand(1, (2, 8))], 2), {}),
        ("narf", "_DensityColorHeads",
         lambda m: dict(params=_narf_params(m, view_dependent=True),
                        in_dim=32, hidden_dim=8, z2_dim=4),
         lambda: (_rand(0, (2, 8, 6)), _rand(1, (2, 4)), _rand(2, (2, 3, 3))),
         {}),
        ("narf", "TriPlaneNARF",
         lambda m: dict(params=_narf_params(m, view_dependent=False),
                        z_dim=16, z2_dim=4, num_bone=3),
         lambda: (_rand(0, (1, 16)), jnp.abs(_rand(1, (1, 3, 1))) + 0.5,
                  _rand(2, (1, 3, 10)),
                  jnp.broadcast_to(jnp.eye(4), (1, 3, 4, 4)), _rand(3, (1, 4))),
         {"_method": "planes_then_density"}),
        ("narf", "MLPNARF",
         lambda m: dict(params=_narf_params(m, model_type="tnarf"),
                        z_dim=4, z2_dim=4, num_bone=3),
         lambda: (_rand(0, (1, 3, 6)),
                  jnp.broadcast_to(jnp.eye(4), (1, 3, 4, 4)),
                  jnp.ones((1, 3, 1)), _rand(1, (1, 4)), _rand(2, (1, 4)),
                  _rand(3, (1, 3, 2))),
         {"_method": "density_color"}),
        ("generator", "DSONARFGenerator",
         lambda m: dict(nerf_params=_narf_params(
             m, deformation_field=True, pose_conditional=True,
             view_dependent=True, origin_location="center_fixed"),
             size=8, num_bone=24, parent_id=_parents(), ray_batchsize=16),
         lambda: _dso_args(), {}),
        ("generator", "TriNARFGenerator",
         lambda m: dict(nerf_params=_narf_params(m, view_dependent=False),
                        size=8, num_bone=24, parent_id=_parents(), z_dim=8,
                        crop_background=True, channel_max=16,
                        train_ray_chunk=32),
         lambda: _gan_args(),
         {"train": True, "_mutable": ["stats"]}),
        ("nerf", "MLPNeRF",
         lambda m: dict(params=_narf_params(m, view_dependent=True),
                        z_dim=4, z2_dim=4),
         lambda: (_rand(0, (1, 3, 6)), jnp.eye(4)[None, None],
                  _rand(1, (1, 4)), _rand(2, (1, 4)), _rand(3, (1, 3, 2))),
         {"_method": "density_color"}),
        ("nerf", "TriPlaneNeRF",
         lambda m: dict(params=_narf_params(m, view_dependent=False),
                        z_dim=16, z2_dim=4),
         lambda: (_rand(0, (1, 16)), _rand(1, (1, 3, 6)),
                  jnp.eye(4)[None, None], _rand(2, (1, 4))),
         {"_method": "planes_then_density"}),
    ]


def _parents():
    from enarf_gan_tpu.geometry.smpl import SMPL_PARENTS
    return tuple(int(x) for x in SMPL_PARENTS)


def _dso_args():
    pose_cam, world, bl, inv_K, _ = _scene()
    return (jax.random.PRNGKey(1), pose_cam, world[:, 0, :3, :3],
            jnp.ones((1, 8, 8)), jnp.array([0.5]), bl, inv_K)


def _gan_args():
    pose_cam, world, bl, inv_K, _ = _scene()
    return (jax.random.PRNGKey(1), pose_cam, world, bl, _rand(0, (1, 32)),
            inv_K)


def _planes_then_density(module, *args):
    """Touch every variable of a tri-plane model: planes, then heads."""
    if len(args) == 5:   # TriPlaneNARF: z, bone_length, pos, pose, z_rend
        z, bl, pos, pose, z_rend = args
        planes = module.compute_tri_plane_feature(z, bl)
        return module.density_color(pos, pose, bl, planes, z_rend)
    z, pos, pose, z_rend = args   # TriPlaneNeRF
    planes = module.compute_tri_plane_feature(z)
    return module.density_color(pos, pose, planes, z_rend)


CASES = _cases()


@pytest.mark.parametrize("case", CASES, ids=[c[1] for c in CASES])
def test_module_layer_matches_flax(twins, case):
    short, cls_name, ctor, make_args, kw = case
    kw = dict(kw)
    mutable = kw.pop("_mutable", False)
    method = kw.pop("_method", None)
    if method == "planes_then_density":
        method = _planes_then_density
    ours_mod, flax_mod = twins[short]
    ours = getattr(ours_mod, cls_name)(**ctor(ours_mod))
    ref = getattr(flax_mod, cls_name)(**ctor(flax_mod))
    args = make_args()

    v_ours = ours.init(KEY, *args, method=method)
    v_ref = ref.init(KEY, *args, method=method)
    paths = lambda t: [jax.tree_util.keystr(p) for p, _ in  # noqa: E731
                       jax.tree_util.tree_flatten_with_path(t)[0]]
    assert paths(v_ours) == paths(v_ref)
    for a, b in zip(jax.tree_util.tree_leaves(v_ours),
                    jax.tree_util.tree_leaves(v_ref)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    out_ours = ours.apply(v_ours, *args, method=method, mutable=mutable, **kw)
    out_ref = ref.apply(v_ours, *args, method=method, mutable=mutable, **kw)
    assert (jax.tree_util.tree_structure(out_ours)
            == jax.tree_util.tree_structure(jax.tree_util.tree_map(
                lambda x: x, out_ref)))
    for a, b in zip(jax.tree_util.tree_leaves(out_ours),
                    jax.tree_util.tree_leaves(out_ref)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-6, atol=1e-6)


def test_module_layer_refuses_immutable_update():
    """Writing a collection apply was not told is mutable raises."""
    from enarf_gan_tpu.nn.stylegan2 import MappingNetwork
    m = MappingNetwork(style_dim=8, num_layers=1)
    z = _rand(0, (2, 8))
    v = m.init(KEY, z)
    with pytest.raises(ValueError, match="immutable"):
        m.apply(v, z, update_w_avg=True)
    out, mut = m.apply(v, z, update_w_avg=True, mutable=["stats"])
    assert not np.array_equal(np.asarray(mut["stats"]["w_avg"]),
                              np.asarray(v["stats"]["w_avg"]))
    # the caller's tree is untouched
    np.testing.assert_array_equal(np.asarray(v["stats"]["w_avg"]), 0.0)
