import textwrap

from enarf_gan_tpu.config import AttrDict, merge_config, yaml_config


def test_merge_leafwise():
    default = {"a": 1, "b": {"c": 2, "d": 3}, "e": [1, 2]}
    override = {"b": {"c": 20}, "e": [5]}
    merged = merge_config(override, default)
    assert merged.a == 1
    assert merged.b.c == 20
    assert merged.b.d == 3
    assert merged.e == [5]


def test_attrdict_nested_assignment():
    d = AttrDict({"x": {"y": 1}})
    d.z = {"w": 2}
    assert d.z.w == 2
    assert isinstance(d.x, AttrDict)


def test_yaml_config_reference_semantics(tmp_path):
    # mirrors reference libraries/config.py:5-20 behavior
    default = tmp_path / "default.yml"
    default.write_text(textwrap.dedent("""
        out: base
        dataset:
          bs: 6
          image_size: 128
        generator_params:
          nerf_params:
            Nc: 48
            Nf: 48
    """))
    override = tmp_path / "override.yml"
    override.write_text(textwrap.dedent("""
        out: exp1
        generator_params:
          nerf_params:
            Nf: 64
    """))
    cfg = yaml_config(str(override), str(default), resume_latest=True, num_workers=3)
    assert cfg.out == "exp1"
    assert cfg.dataset.bs == 6
    assert cfg.generator_params.nerf_params.Nc == 48
    assert cfg.generator_params.nerf_params.Nf == 64
    assert cfg.resume_latest is True
    assert cfg.dataset.num_workers == 3


def test_reference_configs_load():
    # the reference's shipped configs must load unchanged
    cfg = yaml_config("configs/enarfgan_train/AIST/config.yml",
                      "configs/enarfgan_train/default.yml")
    assert cfg.generator_params.use_triplane is True
    assert cfg.generator_params.nerf_params.origin_location == "center_fixed"
    assert cfg.loss.r1_loss_coef == 10


def test_every_shipped_config_loads():
    """All configs/ trees merge over their family default and expose
    NARFParams-parseable nerf_params."""
    import glob
    from enarf_gan_tpu.models.narf import NARFParams
    for family in ("DSO_train", "DSO_demo", "enarfgan_train", "enarfgan_demo"):
        default = f"configs/{family}/default.yml"
        for path in sorted(glob.glob(f"configs/{family}/*/*.yml")):
            cfg = yaml_config(path, default)
            assert cfg.generator_params is not None, path
            np_cfg = cfg.generator_params.nerf_params
            params = NARFParams.from_config(np_cfg)
            assert params.Nc > 0 and params.tri_plane_size > 0, path
