"""Checkpoint / resume.

Pytree snapshots with the same contents and cadence as the reference's
torch.save dicts {iteration, start_time, gen, (dis,) opts} →
snapshot_latest + rolling snapshot_{(iter//50000+1)*50000}
(reference train_ENARF_GAN.py:278-294, train_DSO.py:287-298). Stored as
one ``.npz`` of the flattened state, one array per leaf keyed by its
'/'-joined path (e.g. ``gen/params/nerf/tri_plane``), written to a
temporary file and renamed. Optimizer state is saved but — matching the
reference's deliberate choice (train_ENARF_GAN.py:233-234) — NOT restored
by default.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional

import jax
import numpy as np


def _key_name(k) -> str:
    for attr in ("key", "name", "idx"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    raise TypeError(f"unsupported pytree key {k!r}")


def flatten_state(state) -> Dict[str, np.ndarray]:
    """Pytree → {'/'-joined key path: numpy array}."""
    leaves, _ = jax.tree_util.tree_flatten_with_path(state)
    return {"/".join(_key_name(k) for k in path): np.asarray(leaf)
            for path, leaf in leaves}


def save_checkpoint(out_dir: str, state: Dict[str, Any], iteration: int,
                    rolling_every: int = 50000) -> str:
    """Write snapshot_latest.npz (+ rolling snapshot)."""
    os.makedirs(out_dir, exist_ok=True)
    flat = flatten_state(state)
    latest = os.path.join(out_dir, "snapshot_latest.npz")
    rolling = os.path.join(
        out_dir, f"snapshot_{(iteration // rolling_every + 1) * rolling_every}.npz")
    for path in (latest, rolling):
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **flat)
        os.replace(tmp, path)
    return latest


def load_checkpoint(path: str, template: Dict[str, Any]) -> Dict[str, Any]:
    """Load a snapshot into the structure of ``template`` (a matching
    pytree). Every template leaf must be in the file, with its shape."""
    leaves, treedef = jax.tree_util.tree_flatten_with_path(template)
    out = []
    with np.load(path) as data:
        for key_path, leaf in leaves:
            key = "/".join(_key_name(k) for k in key_path)
            if key not in data:
                raise KeyError(f"{path}: no entry {key!r}")
            arr = data[key]
            if arr.shape != np.shape(leaf):
                raise ValueError(f"{path}: {key!r} has shape {arr.shape}, "
                                 f"expected {np.shape(leaf)}")
            out.append(arr.astype(np.asarray(leaf).dtype))
    return jax.tree_util.tree_unflatten(treedef, out)


def latest_checkpoint(out_dir: str) -> Optional[str]:
    p = os.path.join(out_dir, "snapshot_latest.npz")
    return p if os.path.exists(p) else None


# --------------------------------------------------------------------- #
# Reference (.pth) interop: explicit per-module-family key bijection.
#
# The mapping is derived from the reference sources (names read at
# models/narf.py:29-77,84-120, libraries/NeRF/net.py:10-51,
# libraries/custom_stylegan2/net.py:194-330,346-536, and the
# stylegan2-ada layout used by prepare_triplane_generator,
# libraries/triplane/triplane_nerf.py:17-29). Orientation transforms:
#
#   * StyledConv1d: ref ModulatedConv1d weight (1, out, in, k=1) ↔ ours
#     (g=1, out, in); ref bias (1, out, 1) ↔ ours (out,); legacy
#     checkpoints keep the bias under ".activate.bias" (out,)
#     (reference evaluation/compute_fid.py:195-199) — both accepted.
#   * ADA synthesis convs: weight (out, in, k, k) both sides; UP convs are
#     transposed convs in the reference and plain lhs-dilated convs here,
#     which differ by a spatial kernel flip (nn/stylegan2.py docstring).
#   * rosinality (background) convs carry a leading 1 on weights
#     (1, out, in, k, k) → squeeze; up convs flip spatially as above.
#
# Every import/export goes through `reference_key_map`, and
# `convert_torch_snapshot` returns a strict accounting report — no
# silent misses.
# --------------------------------------------------------------------- #

_ADA_LEAF = {"conv/weight": ".weight", "bias": ".bias",
             "noise_weight": ".noise_strength",
             "conv/modulation/weight": ".affine.weight",
             "conv/modulation/bias": ".affine.bias"}
_ROS_LEAF = {"conv/weight": ".conv.weight", "bias": ".bias",
             "noise_weight": ".noise.weight",
             "conv/modulation/weight": ".conv.modulation.weight",
             "conv/modulation/bias": ".conv.modulation.bias"}


def _ada_block(parts):
    """our synthesis child name → (ref block name, is_up_conv)."""
    name = parts[0]
    if name == "const":
        return "b4.const", False
    if name == "conv1":
        return "b4.conv1", False
    if name == "to_rgb1":
        return "b4.torgb", False
    for prefix, ref, up in (("conv_up", "conv0", True), ("to_rgb", "torgb", False),
                            ("conv", "conv1", False)):
        if name.startswith(prefix) and name[len(prefix):].isdigit():
            r = int(name[len(prefix):])
            return f"b{2 ** r}.{ref}", up
    return None, False


def _ros_block(parts):
    """our synthesis child name → (ref module name, is_up_conv)."""
    name = parts[0]
    if name == "const":
        return "input.input", False
    if name == "conv1":
        return "conv1", False
    if name == "to_rgb1":
        return "to_rgb1", False
    for prefix in ("conv_up", "to_rgb", "conv"):
        if name.startswith(prefix) and name[len(prefix):].isdigit():
            r = int(name[len(prefix):])
            if prefix == "conv_up":
                return f"convs.{2 * (r - 3)}", True
            if prefix == "conv":
                return f"convs.{2 * (r - 3) + 1}", False
            return f"to_rgbs.{r - 3}", False
    return None, False


def _styled_conv1d_leaf(rest):
    leaf = "/".join(rest)
    if leaf == "conv/weight":
        return ".conv.weight", "conv1d_weight"
    if leaf == "bias":
        return ".bias", "bias1d"
    if leaf in ("conv/modulation/weight", "conv/modulation/bias"):
        return "." + leaf.replace("/", "."), "id"
    return None, None


def _stylegan_leaf(rest, table, up):
    leaf = "/".join(rest) if rest else ""
    ref = table.get(leaf)
    if ref is None:
        return None, None
    t = "id"
    if leaf == "conv/weight":
        t = ("flip_hw" if up else "id") if table is _ADA_LEAF else \
            ("squeeze0_flip" if up else "squeeze0")
    elif leaf == "noise_weight":
        t = "noise_scalar"
    elif leaf == "bias" and table is _ROS_LEAF and rest == ["bias"]:
        # reference StyledConv / ToRGB store bias as (1, C, 1, 1)
        # (custom_stylegan2/net.py:307,332); legacy snapshots keep a flat
        # (C,) ".activate.bias" instead (compute_fid.py:195-199)
        t = "bias2d"
    return ref, t


def reference_key_map(gen_params: Dict[str, Any],
                      gen_buffers: Optional[Dict[str, Any]] = None):
    """Walk OUR generator pytree → {our_path: (ref_name, transform)}.

    our_path is a '/'-joined key path into {"params": ..., "buffers": ...}.
    """
    out = {}

    def walk(tree, path):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, path + [k])
            return
        out["/".join(path)] = _map_one(path, gen_params)

    walk(gen_params, ["params"])
    if gen_buffers:
        walk(gen_buffers, ["buffers"])
    return out


def _map_one(path, gen_params):
    parts = list(path)
    kind = parts.pop(0)  # params | buffers
    if kind == "buffers":
        name = ".".join(parts)
        return name, "id"
    if parts and parts[0] == "nerf":
        sub = parts[1:]
        if sub == ["tri_plane"]:
            return "nerf.tri_plane", "id"
        if sub[0] == "heads":
            head = sub[1]
            ref_head = {"density_fc": "nerf.density_fc",
                        "color_mlp": "nerf.mlp"}.get(head)
            rest = sub[2:]
            if ref_head == "nerf.mlp" and rest and \
                    rest[0].startswith("StyledConv1d_"):
                i = int(rest[0].split("_")[-1])
                leaf, t = _styled_conv1d_leaf(rest[1:])
                if leaf:
                    return f"nerf.mlp.layers.{i}{leaf}", t
            elif ref_head == "nerf.density_fc":
                leaf, t = _styled_conv1d_leaf(rest)
                if leaf:
                    return f"nerf.density_fc{leaf}", t
        if sub[0] in ("flow_generator", "generator"):
            # ref attribute: deformation → flow_generator; constant_trimask /
            # selector_mlp variants keep "generator"; the default tri-plane
            # GAN generator is "tri_plane_gen" (reference models/narf.py:71)
            if sub[0] == "flow_generator":
                ref_gen = "nerf.flow_generator"
            else:
                # constant_trimask (has a tri_plane param) and selector_mlp
                # (has a selector submodule) both name the StyleGAN
                # "nerf.generator" in the reference (models/narf.py:33,60);
                # only the default GAN variant uses "nerf.tri_plane_gen"
                # (models/narf.py:71)
                nerf_p = gen_params.get("nerf", {})
                ref_gen = ("nerf.generator"
                           if ("tri_plane" in nerf_p or "selector" in nerf_p)
                           else "nerf.tri_plane_gen")
            rest = sub[1:]
            if rest[0] == "mapping":
                return f"{ref_gen}.mapping.{'.'.join(rest[1:])}", "id"
            if rest[0] == "synthesis":
                blk, up = _ada_block(rest[1:])
                if blk == "b4.const":
                    return f"{ref_gen}.synthesis.b4.const", "id"
                if blk:
                    leaf, t = _stylegan_leaf(rest[2:], _ADA_LEAF, up)
                    if leaf:
                        return f"{ref_gen}.synthesis.{blk}{leaf}", t
        if sub[0] == "selector":
            return "nerf.selector." + ".".join(sub[1:]), "id"
    if parts and parts[0] == "background_generator":
        rest = parts[1:]
        prefix = "background_generator"
        if rest and rest[0] == "gen":
            # PretrainedStyleGAN nests its rosinality generator under .gen
            # (reference custom_stylegan2/net.py:698)
            prefix = "background_generator.gen"
            rest = rest[1:]
        if rest[0] == "mapping" and rest[1].startswith("fc"):
            i = int(rest[1][2:])
            return f"{prefix}.style.{i + 1}.{rest[2]}", "id"
        if rest[0] == "synthesis":
            blk, up = _ros_block(rest[1:])
            if blk == "input.input":
                return f"{prefix}.input.input", "id"
            if blk:
                leaf, t = _stylegan_leaf(rest[2:], _ROS_LEAF, up)
                if leaf:
                    return f"{prefix}.{blk}{leaf}", t
    return None, None


_IMPORT_T = {
    "id": lambda a: a,
    "conv1d_weight": lambda a: a[..., 0],            # (1,out,in,1)→(1,out,in)
    "bias1d": lambda a: a.reshape(-1),               # (1,out,1)→(out,)
    "flip_hw": lambda a: a[..., ::-1, ::-1],
    "squeeze0": lambda a: a[0],
    "squeeze0_flip": lambda a: a[0][..., ::-1, ::-1],
    "noise_scalar": lambda a: np.asarray(a).reshape(()),
    "bias2d": lambda a: a.reshape(-1),               # (1,C,1,1)→(C,)
}
_EXPORT_T = {
    "id": lambda a: a,
    "conv1d_weight": lambda a: np.asarray(a)[..., None],
    "bias1d": lambda a: np.asarray(a).reshape(1, -1, 1),
    "flip_hw": lambda a: np.asarray(a)[..., ::-1, ::-1],
    "squeeze0": lambda a: np.asarray(a)[None],
    "squeeze0_flip": lambda a: np.asarray(a)[..., ::-1, ::-1][None],
    "noise_scalar": lambda a: np.asarray(a).reshape(1),
    "bias2d": lambda a: np.asarray(a).reshape(1, -1, 1, 1),
}


def export_reference_state_dict(gen_variables: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """OUR generator variables → reference-named numpy state dict."""
    keymap = reference_key_map(gen_variables.get("params", {}),
                               gen_variables.get("buffers", {}))
    flat = _flatten(gen_variables)
    out = {}
    for path, leaf in flat.items():
        ref = keymap.get(path)
        if ref and ref[0]:
            name, t = ref
            out[name] = np.asarray(_EXPORT_T[t](np.asarray(leaf)))
    return out


def _flatten(tree, prefix=()):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, prefix + (k,)))
        return out
    out["/".join(prefix)] = tree
    return out


def _set_path(tree, path, value):
    node = tree
    for k in path[:-1]:
        node = node[k]
    node[path[-1]] = value


def import_reference_state_dict(state_dict: Dict[str, np.ndarray],
                                gen_variables: Dict[str, Any],
                                strict: bool = False):
    """Reference-named state dict → OUR generator variables (+ report).

    Returns (new_variables, report) with report =
    {"mapped": [...], "missing": [our paths with no ref key present],
     "unused": [ref keys we did not consume]}. ``strict`` raises if any
    parameter leaf is missing.
    """
    import copy
    keymap = reference_key_map(gen_variables.get("params", {}),
                               gen_variables.get("buffers", {}))
    new_vars = copy.deepcopy(jax_tree_to_dict(gen_variables))
    consumed, mapped, missing = set(), [], []
    # legacy ".activate.bias" keys (reference compute_fid.py:195-199)
    legacy = {k.replace(".activate.bias", ".bias"): k
              for k in state_dict if k.endswith(".activate.bias")}
    for path, (name, t) in keymap.items():
        if name is None:
            missing.append(path)
            continue
        src_name, src_t = name, t
        if name not in state_dict and name in legacy:
            src_name = legacy[name]
            src_t = "id" if src_t in ("bias1d", "bias2d") else src_t
        if src_name not in state_dict:
            missing.append(path)
            continue
        arr = _IMPORT_T[src_t](np.asarray(state_dict[src_name]))
        tgt_shape = tuple(np.shape(_get_path(new_vars, path.split("/"))))
        if (tuple(arr.shape) != tgt_shape and path.startswith("buffers/")
                and arr.size == int(np.prod(tgt_shape))):
            arr = arr.reshape(tgt_shape)   # e.g. bone length (K,1) vs (K,)
        if tuple(arr.shape) != tgt_shape:
            raise ValueError(
                f"shape mismatch importing {src_name} -> {path}: "
                f"{arr.shape} vs {tgt_shape}")
        _set_path(new_vars, path.split("/"), arr.astype(np.float32))
        consumed.add(src_name)
        mapped.append(path)
    # canonical_joints / canonical_parent_joints are derived buffers
    for k in state_dict:
        if k.endswith(("canonical_joints", "canonical_parent_joints")):
            consumed.add(k)
    report = {"mapped": mapped, "missing": missing,
              "unused": sorted(set(state_dict) - consumed)}
    if strict and any(p.startswith("params/") for p in missing):
        raise ValueError(f"unmapped parameters: {report['missing']}")
    return new_vars, report


def load_pretrained_background(gen_variables: Dict[str, Any],
                               arrays: Dict[str, np.ndarray]):
    """Load converted stylegan2-church weights into the background generator.

    ``arrays``: mapping of raw rosinality ``g_ema`` names → numpy arrays
    (the npz written by data_preprocess/convert_stylegan2_church.py; an
    ``np.load`` result works directly). Only the
    ``params/background_generator`` subtree is touched; every parameter
    under it must map or this raises. Returns (new_variables, report).
    """
    sd = {f"background_generator.gen.{k}": np.asarray(v)
          for k, v in arrays.items()}
    new_vars, report = import_reference_state_dict(sd, gen_variables,
                                                   strict=False)
    bg_missing = [m for m in report["missing"]
                  if m.startswith("params/background_generator/")]
    if bg_missing:
        raise ValueError(f"unmapped background parameters: {bg_missing[:10]}")
    return new_vars, report


def _get_path(tree, path):
    node = tree
    for k in path:
        node = node[k]
    return node


def jax_tree_to_dict(tree):
    """Deep-copyable plain-dict view of a (frozen) variables pytree."""
    if isinstance(tree, dict) or hasattr(tree, "items"):
        return {k: jax_tree_to_dict(v) for k, v in tree.items()}
    return tree


def convert_torch_snapshot(pth_path: str, template: Dict[str, Any],
                           strict: bool = False) -> Dict[str, Any]:
    """Import a reference .pth snapshot into our state pytree.

    ``template`` is our state dict ({"iteration", "gen", ("dis",) ...});
    the generator is imported through the explicit key bijection above with
    a printed accounting report. Requires torch (CPU) at call time.
    """
    import torch  # local import: eval-time tool only
    snap = torch.load(pth_path, map_location="cpu")
    out = dict(template)
    out["iteration"] = int(snap.get("iteration", 0))
    sd = {k: v.numpy() for k, v in snap.get("gen", {}).items()
          if hasattr(v, "numpy")}
    if "gen" in out and isinstance(out["gen"], dict):
        out["gen"], report = import_reference_state_dict(sd, out["gen"],
                                                         strict=strict)
        print(f"convert_torch_snapshot: mapped {len(report['mapped'])}, "
              f"missing {len(report['missing'])}, "
              f"unused {len(report['unused'])}")
        if report["missing"]:
            print("  missing:", report["missing"][:20])
        if report["unused"]:
            print("  unused:", report["unused"][:20])
    return out
