"""FID evaluation (mirrors reference evaluation/compute_fid.py).

Generates ``num_sample`` images from poses drawn from the pose-prior dataset,
extracts InceptionV3 features at 299² (bilinear), and computes the Fréchet
distance against cached dataset statistics. Writes fid{_truncX}.txt.

Inception weights must be available offline (torchvision cache or
INCEPTION_WEIGHTS_NPZ) — FID is only meaningful with the standard weights.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    from enarf_gan_tpu.utils.platform import setup_jax
    setup_jax()
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str,
                        default="configs/enarfgan_train/AIST/config.yml")
    parser.add_argument("--default_config", type=str,
                        default="configs/enarfgan_train/default.yml")
    parser.add_argument("--num_workers", type=int, default=1)
    parser.add_argument("--iteration", type=int, default=-1)
    parser.add_argument("--truncation", type=float, default=1.0)
    parser.add_argument("--black_bg", action="store_true")
    parser.add_argument("--num_sample", type=int, default=10000)
    parser.add_argument("--batch_size", type=int, default=16)
    args = parser.parse_args()

    import jax
    import jax.numpy as jnp
    from enarf_gan_tpu.config import yaml_config
    from enarf_gan_tpu.data.datasets import HumanDataset, HumanPoseDataset
    from enarf_gan_tpu.data.loader import DataLoader, infinite_batches
    from enarf_gan_tpu.config import AttrDict
    from enarf_gan_tpu.eval_lib.fid import (make_inception_extractor,
                                            resize_bilinear_299,
                                            load_or_compute_dataset_stats,
                                            compute_statistics, frechet_distance)
    from enarf_gan_tpu.training import gan, checkpoint as ckpt

    config = yaml_config(args.config, args.default_config,
                         num_workers=args.num_workers)
    size = config.dataset.image_size
    pose_ds = HumanPoseDataset(size=size,
                               data_root=config.dataset.train.data_root,
                               num_repeat_in_epoch=1)
    img_ds = HumanDataset(AttrDict({"data_root": config.dataset.train.data_root}),
                          size=size, return_bone_params=False,
                          num_repeat_in_epoch=1)
    gen, dis = gan.build_models(config, pose_ds.num_bone, pose_ds.parents)

    rng = jax.random.PRNGKey(0)
    first = pose_ds[0]
    sample_batch = {k: np.asarray(v)[None] for k, v in first.items()}
    state, _, _ = gan.init_gan_state(config, gen, dis, pose_ds.canonical_pose,
                                     rng, sample_batch)
    out_dir = os.path.join(config.out_root, "result", config.out)
    snap = ckpt.latest_checkpoint(out_dir) if args.iteration <= 0 else \
        os.path.join(out_dir, f"snapshot_{args.iteration}.npz")
    assert snap and os.path.exists(snap), "pretrained model is not loading"
    state = ckpt.load_checkpoint(snap, {"iteration": 0, **state})
    gen_vars = state["gen"]

    extractor = make_inception_extractor()

    # dataset statistics (cached)
    def real_feature_iter():
        loader = DataLoader(img_ds, args.batch_size, shuffle=True,
                            drop_last=True, seed=0)
        count = 0
        for batch in loader:
            imgs = batch["img"] * 127.5 + 127.5
            yield extractor(resize_bilinear_299(imgs))
            count += len(imgs)
            if count >= args.num_sample:
                break

    # key the stats cache by weight set — torchvision vs cleanfid features
    # are NOT interchangeable (eval_lib/fid.py weight-set policy)
    wnpz = os.environ.get("INCEPTION_WEIGHTS_NPZ", "")
    wtag = os.path.splitext(os.path.basename(wnpz))[0] if wnpz else "torchvision"
    stats_cache = os.path.join(config.dataset.train.data_root,
                               f"fid_stats_{size}_{wtag}.npz")
    mu_real, sigma_real = load_or_compute_dataset_stats(stats_cache,
                                                        real_feature_iter)

    # generated features
    z_dim = config.generator_params.z_dim
    pose_loader = infinite_batches(DataLoader(pose_ds, args.batch_size,
                                              shuffle=True, drop_last=True,
                                              seed=1))
    feats = []
    n_done = 0
    for batch in pose_loader:
        rng, z_rng, f_rng = jax.random.split(rng, 3)
        z = jax.random.normal(z_rng, (args.batch_size, z_dim * 4))
        img, mask, aux = gen.apply(
            gen_vars, f_rng, jnp.asarray(batch["pose_to_camera"]),
            jnp.asarray(batch["pose_to_world"]),
            jnp.asarray(batch["bone_length"]), z,
            jnp.linalg.inv(jnp.asarray(batch["intrinsics"])),
            truncation_psi=args.truncation,
            black_bg_if_possible=args.black_bg)
        img = np.clip(np.asarray(img), -1, 1) * 127.5 + 127.5
        feats.append(extractor(resize_bilinear_299(img)))
        n_done += len(img)
        if n_done >= args.num_sample:
            break
    feats = np.concatenate(feats)[:args.num_sample]
    mu_f, sigma_f = compute_statistics(feats)
    fid = frechet_distance(mu_f, sigma_f, mu_real, sigma_real)

    suffix = "" if args.truncation == 1 else f"_trunc{args.truncation}"
    path = os.path.join(out_dir, f"fid{suffix}.txt")
    with open(path, "w") as f:
        f.write(f"{fid}")
    print(path, fid)


if __name__ == "__main__":
    main()
