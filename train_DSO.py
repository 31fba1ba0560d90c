"""DSO training CLI (mirrors reference train_DSO.py:378-390).

Usage:
    python train_DSO.py --config configs/DSO_train/ZJU/313_denarf.yml \
        --default_config configs/DSO_train/default.yml [--resume_latest]
        [--validation]
"""
import argparse

from enarf_gan_tpu.config import yaml_config
from enarf_gan_tpu.data.datasets import SSODataset
from enarf_gan_tpu.data.loader import DataLoader


def create_dataset(config_dataset):
    size = config_dataset.image_size
    train_cfg = config_dataset.train
    print("loading datasets")
    dataset_train = SSODataset(train_cfg, size=size, return_bone_params=True,
                               return_bone_mask=False, return_mask=True,
                               load_camera_intrinsics=True)
    datasets_val = {}
    for key in config_dataset.val.keys():
        if config_dataset.val[key].data_root is not None:
            datasets_val[key] = SSODataset(
                config_dataset.val[key], size=size, return_bone_params=True,
                return_bone_mask=False, return_mask=True,
                num_repeat_in_epoch=1, load_camera_intrinsics=True)
    return dataset_train, datasets_val


def create_dataloader(config_dataset):
    dataset_train, datasets_val = create_dataset(config_dataset)
    train_loader = DataLoader(dataset_train, config_dataset.bs, shuffle=True,
                              drop_last=True)
    val_loaders = {k: DataLoader(v, 1, shuffle=False, drop_last=False)
                   for k, v in datasets_val.items()}
    return (dataset_train, datasets_val), (train_loader, val_loaders)


def main(argv=None):
    from enarf_gan_tpu.utils.platform import setup_jax
    setup_jax()
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str,
                        default="configs/DSO_train/ZJU/313_denarf.yml")
    parser.add_argument("--default_config", type=str,
                        default="configs/DSO_train/default.yml")
    parser.add_argument("--resume_latest", action="store_true")
    parser.add_argument("--num_workers", type=int, default=1)
    parser.add_argument("--validation", action="store_true")
    parser.add_argument("--iterations", type=int, default=None,
                        help="override num_iter (smoke runs)")
    args = parser.parse_args(argv)

    config = yaml_config(args.config, args.default_config, args.resume_latest,
                         args.num_workers)

    from enarf_gan_tpu.training import dso
    datasets, loaders = create_dataloader(config.dataset)
    dataset_train = datasets[0]
    gen = dso.build_generator(config, dataset_train.num_bone,
                              dataset_train.parents)

    if args.validation:
        import os
        import json
        import jax
        import numpy as np
        out_dir = os.path.join(config.out_root, "result", config.out)
        # load snapshot and run full validation with crop + LPIPS-if-available
        first = next(iter(loaders[0]))
        rng = jax.random.PRNGKey(0)
        variables, tx, opt_state = dso.init_state(
            config, gen, dataset_train.canonical_pose, rng,
            dso.prepare_batch(first))
        from enarf_gan_tpu.training import checkpoint as ckpt
        path = ckpt.latest_checkpoint(out_dir) or config.resume
        assert path, "Please load a pretrained model"
        template = {"iteration": 0, "gen": variables, "gen_opt": opt_state}
        loaded = ckpt.load_checkpoint(path, template)
        metrics = ["PSNR", "SSIM"]
        from enarf_gan_tpu.eval_lib.metrics import lpips_available
        if lpips_available():
            metrics.append("LPIPS")
        val = dso.validate(gen, loaded["gen"], config, loaders[1], rng,
                           crop=True, metrics=tuple(metrics))
        with open(os.path.join(out_dir, "val_metrics.json"), "w") as f:
            json.dump(val, f)
        print(json.dumps(val, indent=2))
    else:
        dso.train_loop(config, gen, datasets, loaders,
                       dataset_train.canonical_pose,
                       max_iterations=args.iterations)


if __name__ == "__main__":
    main()
