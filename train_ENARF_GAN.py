"""ENARF-GAN training CLI (mirrors reference train_ENARF_GAN.py:300-311).

Usage:
    python train_ENARF_GAN.py --config configs/enarfgan_train/AIST/config.yml \
        --default_config configs/enarfgan_train/default.yml [--resume_latest]
"""
import argparse

from enarf_gan_tpu.config import yaml_config
from enarf_gan_tpu.data.datasets import HumanDataset, HumanPoseDataset
from enarf_gan_tpu.data.loader import DataLoader


def create_dataset(config_dataset):
    size = config_dataset.image_size
    train_cfg = config_dataset.train
    print("loading datasets")
    img_dataset = HumanDataset(train_cfg, size=size, return_bone_params=False)
    pose_prior_root = getattr(train_cfg, "pose_prior_root", None) or \
        train_cfg.data_root
    print("pose prior:", pose_prior_root)
    pose_dataset = HumanPoseDataset(size=size, data_root=pose_prior_root)
    return img_dataset, pose_dataset


def create_dataloader(config_dataset):
    img_dataset, pose_dataset = create_dataset(config_dataset)
    bs = config_dataset.bs
    loader_img = DataLoader(img_dataset, bs, shuffle=True, drop_last=True, seed=0)
    loader_pose = DataLoader(pose_dataset, bs, shuffle=True, drop_last=True, seed=1)
    return (img_dataset, pose_dataset), (loader_img, loader_pose)


def main(argv=None):
    from enarf_gan_tpu.utils.platform import setup_jax
    setup_jax()
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str,
                        default="configs/enarfgan_train/AIST/config.yml")
    parser.add_argument("--default_config", type=str,
                        default="configs/enarfgan_train/default.yml")
    parser.add_argument("--resume_latest", action="store_true")
    parser.add_argument("--num_workers", type=int, default=1)
    parser.add_argument("--iterations", type=int, default=None,
                        help="override num_iter (smoke runs)")
    args = parser.parse_args(argv)

    config = yaml_config(args.config, args.default_config, args.resume_latest,
                         args.num_workers)

    from enarf_gan_tpu.training import gan
    datasets, loaders = create_dataloader(config.dataset)
    _, pose_dataset = datasets
    gen, dis = gan.build_models(config, pose_dataset.num_bone,
                                pose_dataset.parents)
    gan.train_loop(config, gen, dis, datasets, loaders,
                   pose_dataset.canonical_pose,
                   max_iterations=args.iterations)


if __name__ == "__main__":
    main()
