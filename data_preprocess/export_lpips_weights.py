"""Export LPIPS (VGG/Alex) weights to .npz for offline on-device LPIPS.

Run once on a machine with the `lpips` pip package + network access:

    python data_preprocess/export_lpips_weights.py --net vgg --out lpips_vgg.npz

then set LPIPS_WEIGHTS_NPZ=<path> wherever LPIPS metrics are needed.
"""
import argparse

import numpy as np


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--net", choices=["vgg", "alex"], default="vgg")
    parser.add_argument("--out", type=str, required=True)
    args = parser.parse_args()

    import lpips  # requires pip install lpips (network access at first use)
    model = lpips.LPIPS(net=args.net)
    arrays = {"net_type": np.array(args.net)}
    for name, p in model.named_parameters():
        arrays[name.replace(".", "/")] = p.detach().numpy()
    for name, b in model.named_buffers():
        arrays[name.replace(".", "/")] = b.detach().numpy()
    np.savez(args.out, **arrays)
    print(f"wrote {args.out} ({len(arrays)} arrays)")


if __name__ == "__main__":
    main()
