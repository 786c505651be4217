"""Registration preprocessing CLI: register, then crop each MM-WHS pair.

Counterpart of `micformer_tpu/cli/preprocess.py` (the reference's
prepocess.py:10-42): for each pair under <data>/ct_train and
<data>/mr_train, register the CT label to the MR label with ANTs SyN, apply
the forward transform to the CT image (linear) and the CT label (nearest
neighbour), then crop all four volumes (registered CT image and label, MR
image and label) to the nonzero box of the registered CT image, writing
<out>/ct_crop/ and <out>/mr_crop/ under the original file names.

ANTs (antspyx) is an optional host-side dependency: this stage is offline
and never touches the device. Without it the CLI exits with a message;
`--no-registration` does the crop alone on pairs that are already aligned.

    python -m micformer_tpu_torch.cli.preprocess --data <root> --no-registration
"""

from __future__ import annotations

import argparse
import glob
import os


def main(argv=None):
    import numpy as np

    from micformer_tpu_torch import native
    from micformer_tpu_torch.data.image_utils import nonzero_bbox
    from micformer_tpu_torch.data.nifti import read_nifti, write_nifti

    p = argparse.ArgumentParser("micformer_tpu_torch.preprocess")
    p.add_argument("--data", required=True, help="root with ct_train/ and mr_train/")
    p.add_argument("--out", default=None, help="output root (default: --data)")
    p.add_argument("--no-registration", action="store_true",
                   help="skip ANTs registration (pairs already aligned)")
    args = p.parse_args(argv)
    native.available()      # the volume reader and resizer: built once, up front
    out_root = args.out or args.data

    ct_imgs = sorted(glob.glob(os.path.join(args.data, "ct_train", "*_image.nii.gz")))
    os.makedirs(os.path.join(out_root, "ct_crop"), exist_ok=True)
    os.makedirs(os.path.join(out_root, "mr_crop"), exist_ok=True)

    for ct_img_p in ct_imgs:
        name = os.path.basename(ct_img_p)
        mr_name = name.replace("ct_", "mr_")
        ct_lab_p = os.path.join(os.path.dirname(ct_img_p), name.replace("_image", "_label"))
        mr_img_p = os.path.join(args.data, "mr_train", mr_name)
        mr_lab_p = os.path.join(args.data, "mr_train", mr_name.replace("_image", "_label"))

        if not args.no_registration:
            try:
                import ants
            except ImportError:
                raise SystemExit(
                    "antspyx not installed — rerun with --no-registration for "
                    "pre-aligned pairs, or install antspyx offline") from None
            mr_lab = ants.image_read(mr_lab_p)
            ct_lab = ants.image_read(ct_lab_p)
            ct_img = ants.image_read(ct_img_p)
            reg = ants.registration(fixed=mr_lab, moving=ct_lab)
            ct_img_r = ants.apply_transforms(mr_lab, ct_img, reg["fwdtransforms"],
                                             interpolator="linear")
            ct_lab_r = ants.apply_transforms(mr_lab, ct_lab, reg["fwdtransforms"],
                                             interpolator="nearestNeighbor")
            ct_image = ct_img_r.numpy().transpose(2, 1, 0)
            ct_label = ct_lab_r.numpy().transpose(2, 1, 0)
        else:
            ct_image = np.asarray(read_nifti(ct_img_p))
            ct_label = np.asarray(read_nifti(ct_lab_p))

        mr_image = np.asarray(read_nifti(mr_img_p))
        mr_label = np.asarray(read_nifti(mr_lab_p))

        (z0, z1), (y0, y1), (x0, x1) = nonzero_bbox(np.abs(ct_image))
        sl = (slice(z0, z1), slice(y0, y1), slice(x0, x1))
        write_nifti(os.path.join(out_root, "ct_crop", name), ct_image[sl])
        write_nifti(os.path.join(out_root, "ct_crop", name.replace("_image", "_label")),
                    ct_label[sl])
        write_nifti(os.path.join(out_root, "mr_crop", mr_name), mr_image[sl])
        write_nifti(os.path.join(out_root, "mr_crop", mr_name.replace("_image", "_label")),
                    mr_label[sl])
        print(f"{name}: cropped to {ct_image[sl].shape}")


if __name__ == "__main__":
    main()
