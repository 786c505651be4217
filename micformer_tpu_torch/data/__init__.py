"""Datasets and volume I/O."""

from micformer_tpu_torch.data import image_utils  # noqa: F401
from micformer_tpu_torch.data.mmwhs import MMWHSDataset, get_datasets, kfold_split  # noqa: F401
from micformer_tpu_torch.data.nifti import load_nii, read_nifti, write_nifti  # noqa: F401
