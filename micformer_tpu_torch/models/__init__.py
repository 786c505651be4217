"""Model zoo of the port; importing it registers every model family."""

from micformer_tpu_torch.models import (  # noqa: F401
    generic_unet, mednext, micformer, nnformer, swinunet3d, swinunetr, transbts, transunet,
    unet3d, vtunet,
)
