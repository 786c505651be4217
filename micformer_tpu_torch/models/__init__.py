"""Model zoo of the port; importing it registers every model family."""

from micformer_tpu_torch.models import generic_unet, mednext, micformer  # noqa: F401
