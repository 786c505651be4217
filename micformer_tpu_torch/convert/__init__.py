"""Weight conversion into the port: the reference's checkpoints and models
(`torch_import`, `zoo_import`), pretrained runs, the 2D-Swin inflation, the
flax trees of the JAX package (`from_flax`) and serving artifacts
(`aot_export`)."""

from micformer_tpu_torch.convert.pretrained import load_pretrained_state  # noqa: F401
from micformer_tpu_torch.convert.swin2d import vtunet_params_from_swin2d  # noqa: F401
from micformer_tpu_torch.convert.torch_import import (  # noqa: F401
    load_reference_micformer, micformer_state_from_torch,
)
