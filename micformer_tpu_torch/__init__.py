"""micformer_tpu_torch: the PyTorch/CUDA port of micformer_tpu for NVIDIA Hopper.

The JAX package `micformer_tpu` is the reference this port is held against;
the port imports nothing of it. Plain tensor code is PyTorch; the TPU's
Pallas kernels become hand-written CUDA kernels (`csrc/`, `kernels/`).
Entry points run on the card (`device="cuda"`) unless the caller asks for the
CPU, where each kernel's plain PyTorch version runs instead.
"""
