"""micformer_tpu_torch: the PyTorch/CUDA port of micformer_tpu for NVIDIA Hopper.

The JAX package `micformer_tpu` is the reference this port is held against;
the port imports nothing of it. Plain tensor code is PyTorch; the TPU's
Pallas kernels become hand-written CUDA kernels (`csrc/`, `kernels/`).
Entry points run on the card (`device="cuda"`) unless the caller asks for the
CPU, where each kernel's plain PyTorch version runs instead.

`micformer_tpu_torch.build_model("micformer")` is `registry.build`. The
registry (and torch) load on first use of either name, so the package's
torch-free tools (cli/plan, cli/evaluate, data/nifti) start without torch.
"""

__version__ = "0.1.0"
__all__ = ["build_model", "registry"]


def __getattr__(name):
    if name in __all__:
        import importlib

        registry = importlib.import_module("micformer_tpu_torch.registry")
        return registry if name == "registry" else registry.build
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
