"""The window-attention CUDA kernel against its plain version, on the card.

This file imports neither JAX nor the JAX package, so it runs on a machine
that has only the port's dependencies:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_kernels.py

Without a card its tests skip.
"""

import numpy as np
import pytest
import torch

from micformer_tpu_torch.kernels import LAUNCHES
from micformer_tpu_torch.kernels.window_attention import (
    window_attention, window_attention_reference,
)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA and nvcc")
    return torch.device("cuda")


def _qkv(seed, N, Tq, Tk, h, d):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(N, Tq, h, d)).astype(np.float32)
    k = rng.normal(size=(N, Tk, h, d)).astype(np.float32)
    v = rng.normal(size=(N, Tk, h, d)).astype(np.float32)
    return q, k, v


@pytest.mark.cuda
def test_window_attention_kernel_matches_reference_on_card(cuda_device):
    """The CUDA kernel against its plain version, f32 and bf16, contiguous
    and fused-projection (strided) inputs."""
    for N, Tq, Tk, h, d in [(1000, 8, 8, 3, 16), (37, 4, 4, 2, 8),
                            (64, 16, 8, 5, 32), (9, 8, 16, 1, 64)]:
        q, k, v = (torch.from_numpy(a).to(cuda_device)
                   for a in _qkv(N + d, N, Tq, Tk, h, d))
        for dt, atol in [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)]:
            a, b, c = q.to(dt), k.to(dt), v.to(dt)
            got = window_attention(a, b, c)
            torch.cuda.synchronize()
            ref = window_attention_reference(a, b, c)
            assert (got.float() - ref.float()).abs().max().item() <= atol
    # q/k/v as slices of the fused projections: self attention splits qkv in
    # thirds (row stride 3*h*d), cross attention kv in halves (2*h*d)
    for dt, atol in [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)]:
        qkv = torch.randn(300, 8, 3 * 48, device=cuda_device).to(dt)
        kv = torch.randn(300, 8, 2 * 48, device=cuda_device).to(dt)
        self_qkv = tuple(t.view(300, 8, 3, 16) for t in qkv.chunk(3, dim=-1))
        cross_qkv = (self_qkv[0],) + tuple(t.view(300, 8, 3, 16)
                                           for t in kv.chunk(2, dim=-1))
        for q, k, v in (self_qkv, cross_qkv):
            assert not k.is_contiguous()
            ref = window_attention_reference(q, k, v)
            got = window_attention(q, k, v)
            assert (got.float() - ref.float()).abs().max().item() <= atol


@pytest.mark.cuda
def test_window_attention_kernel_raises_on_unsupported_card_inputs(cuda_device):
    q = torch.zeros(4, 8, 2, 24, device=cuda_device)          # d = 24
    with pytest.raises(ValueError):
        window_attention(q, q, q)
    q = torch.zeros(4, 17, 2, 16, device=cuda_device)         # T = 17
    with pytest.raises(ValueError):
        window_attention(q, q, q)
    q = torch.zeros(4, 8, 2, 16, device=cuda_device, dtype=torch.float16)
    with pytest.raises(ValueError):
        window_attention(q, q, q)
    q = torch.zeros(4, 2, 8, 16, device=cuda_device).transpose(1, 2)
    with pytest.raises(ValueError):
        window_attention(q, q, q)


@pytest.mark.cuda
def test_window_attention_counts_each_launch_on_card(cuda_device):
    q = torch.randn(64, 8, 3, 16, device=cuda_device)
    before = LAUNCHES["window_attention"]
    window_attention(q, q, q)
    window_attention(q, q, q, scale=0.5)
    window_attention(q[:0], q[:0], q[:0])                     # N = 0: no launch
    window_attention_reference(q, q, q)
    assert LAUNCHES["window_attention"] == before + 2
