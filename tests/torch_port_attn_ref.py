"""An f64 reference of the attention chain and a bound on an f32 run's error.

`chain_f64` is softmax(q·kᵀ·scale + bias + mask)·v in float64 on the CPU.
`f32_bound` bounds, per output element, how far an f32 evaluation of the
chain (`ops.attention.attention_chain`: f32 logits, max-subtracted exp,
f32 row sums, the PV product, the divide) may lie from it, by the standard
forward error analysis with unit roundoff u = 2^-24 and γ_n = n·u / (1 - n·u):

  - a logit, s·Σ_c q_c k_c + b + m: |Δl| ≤ γ_{d+3}·(s·Σ_c |q_c k_c| + |b| + |m|),
    and the max subtraction and exp add u·(|l - max| + 2);
  - the softmax turns logit errors Δl_j into
    |Δo| ≤ Σ_j w_j·(|Δl_j| + Σ_k w_k |Δl_k|)·|v_j - o|, with w the exact weights;
  - the PV sum and the row sum over T terms add γ_T·(Σ_j w_j |v_j| + |o|), the
    divide u·|o|.

No JAX: the card tests import it too.
"""

import torch

U = 2.0 ** -24


def _gamma(n: int) -> float:
    return n * U / (1 - n * U)


def _mask_term(mask, N, h, Tq, Tk):
    """The additive mask as [N, h, Tq, Tk] f64 (zeros for None)."""
    if mask is None:
        return torch.zeros((), dtype=torch.float64)
    nW = mask.shape[0]
    if mask.dim() == 2:
        mask = torch.where(mask[:, :, None] == mask[:, None, :], 0.0, -100.0)
    m = mask.double()[None, :, None].expand(N // nW, nW, h, Tq, Tk)
    return m.reshape(N, h, Tq, Tk)


def chain_f64(q, k, v, bias=None, mask=None, scale=None):
    """(out [N, Tq, h, d], weights [N, h, Tq, Tk], logits) in f64 on the CPU."""
    q, k, v = (t.detach().cpu().double() for t in (q, k, v))
    N, Tq, h, d = q.shape
    s = d ** -0.5 if scale is None else scale
    logits = torch.einsum("nqhd,nkhd->nhqk", q * s, k)
    if bias is not None:
        logits = logits + bias.detach().cpu().double()[None]
    logits = logits + _mask_term(None if mask is None else mask.cpu(), N, h, Tq, k.shape[1])
    w = torch.softmax(logits, -1)
    return torch.einsum("nhqk,nkhd->nqhd", w, v), w, logits


def f32_bound(q, k, v, bias=None, mask=None, scale=None) -> torch.Tensor:
    """[N, Tq, h, d] f64: the largest error an f32 run of the chain may have
    at each output element (see the module's docstring)."""
    out, w, logits = chain_f64(q, k, v, bias, mask, scale)
    q, k, v = (t.detach().cpu().double() for t in (q, k, v))
    N, Tq, h, d = q.shape
    Tk = k.shape[1]
    s = d ** -0.5 if scale is None else scale
    mag = torch.einsum("nqhd,nkhd->nhqk", (q * s).abs(), k.abs())
    if bias is not None:
        mag = mag + bias.detach().cpu().double().abs()[None]
    mag = mag + _mask_term(None if mask is None else mask.cpu(), N, h, Tq, Tk).abs()
    err = _gamma(d + 3) * mag + U * ((logits - logits.amax(-1, keepdim=True)).abs() + 2)
    mean_err = (w * err).sum(-1, keepdim=True)                         # [N, h, Tq, 1]
    o = out.permute(0, 2, 1, 3)                                        # [N, h, Tq, d]
    vh = v.permute(0, 2, 1, 3)                                         # [N, h, Tk, d]
    spread = (vh[:, :, None] - o[:, :, :, None]).abs()                 # [N, h, Tq, Tk, d]
    soft = ((w * (err + mean_err))[..., None] * spread).sum(3)        # [N, h, Tq, d]
    sums = _gamma(Tk) * (torch.einsum("nhqk,nhkd->nhqd", w, vh.abs()) + o.abs())
    return (soft + sums + U * o.abs()).permute(0, 2, 1, 3)
