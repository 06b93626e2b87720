"""Plain causal attention: the numerics reference the serving forward
uses when no kernel is selected (``tensorflow_examples_tpu/ops/attention.py``
``attention_reference``)."""

from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    sm_scale: float | None = None,
) -> torch.Tensor:
    """q, k, v: [batch, heads, seq, head_dim]. Scores and softmax in f32,
    probabilities cast to v's dtype, f32 accumulation, output in q's
    dtype. The causal diagonal is aligned bottom-right (row r of a
    ``seq_q``-row query block sees key columns ``<= r + seq_kv - seq_q``)."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        row = torch.arange(sq, device=q.device)[:, None]
        col = torch.arange(sk, device=q.device)[None, :]
        s = torch.where(row + (sk - sq) >= col, s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.matmul(p.float(), v.float()).to(q.dtype)
