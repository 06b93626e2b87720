"""Flash (blockwise) attention and its plain reference.

The port of ``tensorflow_examples_tpu/ops/attention.py``. Public API and
contract are the reference's:

* q, k, v are [batch, heads, seq, head_dim]; the causal diagonal is
  aligned bottom-right (row r of a ``seq_q``-row query block sees key
  columns ``<= r + seq_kv - seq_q``), and causal with ``seq_q > seq_kv``
  is rejected;
* ``key_bias`` is an optional [batch, seq_kv] additive score bias (the
  padding-mask shape), broadcast over heads and rows, with a zero
  cotangent: it is mask data;
* :func:`flash_attention_with_lse` also returns the row logsumexp, and
  its cotangent is exact: ``ds = p * (dp - delta + dlse)``;
* a row that sees no key gives 0 (``l`` is clamped at 1e-30).

Three kernels carry it, hand-written for Hopper in
``ops/csrc/flash_attention.cu``: :func:`flash_fwd` (O and lse),
:func:`flash_bwd_dkv` and :func:`flash_bwd_dq`, each on the folded
[batch*heads, seq, head_dim] layout for a head_dim in
:data:`SUPPORTED_HEAD_DIMS`. Each runs on the tensor cores (``mma.sync``)
in bf16 at head_dim 16 to 128 and as a SIMT kernel otherwise (f32, and
bf16 at head_dim 8): :func:`uses_tensor_cores`, fixed by dtype and
head_dim alone. Each counts its launches (``launches``) and, beside
them, which variant ran (``tensor_core_launches``, ``simt_launches``).
Beside each is its plain PyTorch version (``*_plain``), the same
two-kernel math written with whole-matrix ops; a wrapper given CPU
tensors runs the plain version, given CUDA tensors it launches the
kernel or raises.
:class:`_FlashFunction` is the ``torch.autograd.Function`` around them:
its forward calls the forward kernel, its backward the two backward
kernels, with ``delta = rowsum(dO * O)`` computed outside them as in the
reference. The TPU block table and ``_resolve_block`` have no
counterpart: the kernels take any length, masking their last tile.
"""

from __future__ import annotations

import ctypes

import torch

from tensorflow_examples_torch.ops import _build

NEG_INF = -1e30
# The head_dims every attention kernel of the port is built for (the flash
# kernels here, flash-decode and paged decode); a wrapper refuses others.
SUPPORTED_HEAD_DIMS = (8, 16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    sm_scale: float | None = None,
    key_bias: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain attention, the numerics reference; differentiable by
    autograd. q, k, v: [batch, heads, seq, head_dim]. Scores and softmax
    in f32, probabilities cast to v's dtype, f32 accumulation, output in
    q's dtype. ``key_bias``: optional [batch, seq_kv] f32 bias."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    if key_bias is not None:
        s = s + key_bias[:, None, None, :].float()
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        row = torch.arange(sq, device=q.device)[:, None]
        col = torch.arange(sk, device=q.device)[None, :]
        s = torch.where(row + (sk - sq) >= col, s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.matmul(p.float(), v.float()).to(q.dtype)


# ------------------------------------------------ plain kernel versions
#
# The three kernels' functions on folded [BH, seq, D] tensors, written
# with whole-matrix ops: the CPU path and the card's yardstick.


def _scores(q, k, kb, heads, causal, sm_scale, *, scale_q: bool):
    """Scores [BH, seq_q, seq_kv] in f32 and the visibility mask. The
    forward scales q before the product, the backward scales the product
    (as the TPU kernels do)."""
    if scale_q:
        s = torch.matmul(q.float() * sm_scale, k.float().transpose(-1, -2))
    else:
        s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    if kb is not None:
        s = s + kb.float().repeat_interleave(heads, dim=0)[:, None, :]
    sq, sk = s.shape[-2], s.shape[-1]
    if causal:
        row = torch.arange(sq, device=q.device)[:, None]
        col = torch.arange(sk, device=q.device)[None, :]
        visible = (row + (sk - sq) >= col)[None]
    else:
        visible = torch.ones(1, sq, sk, dtype=torch.bool, device=q.device)
    return s, visible


def flash_fwd_plain(q, k, v, kb, *, heads: int, causal: bool, sm_scale: float):
    """(O in q's dtype, lse [BH, seq_q] f32): the forward kernel's
    function. Masked scores get probability exactly 0."""
    s, visible = _scores(q, k, kb, heads, causal, sm_scale, scale_q=True)
    s = torch.where(visible, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(visible, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.matmul(p, v.float()) / l
    return o.to(q.dtype), (m + torch.log(l)).squeeze(-1)


def _probs_and_ds(q, k, v, do, lse, delta, dlse, kb, heads, causal, sm_scale):
    s, visible = _scores(q, k, kb, heads, causal, sm_scale, scale_q=False)
    p = torch.where(visible, torch.exp(s - lse.float()[..., None]), 0.0)
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    ds = p * (dp - delta.float()[..., None] + dlse.float()[..., None])
    return p, ds


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, dlse, kb, *, heads: int,
                        causal: bool, sm_scale: float):
    """(dK, dV) in k's and v's dtypes: the dK/dV kernel's function."""
    p, ds = _probs_and_ds(q, k, v, do, lse, delta, dlse, kb, heads, causal, sm_scale)
    dv = torch.matmul(p.transpose(-1, -2), do.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float()) * sm_scale
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_dq_plain(q, k, v, do, lse, delta, dlse, kb, *, heads: int,
                       causal: bool, sm_scale: float):
    """dQ in q's dtype: the dQ kernel's function."""
    _, ds = _probs_and_ds(q, k, v, do, lse, delta, dlse, kb, heads, causal, sm_scale)
    return (torch.matmul(ds, k.float()) * sm_scale).to(q.dtype)


# ------------------------------------------------------- kernel wrappers


def _check(name: str, t: torch.Tensor, dtype, shape) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor like q")
    if t.dtype != dtype:
        raise ValueError(f"{name} dtype {t.dtype} != {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(t.shape)} != {tuple(shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def check_head_dim(what: str, d: int) -> None:
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"{what}: head_dim {d} unsupported (the kernels take "
                         f"{SUPPORTED_HEAD_DIMS})")


def _check_qkv(q, k, v, kb, heads):
    bh, seq_q, d = q.shape
    seq_kv = k.shape[1]
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash attention: dtype {q.dtype} not in f32/bf16")
    check_head_dim("flash attention", d)
    if bh % heads:
        raise ValueError(f"batch*heads {bh} is not a multiple of heads {heads}")
    _check("q", q, q.dtype, (bh, seq_q, d))
    _check("k", k, q.dtype, (bh, seq_kv, d))
    _check("v", v, q.dtype, (bh, seq_kv, d))
    if kb is not None:
        _check("key_bias", kb, torch.float32, (bh // heads, seq_kv))
    return bh, seq_q, seq_kv


def uses_tensor_cores(dtype: torch.dtype, head_dim: int) -> bool:
    """Whether the flash kernels take their tensor-core variants: bf16 at
    head_dim 16 to 128 (8 is under the mma's k16 depth). The C entry
    points choose by the same rule; nothing else switches the variant,
    and a failed launch raises rather than falling back."""
    return dtype == torch.bfloat16 and head_dim >= 16


def _count(kernel, q: torch.Tensor) -> None:
    """One launch of ``kernel`` on q's dtype and head_dim, by variant."""
    if uses_tensor_cores(q.dtype, q.shape[-1]):
        kernel.tensor_core_launches += 1
    else:
        kernel.simt_launches += 1
    kernel.launches += 1


def _fn(name: str, n_ptrs: int):
    fn = getattr(_build.library("flash_attention"), name)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_void_p])
    return fn


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def flash_fwd(q, k, v, kb=None, *, heads: int = 1, causal: bool = True,
              sm_scale: float | None = None):
    """Forward kernel on folded q [BH, seq_q, D], k/v [BH, seq_kv, D]
    (f32 or bf16, contiguous, D in :data:`SUPPORTED_HEAD_DIMS`) and an
    optional f32 key bias [BH/heads, seq_kv]: returns (O, lse [BH, seq_q]
    f32). bf16 at D >= 16 runs on the tensor cores, which round the
    probabilities to bf16 for P V. CPU tensors take
    :func:`flash_fwd_plain`."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, kb, heads=heads, causal=causal, sm_scale=sm_scale)
    bh, seq_q, seq_kv = _check_qkv(q, k, v, kb, heads)
    o = torch.empty_like(q)
    lse = torch.empty(bh, seq_q, dtype=torch.float32, device=q.device)
    status = _fn("flash_fwd", 6)(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(kb),
        o.data_ptr(), lse.data_ptr(), bh, heads, seq_q, seq_kv, q.shape[2], int(causal),
        float(sm_scale), _stream(q),
    )
    _build.check(status, "flash_fwd")
    _count(flash_fwd, q)
    return o, lse


def _check_bwd(q, do, lse, delta, dlse):
    bh, seq_q, d = q.shape
    _check("do", do, q.dtype, (bh, seq_q, d))
    for name, t in (("lse", lse), ("delta", delta), ("dlse", dlse)):
        _check(name, t, torch.float32, (bh, seq_q))


def flash_bwd_dkv(q, k, v, do, lse, delta, dlse, kb=None, *, heads: int = 1,
                  causal: bool = True, sm_scale: float | None = None):
    """dK/dV kernel: (dK, dV) from the forward's inputs, dO (q's dtype),
    lse, delta = rowsum(dO * O) and the lse cotangent (f32 [BH, seq_q]).
    bf16 at D >= 16 runs on the tensor cores, which round p and ds to
    bf16 for their products. CPU tensors take
    :func:`flash_bwd_dkv_plain`."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_bwd_dkv_plain(q, k, v, do, lse, delta, dlse, kb, heads=heads,
                                   causal=causal, sm_scale=sm_scale)
    bh, seq_q, seq_kv = _check_qkv(q, k, v, kb, heads)
    _check_bwd(q, do, lse, delta, dlse)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    status = _fn("flash_bwd_dkv", 10)(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dlse.data_ptr(), _ptr(kb), dk.data_ptr(),
        dv.data_ptr(), bh, heads, seq_q, seq_kv, q.shape[2], int(causal), float(sm_scale),
        _stream(q),
    )
    _build.check(status, "flash_bwd_dkv")
    _count(flash_bwd_dkv, q)
    return dk, dv


def flash_bwd_dq(q, k, v, do, lse, delta, dlse, kb=None, *, heads: int = 1,
                 causal: bool = True, sm_scale: float | None = None):
    """dQ kernel: dQ from the same inputs as :func:`flash_bwd_dkv`, on
    the tensor cores by the same rule. CPU tensors take
    :func:`flash_bwd_dq_plain`."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, do, lse, delta, dlse, kb, heads=heads,
                                  causal=causal, sm_scale=sm_scale)
    bh, seq_q, seq_kv = _check_qkv(q, k, v, kb, heads)
    _check_bwd(q, do, lse, delta, dlse)
    dq = torch.empty_like(q)
    status = _fn("flash_bwd_dq", 9)(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dlse.data_ptr(), _ptr(kb), dq.data_ptr(),
        bh, heads, seq_q, seq_kv, q.shape[2], int(causal), float(sm_scale), _stream(q),
    )
    _build.check(status, "flash_bwd_dq")
    _count(flash_bwd_dq, q)
    return dq


for _kernel in (flash_fwd, flash_bwd_dkv, flash_bwd_dq):
    _kernel.launches = _kernel.tensor_core_launches = _kernel.simt_launches = 0


# ------------------------------------------------------------ autograd


class _FlashFunction(torch.autograd.Function):
    """(O, lse) of folded q/k/v with an optional key bias; backward is
    the two backward kernels. The bias gets a zero cotangent."""

    @staticmethod
    def forward(ctx, q, k, v, kb, heads, causal, sm_scale):
        o, lse = flash_fwd(q, k, v, kb, heads=heads, causal=causal, sm_scale=sm_scale)
        ctx.save_for_backward(q, k, v, kb, o, lse)
        ctx.args = (heads, causal, sm_scale)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, kb, o, lse = ctx.saved_tensors
        heads, causal, sm_scale = ctx.args
        do = torch.zeros_like(o) if do is None else do.to(q.dtype).contiguous()
        dlse = torch.zeros_like(lse) if dlse is None else dlse.float().contiguous()
        delta = (do.float() * o.float()).sum(dim=-1)
        kw = dict(heads=heads, causal=causal, sm_scale=sm_scale)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, dlse, kb, **kw)
        dq = flash_bwd_dq(q, k, v, do, lse, delta, dlse, kb, **kw)
        dkb = None if kb is None else torch.zeros_like(kb)
        return dq, dk, dv, dkb, None, None, None


# ------------------------------------------------------------ public api


def _prepare(q, k, causal, sm_scale) -> float:
    """The reference's argument check: causal needs seq_q <= seq_kv (a
    row with no visible key is degenerate; reject rather than diverge)."""
    seq_q, seq_kv = q.shape[2], k.shape[2]
    if causal and seq_q > seq_kv:
        raise ValueError(
            f"causal attention requires seq_q ({seq_q}) <= seq_kv ({seq_kv})"
        )
    return float(q.shape[-1] ** -0.5 if sm_scale is None else sm_scale)


def _flash(q, k, v, key_bias, causal, sm_scale):
    sm_scale = _prepare(q, k, causal, sm_scale)
    b, h, seq_q, d = q.shape
    fold = lambda x: x.reshape(b * h, x.shape[2], d).contiguous()
    kb = None
    if key_bias is not None:
        if tuple(key_bias.shape) != (b, k.shape[2]):
            raise ValueError(
                f"key_bias shape {tuple(key_bias.shape)} != (batch, seq_kv) "
                f"({b}, {k.shape[2]})"
            )
        kb = key_bias.float().contiguous()
    o, lse = _FlashFunction.apply(fold(q), fold(k), fold(v), kb, h, bool(causal), sm_scale)
    return o.reshape(b, h, seq_q, d), lse.reshape(b, h, seq_q)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    sm_scale: float | None = None,
    key_bias: torch.Tensor | None = None,
) -> torch.Tensor:
    """Blockwise attention, differentiable; q/k/v [batch, heads, seq,
    dim]. ``key_bias``: optional [batch, seq_kv] additive score bias,
    non-differentiable (zero cotangent)."""
    return _flash(q, k, v, key_bias, causal, sm_scale)[0]


def flash_attention_with_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    sm_scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Like :func:`flash_attention` but also returns the row logsumexp
    [batch, heads, seq_q] (f32), differentiable in both outputs: partial
    results merge exactly through their lse."""
    return _flash(q, k, v, None, causal, sm_scale)


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    sm_scale: float | None = None,
    use_flash: bool = True,
) -> torch.Tensor:
    """Dispatcher: the flash kernels when enabled, the plain reference
    otherwise."""
    if use_flash:
        return flash_attention(q, k, v, causal=causal, sm_scale=sm_scale)
    return attention_reference(q, k, v, causal=causal, sm_scale=sm_scale)
