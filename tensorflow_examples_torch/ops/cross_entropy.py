"""Softmax cross-entropy for LM heads: the port of
``tensorflow_examples_tpu/ops/cross_entropy.py``.

``fused=True`` (the default, as in the reference) runs
:class:`_FusedCE`, a ``torch.autograd.Function`` whose forward is
:func:`ce_fwd` (per-row NLL and lse in one pass over the logits) and
whose backward is :func:`ce_bwd` (``dlogits = g * (softmax - onehot)``
from the saved lse, in the logits' dtype). Each launches its hand-written
Hopper kernel in ``ops/csrc/cross_entropy.cu`` for CUDA tensors (or
raises) and runs its plain PyTorch version (:func:`ce_fwd_plain`,
:func:`ce_bwd_plain`) for CPU tensors. The Function saves what the
reference's ``custom_vjp`` saves: the logits as given, the labels and
the lse, never an f32 copy of the logits.

``fused=False`` is the reference's ``cross_entropy_reference``: the f32
logsumexp minus the label's logit, differentiated by autograd. A label
outside ``[0, V)`` selects 0 on both paths (``ops/losses.select_label``).
"""

from __future__ import annotations

import ctypes

import torch

from tensorflow_examples_torch.ops import _build
from tensorflow_examples_torch.ops.losses import select_label, weighted_mean

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def cross_entropy_reference(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-example NLL [N] in f32 from logits [N, V] and int labels [N]."""
    logits = logits.float()
    return torch.logsumexp(logits, dim=-1) - select_label(logits, labels)


# ------------------------------------------------ plain kernel versions


def ce_fwd_plain(logits: torch.Tensor, labels: torch.Tensor):
    """(nll, lse), both [N] f32: the forward kernel's function. The
    running max starts at -1e30 and ``l`` is clamped at 1e-30, as in the
    reference kernel."""
    x = logits.float()
    m = x.amax(dim=-1).clamp_min(NEG_INF)
    l = torch.exp(x - m[:, None]).sum(dim=-1)
    lse = m + torch.log(l.clamp_min(1e-30))
    return lse - select_label(x, labels), lse


def ce_bwd_plain(logits: torch.Tensor, labels: torch.Tensor, lse: torch.Tensor,
                 g: torch.Tensor) -> torch.Tensor:
    """dlogits [N, V] in the logits' dtype: the backward kernel's
    function, ``g * (exp(x - lse) - onehot(label))`` in f32."""
    x = logits.float()
    col = torch.arange(x.shape[-1], device=x.device)
    onehot = (col[None, :] == labels.long()[:, None]).float()
    return (g.float()[:, None] * (torch.exp(x - lse.float()[:, None]) - onehot)).to(logits.dtype)


# ------------------------------------------------------- kernel wrappers


def _fn(name: str, n_ptrs: int):
    fn = getattr(_build.library("cross_entropy"), name)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * n_ptrs
                   + [ctypes.c_longlong] * 2 + [ctypes.c_void_p])
    return fn


def _check_logits(logits: torch.Tensor, labels: torch.Tensor):
    if logits.dtype not in _DTYPES:
        raise ValueError(f"fused cross-entropy: dtype {logits.dtype} not in f32/bf16")
    if logits.dim() != 2 or labels.shape != logits.shape[:1]:
        raise ValueError(f"fused cross-entropy: logits {tuple(logits.shape)} and labels "
                         f"{tuple(labels.shape)} are not [N, V] and [N]")
    if not labels.is_cuda or labels.device != logits.device:
        raise ValueError("labels must be a CUDA tensor on the logits' device")
    # torch gives int64 labels; the kernels read int32, as the reference casts.
    return logits.contiguous(), labels.to(torch.int32).contiguous()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def ce_fwd(logits: torch.Tensor, labels: torch.Tensor):
    """Forward kernel on logits [N, V] (f32 or bf16) and int labels [N]:
    returns (nll, lse), both [N] f32. CPU tensors take
    :func:`ce_fwd_plain`."""
    if logits.device.type == "cpu":
        return ce_fwd_plain(logits, labels)
    logits, labels32 = _check_logits(logits, labels)
    n, vocab = logits.shape
    nll = torch.empty(n, dtype=torch.float32, device=logits.device)
    lse = torch.empty_like(nll)
    status = _fn("ce_fwd", 4)(_DTYPES[logits.dtype], logits.data_ptr(), labels32.data_ptr(),
                              nll.data_ptr(), lse.data_ptr(), n, vocab, _stream(logits))
    _build.check(status, "ce_fwd")
    ce_fwd.launches += 1
    return nll, lse


def ce_bwd(logits: torch.Tensor, labels: torch.Tensor, lse: torch.Tensor,
           g: torch.Tensor) -> torch.Tensor:
    """Backward kernel: dlogits [N, V] in the logits' dtype from the
    forward's logits and labels, its lse and the NLL cotangent ``g`` [N]
    (any stride: it is read as a contiguous f32 copy). CPU tensors take
    :func:`ce_bwd_plain`."""
    if logits.device.type == "cpu":
        return ce_bwd_plain(logits, labels, lse, g)
    logits, labels32 = _check_logits(logits, labels)
    n, vocab = logits.shape
    lse = lse.float().contiguous()
    g = g.float().contiguous()
    if lse.shape != (n,) or g.shape != (n,):
        raise ValueError(f"ce_bwd: lse {tuple(lse.shape)} and g {tuple(g.shape)} are not [{n}]")
    dlogits = torch.empty_like(logits)
    status = _fn("ce_bwd", 5)(_DTYPES[logits.dtype], logits.data_ptr(), labels32.data_ptr(),
                              lse.data_ptr(), g.data_ptr(), dlogits.data_ptr(), n, vocab,
                              _stream(logits))
    _build.check(status, "ce_bwd")
    ce_bwd.launches += 1
    return dlogits


ce_fwd.launches = 0
ce_bwd.launches = 0


class _FusedCE(torch.autograd.Function):
    """Per-row NLL of logits [N, V]; backward is the backward kernel.
    Under ``torch.no_grad`` (eval) the forward kernel still runs."""

    @staticmethod
    def forward(ctx, logits, labels):
        nll, lse = ce_fwd(logits, labels)
        ctx.save_for_backward(logits, labels, lse)
        return nll

    @staticmethod
    def backward(ctx, g):
        logits, labels, lse = ctx.saved_tensors
        return ce_bwd(logits, labels, lse, g), None


# ------------------------------------------------------------ public api


def cross_entropy_per_example(logits: torch.Tensor, labels: torch.Tensor, *,
                              block_n: int = 256, block_v: int = 4096,
                              fused: bool = True) -> torch.Tensor:
    """Per-example NLL [N] (f32) from logits [N, V] and int labels [N].
    ``block_n`` and ``block_v`` are the reference's TPU tile sizes, kept
    for signature parity at their defaults only: the CUDA kernels pick
    their own tiling, so any other value raises ``ValueError`` rather
    than being silently ignored."""
    if (block_n, block_v) != (256, 4096):
        raise ValueError(
            f"cross_entropy_per_example: block_n={block_n}, block_v={block_v} are TPU tile "
            "sizes; the CUDA kernels choose their own tiling, so only the defaults "
            "(256, 4096) are accepted"
        )
    if not fused:
        return cross_entropy_reference(logits, labels)
    return _FusedCE.apply(logits, labels)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       weights: torch.Tensor | None = None, *,
                       fused: bool = True) -> torch.Tensor:
    """Weighted-mean token cross-entropy: logits [..., V], labels [...],
    optional weights [...] masking padding."""
    vocab = logits.shape[-1]
    nll = cross_entropy_per_example(logits.reshape(-1, vocab), labels.reshape(-1),
                                    fused=fused)
    return weighted_mean(nll, None if weights is None else weights.reshape(-1))


# ------------------------------------------------------------------ meshes


def mesh_cross_entropy_per_example(logits: torch.Tensor, labels: torch.Tensor, *, mesh,
                                   fused: bool = True) -> torch.Tensor:
    """Per-example NLL [B, S] of this rank's token shard: logits [B, S, V]
    and labels [B, S] are its rows (and its ``context`` sequence shard),
    so the fused kernels run locally with no collective, the reference's
    token-sharded ``shard_map``. The reference also splits the sequence
    over ``model`` where it divides; here ``model`` ranks compute the
    same tokens, because splitting replicated logits would cost a
    ``[tokens, vocab]`` gradient gather over ``model`` in the backward:
    the vocab-parallel head (:func:`tp_cross_entropy_from_hidden`) is
    the route that divides the head's work over ``model``."""
    del mesh  # every rank already holds exactly its tokens
    v = logits.shape[-1]
    return cross_entropy_per_example(logits.reshape(-1, v), labels.reshape(-1),
                                     fused=fused).reshape(labels.shape)


def tp_cross_entropy_from_hidden(hidden: torch.Tensor, wte: torch.Tensor, labels: torch.Tensor,
                                 *, mesh, axis_name: str = "model",
                                 vocab_size: int | None = None) -> torch.Tensor:
    """Per-example NLL [N] with the vocab split over ``axis_name`` (the
    Megatron parallel LM head): ``hidden`` [N, d] (post ``ln_f``,
    replicated over the axis), ``wte`` the tied table, whole [V, d] or
    this rank's rows [ceil(V/m), d] (``vocab_size`` then names V), and
    int ``labels`` [N]. Each rank computes its [N, V/m] logits in f32,
    and only the online-softmax partials cross ranks: the row max
    (``pmax``, not differentiated: a stabilizer), the rescaled sum of
    exponentials and the label's logit (``psum``). A vocab that does not
    divide gives the last rank fewer rows, the reference's padding
    without the pad. Degenerates to the fused kernels when the axis is
    trivial."""
    vocab = vocab_size or wte.shape[0]
    m = 1 if mesh is None else mesh.axis_size(axis_name)
    if m == 1:
        logits = hidden.float() @ wte.float().T
        return cross_entropy_per_example(logits, labels)
    from tensorflow_examples_torch.core import collectives as coll

    v_local = -(-vocab // m)
    i = mesh.axis_index(axis_name)
    if wte.shape[0] == vocab:  # whole table: this rank's rows, gradients summed over the axis
        w = coll.copy_to(wte, axis_name, mesh=mesh)[i * v_local:min((i + 1) * v_local, vocab)]
    elif wte.shape[0] == v_local and vocab % m == 0:
        w = wte
    else:
        raise ValueError(f"wte rows {wte.shape[0]} are neither the vocab {vocab} nor its "
                         f"{m}-way shard")
    s = coll.copy_to(hidden, axis_name, mesh=mesh).float() @ w.float().T
    labels = labels.long()
    if s.shape[1]:
        row_max = s.amax(dim=1)
        sumexp = torch.exp(s - row_max[:, None]).sum(dim=1)
        col = i * v_local + torch.arange(s.shape[1], device=s.device)
        label_logit = torch.where(col[None] == labels[:, None], s, 0.0).sum(dim=1)
    else:  # a vocab smaller than the shards leaves this rank none
        row_max = torch.full(s.shape[:1], NEG_INF, device=s.device)
        sumexp = label_logit = torch.zeros(s.shape[:1], device=s.device) + 0.0 * s.sum()
    gm = coll.pmax(row_max, axis_name, mesh=mesh)
    gl = coll.psum(sumexp * torch.exp(row_max - gm), axis_name, mesh=mesh)
    gt = coll.psum(label_logit, axis_name, mesh=mesh)
    return gm + torch.log(torch.clamp(gl, min=1e-30)) - gt
