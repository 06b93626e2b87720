"""Grouped matrix multiplication: the port of the megablox ``gmm``/``tgmm``
pair that ``tensorflow_examples_tpu/parallel/moe.py`` ``_grouped_matmul``
calls on a TPU (``jax.experimental.pallas.ops.tpu.megablox``).

``group_sizes`` [g] (int32, on the operands' device) cuts the rows of the
[m, ...] operand into consecutive segments: segment i is rows
``[off_i, off_i + size_i)`` with ``off_i`` the exclusive cumsum, clamped to
m.

* :func:`gmm`: ``lhs [m, k] x rhs [g, k, n] -> [m, n]`` in ``lhs``'s dtype,
  segment i's rows times ``rhs[i]`` (``rhs [g, n, k]`` read transposed
  with ``transpose_rhs``); rows past the last segment are 0.
* :func:`tgmm`: ``lhs_t [k, m] x rhs [m, n] -> [g, k, n]``, out[i] the
  product over segment i's rows only; an empty segment gives zeros.

Products and sums are f32 whatever the inputs' dtype. Each launches its
hand-written Hopper kernel in ``ops/csrc/grouped_matmul.cu`` for CUDA
tensors (or raises) and runs its plain PyTorch version (:func:`gmm_plain`,
:func:`tgmm_plain`, a loop over the segments) for CPU tensors. The kernels
read the sizes on the device: no call syncs with the host. The megablox
tiling argument has no counterpart: the kernels pick their own tiles and
take any m, k and n.

:func:`gmm` has two kernels and picks one by what it is given, counting
each beside ``gmm.launches``: bf16 with k and n multiples of 8 and
16-byte-aligned operands (every gmm of the MoE step) runs on the tensor
cores (``gmm.tensor_core_launches``); anything else, f32 included, runs
the SIMT kernel (``gmm.simt_launches``).

:func:`grouped_matmul` is the differentiable product, a
``torch.autograd.Function`` whose backward is megablox's ``_gmm_bwd``:
``dlhs = gmm(grad, rhs, transpose_rhs=not transpose_rhs)`` and
``drhs = tgmm(lhs.T, grad)`` in ``rhs``'s dtype.
"""

from __future__ import annotations

import ctypes

import torch

from tensorflow_examples_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _offsets(group_sizes: torch.Tensor, m: int) -> list[tuple[int, int]]:
    """Each segment's [start, end) rows, clamped to m (a host sync: the
    plain versions only)."""
    bounds, start = [], 0
    for size in group_sizes.tolist():
        end = min(start + max(int(size), 0), m)
        bounds.append((start, end))
        start = end
    return bounds


# ------------------------------------------------ plain kernel versions


def gmm_plain(lhs: torch.Tensor, rhs: torch.Tensor, group_sizes: torch.Tensor, *,
              transpose_rhs: bool = False) -> torch.Tensor:
    """The gmm kernel's function: one f32 product per segment."""
    out = torch.zeros(lhs.shape[0], rhs.shape[1 if transpose_rhs else 2],
                      dtype=torch.float32, device=lhs.device)
    for i, (start, end) in enumerate(_offsets(group_sizes, lhs.shape[0])):
        w = rhs[i].float()
        out[start:end] = lhs[start:end].float() @ (w.T if transpose_rhs else w)
    return out.to(lhs.dtype)


def tgmm_plain(lhs_t: torch.Tensor, rhs: torch.Tensor, group_sizes: torch.Tensor,
               num_groups: int | None = None) -> torch.Tensor:
    """The tgmm kernel's function: one f32 product per segment, zeros for
    an empty one; [g, k, n] in ``lhs_t``'s dtype."""
    g = group_sizes.shape[0] if num_groups is None else num_groups
    out = torch.zeros(g, lhs_t.shape[0], rhs.shape[1], dtype=torch.float32, device=lhs_t.device)
    for i, (start, end) in enumerate(_offsets(group_sizes[:g], lhs_t.shape[1])):
        out[i] = lhs_t[:, start:end].float() @ rhs[start:end].float()
    return out.to(lhs_t.dtype)


# ------------------------------------------------------- kernel wrappers


def _fn(name: str):
    fn = getattr(_build.library("grouped_matmul"), name)
    fn.restype = ctypes.c_int
    ints = 1 if name == "gmm_tc" else 2  # gmm_tc takes no dtype
    fn.argtypes = ([ctypes.c_int] * ints + [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 3
                   + [ctypes.c_int, ctypes.c_void_p])
    return fn


def _check(what: str, a: torch.Tensor, b: torch.Tensor,
           group_sizes: torch.Tensor) -> torch.Tensor:
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise ValueError(f"{what}: dtypes {a.dtype} and {b.dtype}; the kernel takes f32 or bf16, "
                         "both operands alike")
    if not (b.is_cuda and group_sizes.is_cuda) or b.device != a.device or \
            group_sizes.device != a.device:
        raise ValueError(f"{what}: operands and group_sizes must be CUDA tensors on one device")
    if group_sizes.dim() != 1:
        raise ValueError(f"{what}: group_sizes {tuple(group_sizes.shape)} is not [g]")
    return group_sizes.to(torch.int32).contiguous()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def gmm(lhs: torch.Tensor, rhs: torch.Tensor, group_sizes: torch.Tensor, *,
        transpose_rhs: bool = False) -> torch.Tensor:
    """Kernel: ``lhs [m, k]`` times ``rhs [g, k, n]`` (``[g, n, k]`` with
    ``transpose_rhs``) per row segment -> [m, n] in ``lhs``'s dtype, on the
    tensor cores where :func:`uses_tensor_cores` says so. CPU tensors take
    :func:`gmm_plain`."""
    if lhs.device.type == "cpu":
        return gmm_plain(lhs, rhs, group_sizes, transpose_rhs=transpose_rhs)
    sizes = _check("gmm", lhs, rhs, group_sizes)
    if lhs.dim() != 2 or rhs.dim() != 3 or rhs.shape[0] != sizes.shape[0] or \
            rhs.shape[2 if transpose_rhs else 1] != lhs.shape[1]:
        raise ValueError(f"gmm: lhs {tuple(lhs.shape)}, rhs {tuple(rhs.shape)} and "
                         f"{sizes.shape[0]} groups do not fit (transpose_rhs={transpose_rhs})")
    m, k = lhs.shape
    n = rhs.shape[1 if transpose_rhs else 2]
    lhs, rhs = lhs.contiguous(), rhs.contiguous()
    out = torch.empty(m, n, dtype=lhs.dtype, device=lhs.device)
    args = (int(transpose_rhs), lhs.data_ptr(), rhs.data_ptr(), sizes.data_ptr(),
            out.data_ptr(), m, k, n, sizes.shape[0], _stream(lhs))
    if uses_tensor_cores(lhs, rhs, n):
        _build.check(_fn("gmm_tc")(*args), "gmm_tc")
        gmm.tensor_core_launches += 1
    else:
        _build.check(_fn("gmm")(_DTYPES[lhs.dtype], *args), "gmm")
        gmm.simt_launches += 1
    gmm.launches += 1
    return out


def uses_tensor_cores(lhs: torch.Tensor, rhs: torch.Tensor, n: int) -> bool:
    """Whether :func:`gmm` takes its tensor-core kernel for these
    (contiguous) operands and output width: bf16, k and n multiples of 8
    and 16-byte-aligned bases, which its 16-byte copies and stores need."""
    return (lhs.dtype == torch.bfloat16 and lhs.shape[1] % 8 == 0 and n % 8 == 0
            and lhs.data_ptr() % 16 == 0 and rhs.data_ptr() % 16 == 0)


def tgmm(lhs_t: torch.Tensor, rhs: torch.Tensor, group_sizes: torch.Tensor,
         num_groups: int | None = None) -> torch.Tensor:
    """Kernel: ``lhs_t [k, m]`` times ``rhs [m, n]`` over each row segment
    -> [g, k, n] in ``lhs_t``'s dtype, zeros for an empty segment.
    ``lhs_t`` may be contiguous or the transposed view of a contiguous
    [m, k] (``lhs.T``), which the kernel reads in place. ``num_groups``
    (default: all of ``group_sizes``) takes the first segments only. CPU
    tensors take :func:`tgmm_plain`."""
    if lhs_t.device.type == "cpu":
        return tgmm_plain(lhs_t, rhs, group_sizes, num_groups)
    sizes = _check("tgmm", lhs_t, rhs, group_sizes)
    g = sizes.shape[0] if num_groups is None else int(num_groups)
    if lhs_t.dim() != 2 or rhs.dim() != 2 or lhs_t.shape[1] != rhs.shape[0] or \
            not 1 <= g <= sizes.shape[0]:
        raise ValueError(f"tgmm: lhs_t {tuple(lhs_t.shape)}, rhs {tuple(rhs.shape)} and "
                         f"{g} of {sizes.shape[0]} groups do not fit")
    k, m = lhs_t.shape
    n = rhs.shape[1]
    lhs_mk = not lhs_t.is_contiguous() and lhs_t.T.is_contiguous()
    if not (lhs_mk or lhs_t.is_contiguous()):
        lhs_t = lhs_t.contiguous()
    rhs = rhs.contiguous()
    out = torch.empty(g, k, n, dtype=lhs_t.dtype, device=lhs_t.device)
    status = _fn("tgmm")(_DTYPES[lhs_t.dtype], int(lhs_mk), lhs_t.data_ptr(), rhs.data_ptr(),
                         sizes.data_ptr(), out.data_ptr(), m, k, n, g, _stream(lhs_t))
    _build.check(status, "tgmm")
    tgmm.launches += 1
    return out


gmm.launches = 0
gmm.tensor_core_launches = 0
gmm.simt_launches = 0
tgmm.launches = 0


class _GroupedMatmul(torch.autograd.Function):
    """``gmm`` with megablox's VJP. ``gmm`` and ``tgmm`` are looked up
    in this module at each call, so a caller that rebinds them (the
    on-card comparison with the plain versions) changes what runs."""

    @staticmethod
    def forward(ctx, lhs, rhs, group_sizes, transpose_rhs):
        ctx.save_for_backward(lhs, rhs, group_sizes)
        ctx.transpose_rhs = transpose_rhs
        return gmm(lhs, rhs, group_sizes, transpose_rhs=transpose_rhs)

    @staticmethod
    def backward(ctx, grad):
        lhs, rhs, group_sizes = ctx.saved_tensors
        grad = grad.contiguous()
        dlhs = drhs = None
        if ctx.needs_input_grad[0]:
            dlhs = gmm(grad, rhs, group_sizes, transpose_rhs=not ctx.transpose_rhs).to(lhs.dtype)
        if ctx.needs_input_grad[1]:
            drhs = tgmm(lhs.T, grad, group_sizes, rhs.shape[0]).to(rhs.dtype)
            if ctx.transpose_rhs:
                drhs = drhs.transpose(1, 2)
        return dlhs, drhs, None, None


def grouped_matmul(lhs: torch.Tensor, rhs: torch.Tensor, group_sizes: torch.Tensor, *,
                   transpose_rhs: bool = False) -> torch.Tensor:
    """Differentiable :func:`gmm` (gradients through :func:`gmm` and
    :func:`tgmm`, as megablox's ``_gmm_bwd``)."""
    return _GroupedMatmul.apply(lhs, rhs, group_sizes, transpose_rhs)
