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

:func:`gmm` and :func:`tgmm` have two kernels each and pick one by what
they are given, counting each beside ``launches``: bf16 with k and n
multiples of 8 and 16-byte-aligned operands (every gmm and tgmm of the
MoE step) runs on the tensor cores (``tensor_core_launches``); anything
else, f32 included, runs the SIMT kernel (``simt_launches``).

:func:`grouped_matmul` is the differentiable product, a
``torch.autograd.Function`` whose backward is megablox's ``_gmm_bwd``:
``dlhs = gmm(grad, rhs, transpose_rhs=not transpose_rhs)`` and
``drhs = tgmm(lhs.T, grad)`` in ``rhs``'s dtype.

:func:`group_row_sum` (plain version :func:`group_row_sum_plain`) sums
each segment's rows, ``x [m, n] -> [g, n]``: the backward of gathering
one row per expert onto rows sorted by expert (the MoE biases, in
``parallel/moe.py``). Not the port of a TPU kernel: its kernel replaces
PyTorch's scatter-add backward of that gather, deterministic and without
a host sync.
"""

from __future__ import annotations

import ctypes

import torch

from tensorflow_examples_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# Rows of a group one tensor-core tgmm CTA sums at most: a larger group is
# split into chunks whose f32 partials a second launch adds in order. At
# 4096 a balanced 8-way MoE step (2048 rows a group) is never split, and
# all 16384 rows in one group make 4 chunks (37.7 MB of partials at k 768,
# n 3072).
TGMM_CHUNK_ROWS = 4096
# Rows of a group one group_row_sum CTA sums at most: 16 a warp.
ROW_SUM_CHUNK_ROWS = 128


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


def group_row_sum_plain(x: torch.Tensor, group_sizes: torch.Tensor,
                        num_groups: int | None = None) -> torch.Tensor:
    """The group_row_sum kernel's function: each segment's rows summed in
    f32, zeros for an empty one; [g, n] in ``x``'s dtype."""
    g = group_sizes.shape[0] if num_groups is None else num_groups
    out = torch.zeros(g, x.shape[1], dtype=torch.float32, device=x.device)
    for i, (start, end) in enumerate(_offsets(group_sizes[:g], x.shape[0])):
        out[i] = x[start:end].float().sum(dim=0)
    return out.to(x.dtype)


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


_P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
# Each C entry's arguments (ops/csrc/grouped_matmul.cu).
_SIGNATURES = {
    "gmm": [_I, _I, _P, _P, _P, _P, _L, _L, _L, _I, _P],
    "tgmm": [_I, _I, _P, _P, _P, _P, _L, _L, _L, _I, _P],
    "gmm_tc": [_I, _P, _P, _P, _P, _L, _L, _L, _I, _P],
    "tgmm_tc": [_I, _P, _P, _P, _P, _P, _L, _L, _L, _I, _L, _P],
    "group_row_sum": [_I, _P, _P, _P, _P, _L, _L, _I, _L, _P],
}


def _fn(name: str):
    fn = getattr(_build.library("grouped_matmul"), name)
    fn.restype = ctypes.c_int
    fn.argtypes = _SIGNATURES[name]
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
    (default: all of ``group_sizes``) takes the first segments only. On
    the tensor cores where :func:`tgmm_uses_tensor_cores` says so. CPU
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
    if tgmm_uses_tensor_cores(lhs_t, rhs):
        partial = torch.empty(_tgmm_partial_slots(m, g, TGMM_CHUNK_ROWS) * k * n,
                              dtype=torch.float32, device=lhs_t.device)
        status = _fn("tgmm_tc")(int(lhs_mk), lhs_t.data_ptr(), rhs.data_ptr(), sizes.data_ptr(),
                                out.data_ptr(), partial.data_ptr(), m, k, n, g, TGMM_CHUNK_ROWS,
                                _stream(lhs_t))
        _build.check(status, "tgmm_tc")
        tgmm.tensor_core_launches += 1
    else:
        status = _fn("tgmm")(_DTYPES[lhs_t.dtype], int(lhs_mk), lhs_t.data_ptr(),
                             rhs.data_ptr(), sizes.data_ptr(), out.data_ptr(), m, k, n, g,
                             _stream(lhs_t))
        _build.check(status, "tgmm")
        tgmm.simt_launches += 1
    tgmm.launches += 1
    return out


def tgmm_uses_tensor_cores(lhs_t: torch.Tensor, rhs: torch.Tensor) -> bool:
    """Whether :func:`tgmm` takes its tensor-core kernel for ``lhs_t``
    (``lhs.T`` or a contiguous [k, m]) and a contiguous ``rhs``: bf16, k
    and n multiples of 8 and 16-byte-aligned bases, which its 16-byte
    copies and stores need; a contiguous [k, m] also needs m a multiple
    of 8, since its copies run along m."""
    k, m = lhs_t.shape
    lhs_mk = not lhs_t.is_contiguous()
    return (lhs_t.dtype == torch.bfloat16 and k % 8 == 0 and rhs.shape[1] % 8 == 0
            and (lhs_mk or m % 8 == 0)
            and lhs_t.data_ptr() % 16 == 0 and rhs.data_ptr() % 16 == 0)


def _tgmm_partial_slots(m: int, g: int, rows: int) -> int:
    """The most [k, n] f32 partials a tensor-core tgmm can write: one per
    chunk of each group of more than ``rows`` rows. There are at most
    q = min(g, m // (rows + 1)) such groups, and their chunks number at
    most (their rows + q (rows - 1)) // rows, with their rows <= m."""
    q = min(g, m // (rows + 1))
    return (m + q * (rows - 1)) // rows if q else 0


def group_row_sum(x: torch.Tensor, group_sizes: torch.Tensor,
                  num_groups: int | None = None) -> torch.Tensor:
    """Kernel: ``x [m, n]`` -> [g, n], row i the f32 sum of segment i's
    rows rounded once to ``x``'s dtype, zeros for an empty segment; rows
    past the last segment count nowhere. Deterministic: no atomics, so a
    rerun is bit-identical. CPU tensors take :func:`group_row_sum_plain`."""
    if x.device.type == "cpu":
        return group_row_sum_plain(x, group_sizes, num_groups)
    sizes = _check("group_row_sum", x, x, group_sizes)
    g = sizes.shape[0] if num_groups is None else int(num_groups)
    if x.dim() != 2 or not 1 <= g <= sizes.shape[0]:
        raise ValueError(f"group_row_sum: x {tuple(x.shape)} and {g} of {sizes.shape[0]} "
                         "groups do not fit")
    x = x.contiguous()
    m, n = x.shape
    out = torch.empty(g, n, dtype=x.dtype, device=x.device)
    partial = torch.empty((-(-m // ROW_SUM_CHUNK_ROWS) + g) * n, dtype=torch.float32,
                          device=x.device)
    status = _fn("group_row_sum")(_DTYPES[x.dtype], x.data_ptr(), sizes.data_ptr(),
                                  out.data_ptr(), partial.data_ptr(), m, n, g,
                                  ROW_SUM_CHUNK_ROWS, _stream(x))
    _build.check(status, "group_row_sum")
    group_row_sum.launches += 1
    return out


gmm.launches = 0
gmm.tensor_core_launches = 0
gmm.simt_launches = 0
tgmm.launches = 0
tgmm.tensor_core_launches = 0
tgmm.simt_launches = 0
group_row_sum.launches = 0


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
