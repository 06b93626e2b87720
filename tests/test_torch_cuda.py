"""The port's CUDA kernels against their plain PyTorch versions, on the
card (PyTorch/CUDA port).

Every test here carries the ``cuda`` marker and skips where no GPU is
visible. The file imports no jax, so it also runs on a machine without
it; ``tests/conftest.py`` does import jax, hence on the card:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda

Tolerances are the JAX suite's for the same kernels: atol 2e-5 for f32
flash-decode, 2e-2 for bf16, 2e-6 for paged decode (fp32 and int8).
"""

import numpy as np
import pytest
import torch

from tensorflow_examples_torch.core import precision
from tensorflow_examples_torch.ops import decode, paged_decode

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the card")
    return torch.device("cuda")


def _randn(rng, shape, dev, dtype=torch.float32):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, dtype)


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("q_len,max_len,length", [(100, 100, 100), (1, 1024, 300), (70, 512, 200)])
def test_flash_decode_matches_plain(dev, dtype, atol, q_len, max_len, length):
    rng = np.random.default_rng(q_len + length)
    q = _randn(rng, (2, 12, q_len, 64), dev, dtype)
    k, v = (_randn(rng, (2, 12, max_len, 64), dev, dtype) for _ in range(2))
    before = decode.flash_decode_attention.launches
    out = decode.flash_decode_attention(q, k, v, length)
    assert decode.flash_decode_attention.launches == before + 1
    ref = decode.decode_attention_reference(q, k, v, length)
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=atol)


@pytest.mark.parametrize("quantized", [False, True])
def test_paged_decode_matches_plain(dev, quantized):
    rng = np.random.default_rng(7)
    lengths = torch.tensor([0, 1, 16, 17, 40], dtype=torch.int32, device=dev)
    tables = torch.tensor([[0, 0, 0], [1, 0, 0], [2, 0, 0], [3, 4, 0], [5, 6, 7]],
                          dtype=torch.int32, device=dev)
    q = _randn(rng, (5, 12, 64), dev)
    kb, vb = (_randn(rng, (8, 12, 16, 64), dev) for _ in range(2))
    kw = {}
    if quantized:
        (kb, ks), (vb, vs) = precision.quantize_int8_rows(kb), precision.quantize_int8_rows(vb)
        kw = {"k_scale": ks, "v_scale": vs}
    out = paged_decode.paged_decode_attention(q, kb, vb, lengths, tables, **kw)
    ref = paged_decode.paged_decode_reference(q, kb, vb, lengths, tables, **kw)
    torch.testing.assert_close(out[1:], ref[1:], atol=2e-6, rtol=2e-6)
    assert float(out[0].abs().max()) == 0.0  # an empty slot writes zeros


def test_kernels_refuse_what_they_cannot_launch(dev):
    q = torch.zeros(1, 2, 4, 32, device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        decode.flash_decode_attention(q, q, q, 4)
    q = torch.zeros(1, 2, 4, 64, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        decode.flash_decode_attention(q, q.transpose(2, 3).contiguous().transpose(2, 3), q, 4)
