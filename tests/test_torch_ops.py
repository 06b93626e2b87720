"""The port's attention ops against the JAX package's (PyTorch/CUDA port).

Inputs come from numpy seeds and go through both packages on the CPU:
the JAX Pallas kernels in interpret mode (as tests/test_kernels.py runs
them) and their XLA references, against the port's plain versions —
which is what the port's kernel wrappers run for CPU tensors. The CUDA
kernels themselves are compared with the plain versions on the card by
tests/test_torch_cuda.py and by chip_smoke.py. Tolerances are the
JAX suite's: atol 2e-5 for f32 flash-decode, 2e-2 for bf16, 2e-6 for
paged decode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_examples_tpu.core import precision as jax_precision
from tensorflow_examples_tpu.ops import decode as jax_decode
from tensorflow_examples_tpu.ops import paged_decode as jax_paged
from tensorflow_examples_torch.core import precision
from tensorflow_examples_torch.ops import _build, attention, decode, paged_decode


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: these tests run beside timing-sensitive
    serving tests in other workers and must not starve them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x)).to(dtype)


class TestFlashDecodeParity:
    @pytest.mark.parametrize(
        "q_len,length",
        [(1, 1), (1, 13), (1, 512), (7, 200), (128, 128), (96, 300)],
    )
    def test_matches_jax_kernel_and_reference(self, q_len, length):
        rng = np.random.default_rng(q_len * 1000 + length)
        q = _rand(rng, (2, 3, q_len, 64))
        k, v = _rand(rng, (2, 3, 512, 64)), _rand(rng, (2, 3, 512, 64))
        ours = decode.flash_decode_attention(_t(q), _t(k), _t(v), length).numpy()
        kernel = jax_decode.flash_decode_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), length
        )
        ref = jax_decode.decode_attention_reference(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), length
        )
        np.testing.assert_allclose(ours, np.asarray(kernel), atol=2e-5, rtol=2e-5)
        np.testing.assert_allclose(ours, np.asarray(ref), atol=2e-5, rtol=2e-5)

    def test_garbage_cache_tail_ignored(self):
        rng = np.random.default_rng(3)
        q = _t(_rand(rng, (1, 2, 1, 64)))
        k, v = _t(_rand(rng, (1, 2, 256, 64))), _t(_rand(rng, (1, 2, 256, 64)))
        out = decode.flash_decode_attention(q, k, v, 100)
        k2, v2 = k.clone(), v.clone()
        k2[:, :, 100:] = 1e4
        v2[:, :, 100:] = -1e4
        np.testing.assert_array_equal(
            out.numpy(), decode.flash_decode_attention(q, k2, v2, 100).numpy()
        )

    @pytest.mark.parametrize("q_len,max_len,length", [(1, 256, 300), (36, 516, 400)])
    def test_overlong_length_and_partial_blocks(self, q_len, max_len, length):
        """length > max_len clamps to the full cache; a max_len with no
        block divisor masks its padded tail (JAX kernel in interpret mode
        with block_q=32 for the odd case, as tests/test_kernels.py)."""
        rng = np.random.default_rng(max_len)
        q = _rand(rng, (1, 2, q_len, 64))
        k, v = _rand(rng, (1, 2, max_len, 64)), _rand(rng, (1, 2, max_len, 64))
        ours = decode.flash_decode_attention(_t(q), _t(k), _t(v), length).numpy()
        kw = {"block_q": 32, "block_kv": 256} if q_len > 1 else {}
        kernel = jax_decode.flash_decode_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), length, **kw
        )
        np.testing.assert_allclose(ours, np.asarray(kernel), atol=2e-5, rtol=2e-5)

    @pytest.mark.parametrize("head_dim", [8, 16, 128])
    def test_other_head_dims_match_jax_kernel(self, head_dim):
        rng = np.random.default_rng(head_dim)
        q = _rand(rng, (1, 2, 40, head_dim))
        k, v = _rand(rng, (1, 2, 256, head_dim)), _rand(rng, (1, 2, 256, head_dim))
        ours = decode.flash_decode_attention(_t(q), _t(k), _t(v), 200).numpy()
        kernel = jax_decode.flash_decode_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 200, block_q=8, block_kv=128
        )
        np.testing.assert_allclose(ours, np.asarray(kernel), atol=2e-5, rtol=2e-5)

    def test_bf16_cache(self):
        rng = np.random.default_rng(12)
        q = _rand(rng, (1, 2, 1, 64))
        k, v = _rand(rng, (1, 2, 128, 64)), _rand(rng, (1, 2, 128, 64))
        ours = decode.flash_decode_attention(
            _t(q, torch.bfloat16), _t(k, torch.bfloat16), _t(v, torch.bfloat16), 64
        )
        assert ours.dtype == torch.bfloat16
        kernel = jax_decode.flash_decode_attention(
            jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
            jnp.asarray(v, jnp.bfloat16), 64,
        )
        np.testing.assert_allclose(
            ours.float().numpy(), np.asarray(kernel.astype(jnp.float32)),
            atol=2e-2, rtol=2e-2,
        )


class TestPagedDecodeParity:
    BS, NB, H, D = 8, 9, 2, 16

    def _pool(self, seed):
        rng = np.random.default_rng(seed)
        shape = (self.NB, self.H, self.BS, self.D)
        return _rand(rng, shape), _rand(rng, shape)

    def _both(self, q, k, v, lengths, tables, **scales):
        j = dict(q=jnp.asarray(q), k_blocks=jnp.asarray(k), v_blocks=jnp.asarray(v),
                 lengths=jnp.asarray(lengths, jnp.int32),
                 block_tables=jnp.asarray(tables, jnp.int32),
                 **{n: jnp.asarray(s) for n, s in scales.items()})
        kernel = np.asarray(jax_paged.paged_decode_attention(**j))
        ref = np.asarray(jax_paged.paged_decode_reference(**j))
        kv_dtype = torch.int8 if scales else torch.float32
        ours = paged_decode.paged_decode_attention(
            _t(q), _t(k, kv_dtype), _t(v, kv_dtype),
            _t(lengths, torch.int32), _t(tables, torch.int32),
            **{n: _t(s) for n, s in scales.items()},
        ).numpy()
        return ours, kernel, ref

    @pytest.mark.parametrize("lengths,tables", [
        ([1, 8], [[3, 0], [5, 0]]),                                   # single block, length 1
        ([13, 21, 30], [[1, 2, 0, 0], [3, 4, 5, 0], [6, 7, 8, 2]]),  # ragged last block
        ([7, 19], [[3, 0, 0], [1, 2, 4]]),
    ])
    def test_matches_jax_kernel_and_reference(self, lengths, tables):
        rng = np.random.default_rng(sum(lengths))
        q = _rand(rng, (len(lengths), self.H, self.D))
        k, v = self._pool(len(lengths))
        ours, kernel, ref = self._both(q, k, v, lengths, tables)
        np.testing.assert_allclose(ours, kernel, atol=2e-6, rtol=2e-6)
        np.testing.assert_allclose(ours, ref, atol=2e-6, rtol=2e-6)

    @pytest.mark.parametrize("head_dim", [8, 16, 128])
    @pytest.mark.parametrize("quantized", [False, True])
    def test_other_head_dims_match_jax_kernel(self, head_dim, quantized):
        rng = np.random.default_rng(head_dim)
        shape = (self.NB, self.H, self.BS, head_dim)
        q = _rand(rng, (3, self.H, head_dim))
        k, v = _rand(rng, shape), _rand(rng, shape)
        scales = {}
        if quantized:
            k, ks = (np.asarray(x) for x in jax_precision.quantize_int8_rows(jnp.asarray(k)))
            v, vs = (np.asarray(x) for x in jax_precision.quantize_int8_rows(jnp.asarray(v)))
            scales = {"k_scale": ks, "v_scale": vs}
        ours, kernel, ref = self._both(
            q, k, v, [5, 16, 27], [[1, 0, 0, 0], [2, 3, 0, 0], [4, 5, 6, 7]], **scales
        )
        np.testing.assert_allclose(ours, kernel, atol=2e-6, rtol=2e-6)
        np.testing.assert_allclose(ours, ref, atol=2e-6, rtol=2e-6)

    def test_empty_slot_is_finite(self):
        """A parked slot (length 0) comes out finite; its output is
        discarded, so only the populated slot is compared."""
        rng = np.random.default_rng(5)
        q = _rand(rng, (2, self.H, self.D))
        k, v = self._pool(5)
        ours, kernel, _ = self._both(q, k, v, [0, 5], [[0, 0], [4, 0]])
        assert np.isfinite(ours).all()
        np.testing.assert_allclose(ours[1], kernel[1], atol=2e-6, rtol=2e-6)

    def test_null_padded_tables_never_leak(self):
        rng = np.random.default_rng(7)
        q = _t(_rand(rng, (1, self.H, self.D)))
        k, v = (_t(x) for x in self._pool(7))
        lengths, tables = _t([10], torch.int32), _t([[2, 6, 0, 0]], torch.int32)
        base = paged_decode.paged_decode_attention(q, k, v, lengths, tables)
        k[5] += 100.0  # block 5 is unreferenced
        v[5] += 100.0
        again = paged_decode.paged_decode_attention(q, k, v, lengths, tables)
        np.testing.assert_array_equal(base.numpy(), again.numpy())

    def test_int8_scales(self):
        rng = np.random.default_rng(3)
        q = _rand(rng, (3, self.H, self.D))
        k, v = self._pool(3)
        qk, ks = (np.asarray(x) for x in jax_precision.quantize_int8_rows(jnp.asarray(k)))
        qv, vs = (np.asarray(x) for x in jax_precision.quantize_int8_rows(jnp.asarray(v)))
        ours, kernel, ref = self._both(
            q, qk, qv, [5, 16, 27], [[1, 0, 0, 0], [2, 3, 0, 0], [4, 5, 6, 7]],
            k_scale=ks, v_scale=vs,
        )
        np.testing.assert_allclose(ours, kernel, atol=2e-6, rtol=2e-6)
        np.testing.assert_allclose(ours, ref, atol=2e-6, rtol=2e-6)

    def test_scale_pairing_enforced(self):
        k, v = (_t(x) for x in self._pool(0))
        with pytest.raises(ValueError, match="both k_scale and v_scale"):
            paged_decode.paged_decode_attention(
                torch.zeros(1, self.H, self.D), k, v, _t([1], torch.int32),
                _t([[0, 0]], torch.int32), k_scale=torch.ones(self.NB, self.H, self.BS),
            )


class TestSplitMerge:
    """The plain versions of the decode kernels' split-KV route: the
    partition a plan picks from shapes, each split's (acc, m, l) alone,
    and the in-order merge, against the JAX kernels in interpret mode and
    the references (atol 2e-5 flash-decode f32, 2e-2 bf16, 2e-6 paged)."""

    @pytest.mark.parametrize("q_len,length,max_len,head_dim,dtype,atol", [
        (1, 1000, 1024, 64, "float32", 2e-5),   # q_len=1 over a long cache: 16 splits
        (1, 200, 256, 64, "float32", 2e-5),     # the last split ends in a partly populated tile
        (40, 200, 256, 64, "float32", 2e-5),    # causal rows across a partial last tile
        (128, 128, 128, 64, "float32", 2e-5),   # query tile 0 has one KV tile: an empty split
        (16, 300, 512, 8, "float32", 2e-5),     # head_dim 8: block_q 64
        (1, 300, 512, 128, "float32", 2e-5),
        (64, 300, 512, 64, "bfloat16", 2e-2),   # tensor-core plan, P cast to bf16
    ])
    def test_decode_split_matches_jax_kernel_and_reference(self, q_len, length, max_len,
                                                           head_dim, dtype, atol):
        rng = np.random.default_rng(q_len + length + head_dim)
        q = _rand(rng, (1, 2, q_len, head_dim))
        k, v = _rand(rng, (1, 2, max_len, head_dim)), _rand(rng, (1, 2, max_len, head_dim))
        tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
        plan = decode.decode_plan(tdt, q_len, length, max_len, 2, head_dim)
        assert plan.splits > 1
        ours = decode.decode_split_reference(_t(q, tdt), _t(k, tdt), _t(v, tdt), length,
                                             block_q=plan.block_q, splits=plan.splits)
        assert ours.dtype == tdt
        kw = {"block_q": 8, "block_kv": 128} if q_len % 8 == 0 and max_len % 128 == 0 else {}
        kernel = jax_decode.flash_decode_attention(
            jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt), length, **kw)
        ref = decode.decode_attention_reference(_t(q, tdt), _t(k, tdt), _t(v, tdt), length)
        ours = ours.float().numpy()
        np.testing.assert_allclose(ours, np.asarray(kernel.astype(jnp.float32)),
                                   atol=atol, rtol=atol)
        np.testing.assert_allclose(ours, ref.float().numpy(), atol=atol, rtol=atol)

    @pytest.mark.parametrize("splits", [1, 2, 3, 7, 32])
    def test_any_split_count_gives_the_same_attention(self, splits):
        """The merge is exact up to rounding whatever the partition,
        including more splits than KV tiles (empty splits)."""
        rng = np.random.default_rng(splits)
        q = _t(_rand(rng, (1, 2, 70, 32)))
        k, v = (_t(_rand(rng, (1, 2, 300, 32))) for _ in range(2))
        ours = decode.decode_split_reference(q, k, v, 250, block_q=64, splits=splits)
        ref = decode.decode_attention_reference(q, k, v, 250)
        np.testing.assert_allclose(ours.numpy(), ref.numpy(), atol=2e-5, rtol=2e-5)

    def test_merge_weighs_an_empty_split_exactly_zero(self):
        rng = np.random.default_rng(0)
        acc, m, l = (_t(rng.standard_normal(shape)) for shape in ((2, 5, 8), (2, 5), (2, 5)))
        l = l.abs()
        empty = (torch.zeros(1, 5, 8), torch.full((1, 5), attention.NEG_INF), torch.zeros(1, 5))
        with_empty = decode.merge_partials(*(torch.cat([e, x]) for e, x in zip(empty, (acc, m, l))))
        np.testing.assert_array_equal(with_empty.numpy(), decode.merge_partials(acc, m, l).numpy())
        nothing = decode.merge_partials(*(x.repeat(3, *[1] * (x.dim() - 1)) for x in empty))
        assert not nothing.any()  # a slot that saw no key comes out as exact zeros

    def test_split_count_depends_only_on_shapes(self):
        """The plans are functions of host-known shapes (no tensor, no
        length on the device), pinned at the main paths' shapes."""
        import inspect

        assert list(inspect.signature(decode.decode_plan).parameters) == [
            "dtype", "q_len", "length", "max_len", "bh", "head_dim"]
        assert list(inspect.signature(paged_decode.paged_plan).parameters) == [
            "block_size", "nb"]
        f32, bf16 = torch.float32, torch.bfloat16
        plans = {
            (f32, 16, 16, 16, 12, 64): ("simt", 16, 1),        # one KV tile: nothing to split
            (f32, 128, 128, 128, 12, 64): ("simt", 64, 2),
            (f32, 512, 512, 512, 12, 64): ("simt", 64, 3),
            (f32, 1024, 1024, 1024, 12, 64): ("simt", 64, 2),
            (f32, 1, 300, 1024, 12, 64): ("simt", 16, 5),      # generate's decode step
            (f32, 1, 96, 1024, 12, 64): ("simt", 16, 2),
            (f32, 1, 300, 1024, 12, 8): ("simt", 64, 5),
            (f32, 1024, 1024, 1024, 192, 64): ("simt", 64, 1),  # a full grid
            (bf16, 16, 16, 16, 12, 64): ("tensor_core", 16, 1),
            (bf16, 32, 32, 32, 12, 64): ("tensor_core", 32, 1),
            (bf16, 1024, 1024, 1024, 12, 64): ("tensor_core", 64, 1),  # prefills never split
            (bf16, 1, 300, 1024, 12, 64): ("tensor_core", 16, 3),      # two KV tiles a split
            (bf16, 1, 96, 1024, 12, 64): ("tensor_core", 16, 1),
            (bf16, 16, 1024, 1024, 12, 64): ("tensor_core", 16, 8),
            (bf16, 100, 100, 100, 12, 8): ("simt", 64, 2),
        }
        for args, want in plans.items():
            assert tuple(decode.decode_plan(*args)) == want, args
        assert paged_decode.paged_plan(16, 64) == (8, 8)   # S=8 full cache: 8 splits
        assert paged_decode.paged_plan(16, 4) == (8, 1)    # the 64-row KV bucket: no split
        assert paged_decode.paged_plan(64, 16) == (2, 8)
        assert paged_decode.paged_plan(5, 30) == (25, 2)

    @pytest.mark.parametrize("quantized", [False, True])
    def test_paged_split_matches_jax_kernel_and_reference(self, quantized):
        """Splits of 16 blocks of 8 rows: a boundary inside a slot (130
        rows), a split holding one row (129), a full table (160), a
        length-0 slot (exact zeros) and a single row."""
        bs, nb, h, d = 8, 20, 2, 16
        lengths = [130, 0, 129, 160, 1]
        rng = np.random.default_rng(20 + quantized)
        tables = (rng.permutation(len(lengths) * nb) + 1).reshape(len(lengths), nb)
        shape = (len(lengths) * nb + 1, h, bs, d)
        q = _rand(rng, (len(lengths), h, d))
        k, v = _rand(rng, shape), _rand(rng, shape)
        scales = {}
        if quantized:
            k, ks = (np.asarray(x) for x in jax_precision.quantize_int8_rows(jnp.asarray(k)))
            v, vs = (np.asarray(x) for x in jax_precision.quantize_int8_rows(jnp.asarray(v)))
            scales = {"k_scale": ks, "v_scale": vs}
        assert paged_decode.paged_plan(bs, nb) == (16, 2)
        j = dict(q=jnp.asarray(q), k_blocks=jnp.asarray(k), v_blocks=jnp.asarray(v),
                 lengths=jnp.asarray(lengths, jnp.int32),
                 block_tables=jnp.asarray(tables, jnp.int32),
                 **{n: jnp.asarray(x) for n, x in scales.items()})
        kernel = np.asarray(jax_paged.paged_decode_attention(**j))
        ref = np.asarray(jax_paged.paged_decode_reference(**j))
        kv_dtype = torch.int8 if quantized else torch.float32
        ours = paged_decode.paged_split_reference(
            _t(q), _t(k, kv_dtype), _t(v, kv_dtype), _t(lengths, torch.int32),
            _t(tables, torch.int32), **{n: _t(x) for n, x in scales.items()}).numpy()
        live = np.asarray(lengths) > 0
        np.testing.assert_allclose(ours[live], kernel[live], atol=2e-6, rtol=2e-6)
        np.testing.assert_allclose(ours[live], ref[live], atol=2e-6, rtol=2e-6)
        assert not ours[~live].any()


def test_int8_row_quantization_matches_jax():
    rng = np.random.default_rng(0)
    x = _rand(rng, (4, 3, 16)) * 3
    x[0, 0] = 0.0  # an all-zero row gets scale 1
    jq, js = jax_precision.quantize_int8_rows(jnp.asarray(x))
    tq, ts = precision.quantize_int8_rows(_t(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        precision.dequantize_int8_rows(tq, ts).numpy(),
        np.asarray(jax_precision.dequantize_int8_rows(jq, js)),
    )


class TestWrappers:
    def test_cpu_tensors_take_the_plain_version_and_count_nothing(self):
        rng = np.random.default_rng(1)
        q, k, v = (_t(_rand(rng, (1, 2, 16, 64))) for _ in range(3))
        before = decode.flash_decode_attention.launches
        out = decode.flash_decode_attention(q, k, v, 16)
        np.testing.assert_array_equal(
            out.numpy(), decode.decode_attention_reference(q, k, v, 16).numpy()
        )
        assert decode.flash_decode_attention.launches == before

    def test_non_cpu_tensor_never_falls_back(self):
        """A tensor that is not on the CPU goes to the kernel path, which
        refuses what it cannot launch instead of running the plain
        version (meta stands in for a device here)."""
        q = torch.empty(1, 2, 16, 64, device="meta")
        with pytest.raises(ValueError, match="CUDA tensor"):
            decode.flash_decode_attention(q, q, q, 16)
        with pytest.raises(ValueError, match="head_dim"):
            p = torch.empty(2, 2, 48, device="meta")  # not a head_dim the kernels take
            paged_decode.paged_decode_attention(
                p, torch.empty(3, 2, 8, 48, device="meta"),
                torch.empty(3, 2, 8, 48, device="meta"),
                torch.empty(2, dtype=torch.int32, device="meta"),
                torch.empty(2, 1, dtype=torch.int32, device="meta"),
            )

    @pytest.mark.parametrize("head_dim", [*attention.SUPPORTED_HEAD_DIMS, 48, 256])
    @pytest.mark.parametrize("kernel", ["flash_fwd", "flash_bwd_dkv", "flash_bwd_dq",
                                        "flash_decode", "paged_decode"])
    def test_every_wrapper_takes_exactly_the_supported_head_dims(self, kernel, head_dim):
        """On a tensor that is not on the CPU (meta stands in for the
        card), a supported head_dim passes the head_dim check and stops
        only at "CUDA tensor"; 48 and 256 are refused naming the set."""
        d = head_dim

        def meta(*shape, dtype=torch.float32):
            return torch.empty(*shape, dtype=dtype, device="meta")

        q, rows = meta(4, 16, d), meta(4, 16)
        calls = {
            "flash_fwd": lambda: attention.flash_fwd(q, q, q, heads=2),
            "flash_bwd_dkv": lambda: attention.flash_bwd_dkv(q, q, q, q, rows, rows, rows,
                                                             heads=2),
            "flash_bwd_dq": lambda: attention.flash_bwd_dq(q, q, q, q, rows, rows, rows,
                                                           heads=2),
            "flash_decode": lambda: decode.flash_decode_attention(
                meta(1, 2, 4, d), meta(1, 2, 16, d), meta(1, 2, 16, d), 8),
            "paged_decode": lambda: paged_decode.paged_decode_attention(
                meta(2, 2, d), meta(3, 2, 8, d), meta(3, 2, 8, d),
                meta(2, dtype=torch.int32), meta(2, 1, dtype=torch.int32)),
        }
        supported = d in attention.SUPPORTED_HEAD_DIMS
        match = "CUDA tensor" if supported else r"head_dim %d unsupported .*\(8, 16, 32, 64, 128\)" % d
        with pytest.raises(ValueError, match=match):
            calls[kernel]()

    def test_an_edited_header_changes_the_library_path(self, monkeypatch, tmp_path):
        """A library is named by its source and every csrc header the
        source includes: editing common.cuh renames (so rebuilds) the
        libraries that include it and no other."""
        import shutil

        csrc = tmp_path / "csrc"
        shutil.copytree(_build.CSRC, csrc)
        monkeypatch.setattr(_build, "CSRC", csrc)
        before = {n: _build.library_path(n) for n in _build.SOURCES}
        assert _build._local_headers((csrc / "decode.cu").read_bytes()) == ["common.cuh"]
        with open(csrc / "common.cuh", "a") as f:
            f.write("// edited\n")
        after = {n: _build.library_path(n) for n in _build.SOURCES}
        includes = {n for n in _build.SOURCES if "common.cuh" in (csrc / f"{n}.cu").read_text()}
        assert includes == {"decode", "paged_decode", "flash_attention", "grouped_matmul"}
        assert {n for n in _build.SOURCES if after[n] != before[n]} == includes

    def test_kernel_modules_import_and_build_nothing_without_nvcc(self, monkeypatch):
        """Importing the kernel modules builds nothing; a build with no
        nvcc around fails loudly with a reason."""
        assert _build.library_path("decode").name.startswith("libdecode-")
        assert not _build._libs
        monkeypatch.setattr(_build.shutil, "which", lambda _: None)
        monkeypatch.setattr(_build.os.path, "exists", lambda _: False)
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.nvcc()
