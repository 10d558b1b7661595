"""Port parity: KV quantization of ``repro_torch.quant.core`` is bitwise
the reference's — the e4m3 widening over all 256 bytes, and the int8 /
fp8 payloads and scales of ``quantize_lastdim``."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.quant import core as rq  # noqa: E402
from repro_torch.quant import core as tq  # noqa: E402


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def test_e4m3_widen_all_bytes_bitwise():
    raw = np.arange(256, dtype=np.uint8)
    want = np.asarray(rq.e4m3_to_f32(jnp.asarray(raw)))
    got = tq.e4m3_to_f32(torch.from_numpy(raw)).numpy()
    np.testing.assert_array_equal(_bits(want), _bits(got))
    # the two NaN encodings widen to +-480, as in the reference
    assert got[0x7F] == 480.0 and got[0xFF] == -480.0


def test_e4m3_widen_matches_native_cast():
    raw = torch.arange(256, dtype=torch.int32).to(torch.uint8)
    native = raw.view(torch.float8_e4m3fn).to(torch.float32)
    got = tq.e4m3_to_f32(raw)
    finite = torch.isfinite(native)
    assert int(finite.sum()) == 254
    assert torch.equal(got[finite], native[finite])
    assert torch.equal(tq.cast_f32(raw.view(torch.float8_e4m3fn)), got)


def _data(seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((4, 7, 3, 16))
         * 2.0 ** rng.integers(-6, 6, (4, 7, 3, 1))).astype(np.float32)
    x[0, 0, 0] = 0.0                       # an all-zero vector: eps scale
    return x


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("fmt_name", ["int8", "fp8"])
def test_quantize_lastdim_bitwise(fmt_name, seed):
    x = _data(seed)
    q_ref, s_ref = rq.quantize_lastdim(jnp.asarray(x),
                                       rq.get_format(fmt_name))
    q, s = tq.quantize_lastdim(torch.from_numpy(x), tq.get_format(fmt_name))
    assert q.dtype == tq.get_format(fmt_name).storage
    np.testing.assert_array_equal(np.asarray(q_ref).view(np.uint8),
                                  q.numpy().view(np.uint8))
    np.testing.assert_array_equal(_bits(s_ref), _bits(s.numpy()))
    deq_ref = rq.dequantize_lastdim(q_ref, s_ref)
    deq = tq.dequantize_lastdim(q, s)
    np.testing.assert_array_equal(_bits(deq_ref), _bits(deq.numpy()))


def test_quantize_bf16_input_and_formats():
    x = torch.from_numpy(_data(5)).to(torch.bfloat16)
    q, s = tq.quantize_lastdim(x, tq.INT8)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert int(q.abs().max()) == 127
    assert tq.get_format("bf16") is None
    assert tq.FP8.storage == torch.uint8 and tq.FP8.itemsize == 1
    with pytest.raises(ValueError):
        tq.get_format("int4")
