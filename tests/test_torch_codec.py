"""Port parity: the activation codecs of ``repro_torch`` against the jitted
ops of the JAX package — what ships on the wire — bit for bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.activation_codec import ops as j_ops, ref as j_ref
from repro.runtime.partition import encode_activation as j_encode
from repro_torch.kernels.activation_codec import ops as t_ops, ref as t_ref
from repro_torch.runtime.partition import (decode_activation,
                                           encode_activation, payload_bytes)

from _torch_port_util import t2np, to_np

SHAPES = [(4, 128), (256, 384), (2, 17, 256), (273, 4096)]
DTYPES = [("float32", jnp.float32, torch.float32),
          ("bfloat16", jnp.bfloat16, torch.bfloat16)]


def _inputs(shape, jdt, tdt, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 3.0).astype(np.float32)
    x.reshape(-1, shape[-1])[0, :128] = 0.0          # an all-zero block
    xj = jnp.asarray(x).astype(jdt)
    xt = torch.from_numpy(np.array(to_np(xj))).to(tdt)
    return xj, xt


def _rows_for_pallas(xj, impl):
    """The Pallas kernels tile rows by 256 and assert on a ragged tail
    (273 rows); rows are independent, so run them on zero-padded rows and
    compare the first ``n``."""
    n = xj.shape[0]
    if impl == "interpret" and n > 256 and n % 256:
        pad = 256 - n % 256
        xj = jnp.concatenate([xj, jnp.zeros((pad,) + xj.shape[1:], xj.dtype)])
    return xj, n


@pytest.mark.parametrize("impl", ["jnp", "interpret"])
@pytest.mark.parametrize("name,jdt,tdt", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_int8_bit_equal_to_jitted_ops(shape, name, jdt, tdt, impl):
    xj, xt = _inputs(shape, jdt, tdt)
    xj, n = _rows_for_pallas(xj, impl)
    qj, sj = j_ops.quantize(xj, impl=impl)
    qt, st = t_ops.quantize(xt)
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    assert np.array_equal(np.asarray(qj)[:n], qt.numpy())
    assert np.array_equal(np.asarray(sj)[:n], st.numpy())
    dj = j_ops.dequantize(qj, sj, jdt, impl=impl)
    dt_ = t_ops.dequantize(qt, st, tdt)
    assert dt_.dtype == tdt
    assert np.array_equal(to_np(dj)[:n], t2np(dt_))


@pytest.mark.parametrize("impl", ["jnp", "interpret"])
@pytest.mark.parametrize("name,jdt,tdt", DTYPES)
@pytest.mark.parametrize("shape", [(4, 256), (256, 512), (2, 17, 256),
                                   (273, 4096)])
def test_int4_bit_equal_to_jitted_ops(shape, name, jdt, tdt, impl):
    xj, xt = _inputs(shape, jdt, tdt, seed=1)
    xj, n = _rows_for_pallas(xj, impl)
    pj, sj = j_ops.quantize_int4(xj, impl=impl)
    pt, st = t_ops.quantize_int4(xt)
    assert pt.shape[-1] == shape[-1] // 2
    assert np.array_equal(np.asarray(pj)[:n], pt.numpy())
    assert np.array_equal(np.asarray(sj)[:n], st.numpy())
    dj = j_ops.dequantize_int4(pj, sj, jdt, impl=impl)
    dt_ = t_ops.dequantize_int4(pt, st, tdt)
    assert np.array_equal(to_np(dj)[:n], t2np(dt_))


@pytest.mark.parametrize("name,jdt,tdt", DTYPES)
def test_block_equals_width_path(name, jdt, tdt):
    """Widths below 128 (the reduced ``d_model = 64``) take one block a row
    through ``encode_activation`` on both sides."""
    xj, xt = _inputs((2, 9, 64), jdt, tdt, seed=2)
    xj = xj.at[0, 0].set(1.5)                         # undo the zero block
    xt[0, 0] = 1.5
    pj = j_encode(xj, "int8")
    pt = encode_activation(xt, "int8")
    assert pt["s"].shape == (2, 9, 1)
    assert np.array_equal(np.asarray(pj["q"]), pt["q"].numpy())
    assert np.array_equal(np.asarray(pj["s"]), pt["s"].numpy())
    back = decode_activation(pt, tdt)
    assert back.dtype == tdt and back.shape == xt.shape


@pytest.mark.parametrize("shape", [(1, 273, 4096), (1, 7, 4096), (2, 13, 256)])
def test_wire_bytes_equal(shape):
    assert t_ref.wire_bytes(shape) == j_ref.wire_bytes(shape)
    assert t_ref.wire_bytes_int4(shape) == j_ref.wire_bytes_int4(shape)
    x = torch.zeros(shape, dtype=torch.bfloat16)
    assert payload_bytes(encode_activation(x, "int8")) == t_ref.wire_bytes(shape)
    assert payload_bytes(encode_activation(x, "int4")) == \
        t_ref.wire_bytes_int4(shape)
    assert t_ref.BLOCK == j_ref.BLOCK == 128


def test_int4_needs_width_multiple_of_256():
    x = torch.zeros((1, 5, 384), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="int4 codec needs"):
        encode_activation(x, "int4")
    with pytest.raises(ValueError, match="no data-plane codec"):
        encode_activation(x, "fp16")
    assert encode_activation(x, "")["x"] is x
