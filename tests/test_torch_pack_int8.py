"""Kernels 9-10, the block-scaled int8 pack and unpack of the port
(``kernels/pack_int8.py``, ``ops.pack_int8`` / ``ops.unpack_int8``),
against the JAX package; mirrors ``test_kernels_pack_int8.py``.

Tolerances: q is bitwise equal everywhere. The scale is bitwise equal to
the reference's eager oracle (``ref.pack_int8_block``), which divides
amax by 127 as the port does; under ``jit`` and in the Pallas
interpreter XLA rewrites that divide by a constant as a multiply by
1/127, which can round the last bit the other way, so against those the
scale is compared with the reference test's rtol=1e-6. The unpack of one
(q, scale) pair is bitwise equal (one fp32 multiply).

CPU lane: the plain versions (the wrapper's lane for a CPU tensor).
CUDA lane (marker ``cuda``): the hand-written kernel against the plain
version on the card, bitwise. The JAX package is imported only inside the
CPU-lane tests.
"""
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro_torch.kernels import ops
from repro_torch.kernels import pack_int8 as tpack
from repro_torch.kernels import ref as tref


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("rows", [256, 512])
def test_matches_ref(rows):
    import jax.numpy as jnp

    from repro.kernels import ref as jref
    from repro.kernels.pack_int8 import pack_int8_pallas, unpack_int8_pallas
    rng = np.random.RandomState(4)
    x = rng.randn(rows, 128).astype(np.float32)
    x *= rng.uniform(1e-6, 1e6, (rows, 1)).astype(np.float32)
    x[7] = 0.0                                     # a zero row: scale 1
    x[9, :3] = [0.5, -0.5, 1.5]                    # halfway cases
    q, s = tpack.pack_int8(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    qp, sp = pack_int8_pallas(jnp.asarray(x), interpret=True)
    qr, sr = jref.pack_int8_block(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(qp))
    np.testing.assert_array_equal(q.numpy(), np.asarray(qr))
    np.testing.assert_array_equal(_bits(s.numpy()), _bits(sr))
    np.testing.assert_allclose(s.numpy(), np.asarray(sp), rtol=1e-6)
    assert s[7] == 1.0
    y = tpack.unpack_int8(q, s)
    np.testing.assert_array_equal(
        _bits(y.numpy()), _bits(jref.unpack_int8_block(qr, sr)))
    yp = unpack_int8_pallas(qp, sp, interpret=True)
    np.testing.assert_array_equal(
        _bits(tpack.unpack_int8(torch.from_numpy(np.array(qp)),
                                torch.from_numpy(np.array(sp))).numpy()),
        _bits(yp))


@settings(max_examples=100, deadline=None)
@given(st.integers(0, 2**32 - 1))
def test_roundtrip_error_bound(seed):
    rng = np.random.RandomState(seed % (2**31))
    x = rng.randn(4, 128).astype(np.float32) * rng.uniform(1e-6, 1e6)
    q, s = tpack.pack_int8(torch.from_numpy(x))
    y = tpack.unpack_int8(q, s).numpy()
    amax = np.abs(x).max(axis=1, keepdims=True)
    # error per element <= scale/2 = amax/254 (tiny slack: fp32 rounding at
    # quantization midpoints can exceed the exact bound by ~1 ulp)
    assert np.all(np.abs(y - x) <= amax / 254.0 * (1 + 1e-5) + 1e-12)
    assert int(q.abs().max()) <= 127


def test_zero_rows_exact():
    q, s = tpack.pack_int8(torch.zeros((4, 128)))
    assert torch.equal(s, torch.ones(4))
    assert torch.equal(tpack.unpack_int8(q, s), torch.zeros((4, 128)))


@pytest.mark.parametrize("n", [1, 32_768, 40_000])
def test_entry_point_matches_reference(n):
    """ops.pack_int8 / unpack_int8 against the reference's entry point:
    zero padding to whole 256 x 128 tiles (the same shapes), q bitwise,
    and the truncated round trip; the port's unpack of the reference's
    (q, scale) is bitwise the reference's."""
    import jax.numpy as jnp

    from repro.kernels import ops as jops
    rng = np.random.RandomState(n)
    x = (rng.randn(n) * 0.05).astype(np.float32)
    x[:: max(n // 7, 1)] = 3.0
    jq, js = jops.pack_int8(jnp.asarray(x))
    ops.reset_counts()
    q, s = ops.pack_int8(torch.from_numpy(x))
    assert tuple(q.shape) == jq.shape and tuple(s.shape) == js.shape
    assert q.shape[0] % 256 == 0
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6)
    y = ops.unpack_int8(q, s, n)
    assert tuple(y.shape) == (n,) and y.dtype == torch.float32
    amax = np.abs(np.pad(x, (0, (-n) % 128))).reshape(-1, 128).max(1)
    err_bound = np.repeat(amax / 254.0 * (1 + 1e-5), 128)[:n]
    assert np.all(np.abs(y.numpy() - x) <= err_bound)
    jy = jops.unpack_int8(jq, js, n)
    ty = ops.unpack_int8(torch.from_numpy(np.array(jq)),
                         torch.from_numpy(np.array(js)), n)
    np.testing.assert_array_equal(_bits(ty.numpy()), _bits(jy))
    assert ops.plain_counts()["pack_int8"] == 1
    assert ops.plain_counts()["unpack_int8"] == 2
    assert ops.launch_counts()["pack_int8"] == 0


def test_wrappers_check_their_operands():
    with pytest.raises(TypeError):
        tpack.pack_int8(torch.zeros((4, 64)))             # not 128 lanes
    with pytest.raises(TypeError):
        tpack.pack_int8(torch.zeros((4, 128), dtype=torch.float64))
    with pytest.raises(TypeError):
        tpack.unpack_int8(torch.zeros((4, 128), dtype=torch.int8),
                          torch.ones(3))
    with pytest.raises(ValueError, match="whole tiles"):
        ops.unpack_int8(torch.zeros((100, 128), dtype=torch.int8),
                        torch.ones(100), 10)


def test_plain_oracle_divides_by_a_tensor():
    """The scale is amax / 127 rounded once (an IEEE divide), never amax
    times a rounded 1/127: the two disagree on some rows."""
    rng = np.random.RandomState(0)
    x = rng.randn(4096, 128).astype(np.float32)
    _, s = tref.pack_int8_block(torch.from_numpy(x))
    amax = np.abs(x).max(1)
    np.testing.assert_array_equal(_bits(s.numpy()),
                                  _bits(amax / np.float32(127.0)))
    recip = amax * (np.float32(1.0) / np.float32(127.0))
    assert (_bits(recip) != _bits(amax / np.float32(127.0))).any()


# -- CUDA lane ----------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 40_000, 6_553_600])
def test_cuda_pack_unpack_match_plain(cuda, n):
    rng = np.random.RandomState(n % 1000)
    x = torch.from_numpy((rng.randn(n) * 0.05).astype(np.float32))
    x[:: max(n // 5, 1)] = 30.0
    q, s = ops.pack_int8(x.to(cuda))
    tiles = torch.nn.functional.pad(x, (0, (-n) % (256 * 128)))
    qp, sp = tpack.pack_int8_plain(tiles.reshape(-1, 128).to(cuda))
    torch.cuda.synchronize()
    assert torch.equal(q, qp)
    assert torch.equal(s.view(torch.int32), sp.view(torch.int32))
    y = ops.unpack_int8(q, s, n)
    yp = tpack.unpack_int8_plain(qp, sp).reshape(-1)[:n]
    torch.cuda.synchronize()
    assert torch.equal(y.view(torch.int32), yp.view(torch.int32))
    assert torch.equal(y.cpu().view(torch.int32),
                       ops.unpack_int8(*ops.pack_int8(x), n)
                       .view(torch.int32))
