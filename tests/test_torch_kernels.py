"""The port's kernels against the JAX package: the four register-file
kernels (``fused_addto`` also over several runs in one launch), the fused
fold of ``local_accum``, the SyncAgtr stream kernels
(``sat_add``, ``sat_add_batch``, ``quantize``, ``dequantize``) and flash
attention.

CPU lane: seeded numpy inputs go through the Pallas kernel (interpret
mode) and through the port's wrapper on CPU tensors, which runs the plain
PyTorch version. Ints and masks must be equal, fp32 reads bitwise equal;
attention, an fp32 softmax summed in another order, within 2e-5.

CUDA lane (marker ``cuda``, skipped without a card): the hand-written
kernel against its plain version on the same tensors on the card. The
card's machine has no JAX, so the JAX package is imported only inside
the CPU-lane tests; ``pytest -m cuda`` there never imports it.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import dequantize as tdequantize
from repro_torch.kernels import flash_attn as tflash
from repro_torch.kernels import fused_gpv, inc_agg, ops, ref
from repro_torch.kernels import quantize as tquantize
from repro_torch.kernels import sparse_addto as tsparse
from repro_torch.kernels.constants import (INT32_MAX, INT32_MIN, SAT_MAX,
                                           SAT_MIN)

N_SLOTS = 256
K = 512
EDGES = np.array([2147483520, 2.0 ** 31, -2.0 ** 31, 2147483904,
                  -2147483904], np.float32)
HALVES = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 1e-9, -1e-9],
                  np.float32)
REG_EDGES = np.array([INT32_MAX, INT32_MIN, SAT_MAX, SAT_MIN, -2 ** 31, 0],
                     np.int64)


def _regs(rng, n=N_SLOTS, sentinels=True):
    regs = rng.randint(-10 ** 6, 10 ** 6, n).astype(np.int64)
    if sentinels:
        pos = rng.choice(n, len(REG_EDGES), replace=False)
        regs[pos] = REG_EDGES
    return regs.astype(np.int32)


def _fvals(rng, n, scale):
    """fp32 stream mixing ordinary values, halfway cases and values that
    quantize onto and past the sentinel edges at ``scale``."""
    f = (rng.randn(n) * 50).astype(np.float32)
    pos = rng.choice(n, min(n, 16), replace=False)
    extra = np.concatenate([HALVES / np.float32(scale),
                            EDGES / np.float32(scale)])
    f[pos[:len(extra)]] = extra[:len(pos)]
    return f


def _jax():
    """(jnp, the four Pallas kernels) of the JAX package."""
    import jax.numpy as jnp
    from repro.kernels.fused_gpv import (fused_addto_pallas,
                                         fused_read_pallas,
                                         fused_scatter_pallas)
    from repro.kernels.sparse_addto import sparse_addto_pallas
    return (jnp, fused_addto_pallas, fused_scatter_pallas, fused_read_pallas,
            sparse_addto_pallas)


def _t(x):
    return torch.from_numpy(np.array(x))


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("scale", [1, 10 ** 4])
def test_fused_addto_matches_pallas(seed, scale):
    jnp, fused_addto_pallas, *_ = _jax()
    rng = np.random.RandomState(seed)
    regs = _regs(rng)
    start, n = 17, 160
    f = _fvals(rng, n, scale)
    want = np.asarray(fused_addto_pallas(jnp.asarray(regs), start,
                                         jnp.asarray(f), scale,
                                         interpret=True))
    got = fused_gpv.fused_addto(_t(regs), start, _t(f), scale)
    np.testing.assert_array_equal(got.numpy(), want)


def test_quantize_sentinel_edges_scale_one():
    """The fp32 threshold trap: 2**31 saturates to the +sentinel, -2**31
    stores -2147483648 (no sentinel), beyond either edge the sentinels."""
    jnp, fused_addto_pallas, *_ = _jax()
    got = ref.quantize(_t(EDGES), 1).tolist()
    assert got == [2147483520, 2147483647, -2147483648, 2147483647,
                   -2147483647]
    want = np.asarray(fused_addto_pallas(
        jnp.zeros(len(EDGES), jnp.int32), 0, jnp.asarray(EDGES), 1,
        interpret=True)).tolist()
    assert got == want
    assert ref.quantize(_t(np.array([np.nan, np.inf, -np.inf], np.float32)),
                        1).tolist() == [0, INT32_MAX, INT32_MIN]


@pytest.mark.parametrize("seed", range(3))
def test_fused_scatter_matches_pallas(seed):
    jnp, _, fused_scatter_pallas, *_ = _jax()
    rng = np.random.RandomState(seed)
    regs = _regs(rng)
    scale = 100
    idx = rng.randint(0, 24, K).astype(np.int32)     # heavy duplicates
    f = _fvals(rng, K, scale)
    f[rng.choice(K, 40, replace=False)] = np.float32(1.5e7)   # saturates
    idx[-32:], f[-32:] = 0, 0.0                      # (idx 0, 0.0) padding
    want = np.asarray(fused_scatter_pallas(
        jnp.asarray(regs), jnp.asarray(idx), jnp.asarray(f), scale,
        interpret=True))
    got = fused_gpv.fused_scatter(_t(regs), _t(idx), _t(f), scale)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("scale", [1, 10 ** 8])
def test_fused_read_matches_pallas(seed, scale):
    jnp, _, _, fused_read_pallas, _ = _jax()
    rng = np.random.RandomState(seed)
    regs = _regs(rng)
    start, n = 40, 200
    wv, wm = fused_read_pallas(jnp.asarray(regs), start, n, scale,
                               interpret=True)
    gv, gm = fused_gpv.fused_read(_t(regs), start, n, scale)
    assert gv.dtype == torch.float32 and gm.dtype == torch.bool
    np.testing.assert_array_equal(_bits(gv.numpy()), _bits(wv))
    np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))


@pytest.mark.parametrize("seed", range(3))
def test_sparse_addto_matches_pallas(seed):
    jnp, *_, sparse_addto_pallas = _jax()
    rng = np.random.RandomState(seed)
    regs = _regs(rng, 16)
    idx = rng.randint(0, 16, K).astype(np.int32)
    val = rng.choice([-3, -1, 0, 1, 3, SAT_MAX // 2, SAT_MIN // 2,
                      INT32_MAX, INT32_MIN, 10 ** 6], K).astype(np.int32)
    idx[-16:], val[-16:] = 0, 0                      # (idx 0, 0) padding
    want = np.asarray(sparse_addto_pallas(
        jnp.asarray(regs), jnp.asarray(idx), jnp.asarray(val),
        interpret=True))
    got = tsparse.sparse_addto(_t(regs), _t(idx), _t(val))
    np.testing.assert_array_equal(got.numpy(), want)
    host = ops.sparse_addto_host(regs.copy(), idx, val)
    np.testing.assert_array_equal(host, want)


def test_sparse_addto_int32_min_sum_edge():
    """A sum landing exactly on -2**31 stays raw and unflagged, in the
    reference kernel and the port alike."""
    jnp, *_, sparse_addto_pallas = _jax()
    regs, idx, val = (np.array([SAT_MIN], np.int32),
                      np.array([0], np.int32), np.array([-2], np.int32))
    want = np.asarray(sparse_addto_pallas(
        jnp.asarray(regs), jnp.asarray(idx), jnp.asarray(val),
        interpret=True))
    got = tsparse.sparse_addto(_t(regs), _t(idx), _t(val))
    assert int(got[0]) == int(want[0]) == -2 ** 31


def test_wrappers_reject_bad_arguments_and_count_plain_calls():
    ops.reset_counts()
    regs = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(TypeError):
        fused_gpv.fused_addto(regs, 0, torch.zeros(2, dtype=torch.float64),
                              1)
    with pytest.raises(ValueError):
        fused_gpv.fused_addto(regs, 7, torch.zeros(2), 1)
    with pytest.raises(TypeError):
        tsparse.sparse_addto(regs, torch.zeros(2, dtype=torch.int64),
                             torch.zeros(2, dtype=torch.int32))
    with pytest.raises(IndexError):
        ops.sparse_addto(regs, np.array([8], np.int32),
                         np.array([1], np.int32))
    fused_gpv.fused_read(regs, 0, 4, 10)
    assert ops.plain_counts()["fused_read"] == 1
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}


# -- kernels 5-8: the fused fold and the SyncAgtr stream kernels -------------

TILE = 1024                     # (8, 128): Pallas tiles with block_rows=8


def _fold_stack(rng, rounds, n, scale):
    """(rounds, n) fp32: ordinary values and halfway cases, a lane that
    saturates mid-fold, a sentinel followed by values of the other sign
    (sticky), and -2**31 (stored raw) followed by a negative round."""
    f = np.stack([_fvals(rng, n, scale) for _ in range(rounds)])
    s = np.float32(scale)
    f[:, 0] = np.float32(1.5e9) / s                 # saturates at round 2
    f[:, 1] = np.float32(-1.5e9) / s
    f[:, 2] = -np.float32(5.0) / s
    f[min(2, rounds - 1), 2] = np.float32(2.0 ** 31) / s  # sentinel, sticky
    f[:, 3] = -np.float32(1.0) / s
    f[0, 3] = np.float32(-2.0 ** 31) / s            # -2**31, not a sentinel
    return f


@pytest.mark.parametrize("rounds,n,scale", [(1, 64, 1), (2, 512, 10 ** 4),
                                            (8, 4096, 10 ** 8),
                                            (5, 1000, 100)])
def test_fused_fold_matches_pallas(rounds, n, scale):
    import jax.numpy as jnp
    from repro.kernels.fused_gpv import fused_fold_pallas
    f = _fold_stack(np.random.RandomState(rounds), rounds, n, scale)
    want = np.asarray(fused_fold_pallas(jnp.asarray(f), scale,
                                        interpret=True))
    got = fused_gpv.fused_fold(_t(f), scale)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if rounds >= 2:
        assert got[0] == INT32_MAX and got[1] == INT32_MIN


# (first slot, length) of each run of a fused_addto_runs call, one segment
# of N_SLOTS slots a run: phase b's layout (whole segments, the last one
# cut), unaligned starts and lengths, and more runs than one launch holds
RUN_CASES = {
    "seven_segments": [(0, N_SLOTS)] * 6 + [(0, 77)],
    "unaligned_starts": [(17, 160), (3, 253), (255, 1), (1, 1), (100, 99)],
    "past_run_table": [(r % 7, 37) for r in range(fused_gpv.MAX_RUNS + 9)],
}


def _runs(rng, layout, n_slots, scale):
    """(numpy registers a run, (run index, start, foff, n) a run, the fp32
    stream the runs read in order)."""
    regs = [_regs(rng, n_slots) for _ in layout]
    foffs = np.cumsum([0] + [n for _, n in layout[:-1]])
    f = _fvals(rng, sum(n for _, n in layout), scale)
    return regs, [(i, a, int(o), n)
                  for i, ((a, n), o) in enumerate(zip(layout, foffs))], f


@pytest.mark.parametrize("case", list(RUN_CASES))
def test_fused_addto_runs_matches_pallas_run_by_run(case):
    jnp, fused_addto_pallas, *_ = _jax()
    rng = np.random.RandomState(len(case))
    scale = 10 ** 4
    regs, runs, f = _runs(rng, RUN_CASES[case], N_SLOTS, scale)
    tregs = [_t(r) for r in regs]
    ops.reset_counts()
    fused_gpv.fused_addto_runs([(tregs[i], a, o, n) for i, a, o, n in runs],
                               _t(f), scale)
    assert ops.plain_counts()["fused_addto"] == \
        -(-len(runs) // fused_gpv.MAX_RUNS)       # one a launch table
    for i, a, o, n in runs:
        want = np.asarray(fused_addto_pallas(
            jnp.asarray(regs[i]), a, jnp.asarray(f[o:o + n]), scale,
            interpret=True))
        np.testing.assert_array_equal(tregs[i].numpy(), want)


def test_fused_addto_runs_rejects_bad_arguments():
    a = torch.zeros(8, dtype=torch.int32)
    b = torch.zeros(8, dtype=torch.int32)
    f = torch.ones(6)
    with pytest.raises(ValueError, match="overlap"):
        fused_gpv.fused_addto_runs([(a, 0, 0, 3), (a, 2, 3, 3)], f, 1)
    with pytest.raises(ValueError):             # values past the stream
        fused_gpv.fused_addto_runs([(a, 0, 4, 3)], f, 1)
    with pytest.raises(ValueError):             # slots past the segment
        fused_gpv.fused_addto_runs([(b, 6, 0, 3)], f, 1)
    with pytest.raises(TypeError):
        fused_gpv.fused_addto_runs([(a, 0, 0, 3)], f.double(), 1)
    # runs on one tensor that do not overlap, and an empty run
    ops.reset_counts()
    fused_gpv.fused_addto_runs([(a, 0, 0, 3), (a, 3, 3, 3), (b, 0, 0, 0)],
                               f, 1)
    assert a.tolist() == [1] * 6 + [0, 0] and b.tolist() == [0] * 8
    ops.device_addto_dense_runs([(b, 0, 0, 0)], np.ones(2, np.float32), 1)
    assert ops.plain_counts()["fused_addto"] == 1


def _int_stream(rng, n):
    """int32 stream: ordinary values, both sentinels, the SAT edges,
    -2**31 and half-range values that overflow when added."""
    q = rng.randint(-10 ** 6, 10 ** 6, n).astype(np.int64)
    edges = [INT32_MAX, INT32_MIN, SAT_MAX, SAT_MIN, -2 ** 31, 0,
             SAT_MAX // 2 + 1, -(SAT_MAX // 2 + 1)]
    q[rng.choice(n, 64, replace=False)] = rng.choice(edges, 64)
    return q.astype(np.int32)


def _pallas_sat_add(a, b):
    import jax.numpy as jnp
    from repro.kernels.inc_agg import sat_add_pallas
    return np.asarray(sat_add_pallas(
        jnp.asarray(a.reshape(-1, 128)), jnp.asarray(b.reshape(-1, 128)),
        block_rows=8, interpret=True)).reshape(-1)


@pytest.mark.parametrize("seed", range(2))
def test_sat_add_matches_pallas(seed):
    rng = np.random.RandomState(seed)
    a, b = _int_stream(rng, TILE), _int_stream(rng, TILE)
    a[:4], b[:4] = [INT32_MAX, 5, INT32_MIN, -2 ** 31], \
        [INT32_MIN, INT32_MAX, 3, -1]     # a's sentinel wins; -2**31 - 1
    want = _pallas_sat_add(a, b)
    got = inc_agg.sat_add(_t(a), _t(b))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[:4].tolist() == [INT32_MAX, INT32_MAX, INT32_MIN, INT32_MIN]
    # any shape: the same values as a (8, 128) tensor
    got2 = ops.sat_add(_t(a).reshape(8, 128), _t(b).reshape(8, 128))
    np.testing.assert_array_equal(got2.numpy().reshape(-1), want)


@pytest.mark.parametrize("rows", [2, 6])
def test_sat_add_batch_matches_sequential_pallas_fold(rows):
    """The batched fold against the sequential fold of the Pallas
    sat_add, row by row (not against the JAX ops.sat_add_batch)."""
    rng = np.random.RandomState(rows)
    acc = _int_stream(rng, TILE)
    qs = np.stack([_int_stream(rng, TILE) for _ in range(rows)])
    qs[:, :8] = SAT_MAX // 3                  # saturates at the third row
    want = acc
    for q in qs:
        want = _pallas_sat_add(want, q)
    got = inc_agg.sat_add_batch(_t(acc), _t(qs))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(ops.sat_add_batch(_t(acc), _t(qs)).numpy(),
                                  want)


def _batch_case(rng, rows, n):
    """acc and B rows at the clear policies' n: saturating lanes (the
    third row saturates) and both sentinels mid-fold."""
    acc = _int_stream(rng, n)
    qs = np.stack([_int_stream(rng, n) for _ in range(rows)])
    qs[:, :8] = SAT_MAX // 3
    qs[rows // 2, 8:12] = [INT32_MAX, INT32_MIN, INT32_MAX, INT32_MIN]
    return acc, qs


@pytest.mark.parametrize("n", [40_000, 40_001])
@pytest.mark.parametrize("rows", [2, 3, 16, 17])
def test_sat_add_batch_matches_jax_sequential_fold(rows, n):
    """The batched fold against the JAX package's sequential fold of its
    ``ref.sat_add``, at the shapes of the card's row batches (16 rows in
    flight: B = 16 one batch, B = 17 one more row)."""
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    acc, qs = _batch_case(np.random.RandomState(rows + n), rows, n)
    want = jnp.asarray(acc)
    for q in qs:
        want = jref.sat_add(want, jnp.asarray(q))
    got = inc_agg.sat_add_batch(_t(acc), _t(qs))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got[8:12] == torch.tensor(qs[rows // 2, 8:12])).all()


@pytest.mark.parametrize("scale", [1, 10 ** 4, 10 ** 8])
def test_quantize_and_dequantize_match_pallas(scale):
    import jax.numpy as jnp
    from repro.kernels.dequantize import dequantize_pallas
    from repro.kernels.quantize import quantize_pallas
    rng = np.random.RandomState(scale % 97)
    x = _fvals(rng, TILE, scale) / np.float32(50)
    x[:len(EDGES)] = EDGES / np.float32(scale)
    x[len(EDGES):len(EDGES) + len(HALVES)] = HALVES / np.float32(scale)
    s = jnp.float32(scale)
    want_q = np.asarray(quantize_pallas(jnp.asarray(x.reshape(-1, 128)), s,
                                        block_rows=8, interpret=True))
    got_q = tquantize.quantize(_t(x), scale)
    np.testing.assert_array_equal(got_q.numpy(), want_q.reshape(-1))
    if scale == 1:
        assert got_q[:len(EDGES)].tolist() == [
            2147483520, INT32_MAX, -2 ** 31, INT32_MAX, INT32_MIN]
    q = _int_stream(rng, TILE)
    wv, wm = dequantize_pallas(jnp.asarray(q.reshape(-1, 128)), s,
                               block_rows=8, interpret=True)
    gv, gm = tdequantize.dequantize(_t(q), scale)
    np.testing.assert_array_equal(_bits(gv.numpy()),
                                  _bits(np.asarray(wv).reshape(-1)))
    np.testing.assert_array_equal(gm.numpy(), np.asarray(wm).reshape(-1))
    assert gm.any()


def test_stream_wrappers_reject_bad_arguments():
    with pytest.raises(TypeError):
        tquantize.quantize(torch.zeros(4, dtype=torch.float64), 1)
    with pytest.raises(TypeError):
        tdequantize.dequantize(torch.zeros(4, dtype=torch.int64), 1)
    with pytest.raises(ValueError):
        inc_agg.sat_add(torch.zeros(4, dtype=torch.int32),
                        torch.zeros(5, dtype=torch.int32))
    with pytest.raises(ValueError):
        inc_agg.sat_add_batch(torch.zeros(4, dtype=torch.int32),
                              torch.zeros(2, 5, dtype=torch.int32))
    with pytest.raises(TypeError):
        fused_gpv.fused_fold(torch.zeros(0, 4), 1)


# -- kernel 11: flash attention -----------------------------------------------

# (b, h, kv, s, d, causal, block_q, block_k, window): the cases of
# tests/test_kernels_flash.py, then sliding windows (one narrower than a
# block, so some rows of a visited block are masked whole)
FLASH_CASES = [
    (1, 4, 2, 256, 64, True, 128, 128, None),
    (2, 2, 2, 128, 128, False, 64, 128, None),
    (1, 8, 1, 512, 64, True, 256, 128, None),     # MQA
    (1, 6, 2, 256, 128, True, 64, 64, None),      # ragged head group
    (1, 2, 2, 384, 64, True, 128, 128, None),     # non-pow2 seq
    (1, 4, 2, 256, 64, True, 64, 64, 100),
    (2, 4, 1, 256, 32, True, 128, 64, 40),
]


def _qkv(rng, b, h, kv, s, d):
    """fp32 q (B,H,S,D), k/v (B,KV,S,D): the Pallas kernel's layout."""
    return (rng.randn(b, h, s, d).astype(np.float32),
            rng.randn(b, kv, s, d).astype(np.float32),
            rng.randn(b, kv, s, d).astype(np.float32))


def _port_flash(q, k, v, causal, window):
    """The port's wrapper takes (B,S,H,D): swap in, run, swap back."""
    o = ops.flash_attention(_t(q).transpose(1, 2), _t(k).transpose(1, 2),
                            _t(v).transpose(1, 2), causal=causal,
                            window=window)
    return o.transpose(1, 2).numpy()


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_plain_matches_pallas(case):
    import jax.numpy as jnp
    from repro.kernels.flash_attn import flash_attention_pallas
    b, h, kv, s, d, causal, bq, bk, window = case
    q, k, v = _qkv(np.random.RandomState(0), b, h, kv, s, d)
    want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=causal,
                                  window=window, block_q=bq, block_k=bk,
                                  interpret=True)
    ops.reset_counts()
    got = _port_flash(q, k, v, causal, window)
    assert ops.plain_counts()["flash_attention"] == 1
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("window", [None, 7, 64])
def test_flash_plain_matches_jax_oracle_in_bf16(window):
    """bf16 in, bf16 out, as the model calls it; the oracle of the JAX
    package (``ref.flash_attention``) on the same bf16 values."""
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    q, k, v = _qkv(np.random.RandomState(3), 2, 4, 2, 96, 32)
    want = jref.flash_attention(jnp.asarray(q, jnp.bfloat16),
                                jnp.asarray(k, jnp.bfloat16),
                                jnp.asarray(v, jnp.bfloat16), causal=True,
                                window=window)
    got = ref.flash_attention(_t(q).bfloat16(), _t(k).bfloat16(),
                              _t(v).bfloat16(), causal=True, window=window)
    assert got.dtype == torch.bfloat16
    # both round one fp32 result to bf16: at most one bf16 step apart
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=1e-6, rtol=2 ** -7)


def test_flash_wrapper_rejects_bad_arguments():
    q = torch.zeros(1, 8, 4, 64)
    with pytest.raises(ValueError):
        ops.flash_attention(q, torch.zeros(1, 8, 3, 64),
                            torch.zeros(1, 8, 3, 64))       # 4 % 3 heads
    with pytest.raises(ValueError):
        ops.flash_attention(q, torch.zeros(1, 9, 2, 64),
                            torch.zeros(1, 9, 2, 64))       # S differs
    with pytest.raises(ValueError):
        ops.flash_attention(q, torch.zeros(1, 8, 2, 64),
                            torch.zeros(1, 8, 2, 64), window=0)


# -- CUDA lane ----------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(3))
def test_cuda_fused_addto_and_read_match_plain(cuda, seed):
    rng = np.random.RandomState(seed)
    regs = _regs(rng, 40_000)
    f = _fvals(rng, 40_000, 10 ** 8)
    for scale in (1, 10 ** 8):
        got = fused_gpv.fused_addto(_t(regs).to(cuda), 0, _t(f).to(cuda),
                                    scale)
        want = fused_gpv.fused_addto_plain(_t(regs).to(cuda), 0,
                                           _t(f).to(cuda), scale)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        gv, gm = fused_gpv.fused_read(got, 3, 39_000, scale)
        wv, wm = fused_gpv.fused_read_plain(got, 3, 39_000, scale)
        assert torch.equal(gv.view(torch.int32), wv.view(torch.int32))
        assert torch.equal(gm, wm)


# fused_addto_runs at the path's segments (40 000 slots): phase b's layout
# (7 runs, 262 144 values), unaligned starts and lengths, more runs than one
# launch table holds, and a single run
CUDA_RUN_CASES = {
    "phase_b": [(0, 40_000)] * 6 + [(0, 22_144)],
    "unaligned_starts": [(17, 39_983), (3, 20_000), (1, 1), (39_999, 1),
                         (5, 30_027)],
    "past_run_table": [(r % 7, 997) for r in range(fused_gpv.MAX_RUNS + 9)],
    "one_run": [(123, 39_000)],
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CUDA_RUN_CASES))
def test_cuda_fused_addto_runs_match_plain(cuda, case):
    rng = np.random.RandomState(len(case))
    regs, runs, f = _runs(rng, CUDA_RUN_CASES[case], 40_000, 10 ** 8)
    got = [_t(r).to(cuda) for r in regs]
    want = [_t(r).to(cuda) for r in regs]
    fd = _t(f).to(cuda)
    ops.reset_counts()
    fused_gpv.fused_addto_runs([(got[i], a, o, n) for i, a, o, n in runs],
                               fd, 10 ** 8)
    assert ops.launch_counts()["fused_addto"] == \
        -(-len(runs) // fused_gpv.MAX_RUNS)
    fused_gpv.fused_addto_runs_plain(
        [(want[i], a, o, n) for i, a, o, n in runs], fd, 10 ** 8)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [40_000, 40_001])
@pytest.mark.parametrize("rows", [2, 3, 16, 17])
def test_cuda_sat_add_batch_matches_plain(cuda, rows, n):
    acc, qs = _batch_case(np.random.RandomState(rows + n), rows, n)
    acc, qs = _t(acc).to(cuda), _t(qs).to(cuda)
    got = inc_agg.sat_add_batch(acc, qs)
    want = inc_agg.sat_add_batch_plain(acc, qs)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


# the edges of the scatter's two lanes (csrc/scatter.cuh): a case names its
# slot count and k relative to the cluster lane's limits, which the kernel
# library holds, so they are resolved inside the test, on the card
CUDA_SCATTER_CASES = ("seed0", "seed1", "seed2", "slots_not_divisible",
                      "slots_262144", "slots_at_limit", "slots_past_limit",
                      "slots_twice_limit",
                      "k_at_limit", "k_past_limit", "k1", "one_slot_safe",
                      "one_slot_saturating", "int32_min_and_sticky",
                      "sentinel_registers", "out_of_range")


def _scatter_case(name, limits):
    """(regs, idx, int values, fp32 values, scale) of a CUDA scatter case.
    The fp32 stream of a case with exact int values is those values at
    scale 1 (each a power of two or small enough to be exact in fp32)."""
    seed = int(name[4:]) if name.startswith("seed") else 7
    rng = np.random.RandomState(seed)
    n, k = 40_000, 65_536
    n = {"slots_not_divisible": 40_003, "slots_at_limit": limits["max_slots"],
         "slots_past_limit": limits["max_slots"] + 1,
         "slots_twice_limit": 2 * limits["max_slots"],
         "slots_262144": 262_144, "one_slot_safe": 64,
         "one_slot_saturating": 64}.get(name, n)
    k = {"k_at_limit": limits["max_k"], "k_past_limit": limits["max_k"] + 1,
         "k1": 1}.get(name, k)
    regs = _regs(rng, n)
    idx = rng.randint(0, n, k).astype(np.int32)
    idx[:k // 16] = rng.randint(0, 64, k // 16)            # hot duplicates
    val = rng.randint(-10 ** 5, 10 ** 5, k).astype(np.int32)
    val[rng.choice(k, min(k, 600), replace=False)] = SAT_MAX // 3
    if name.startswith("seed"):
        return regs, idx, val, _fvals(rng, k, 100), 100
    if name.startswith("one_slot"):
        idx[:] = 5
        regs[5] = 0
        val = rng.randint(-10, 11, k).astype(np.int32)
        if name == "one_slot_saturating":
            val[::4096] = 2 ** 29
    elif name == "int32_min_and_sticky":
        # slot 0 ends on -2**31 (kept), slots 1-3 on a sentinel, and slot 1
        # keeps it through a later update; no other update touches them
        regs[:4] = [-2 ** 30, 2 ** 30 - 1, -(2 ** 30 - 1), 2 ** 30 - 1]
        val[:] = rng.randint(-8, 9, k)
        idx[idx < 4] += 4
        idx[:6] = [0, 1, 2, 3, 3, 1]
        val[:6] = [-2 ** 30, 2 ** 30, -2 ** 30, 2 ** 29, 2 ** 29, -5]
    elif name == "sentinel_registers":
        regs[:64:2] = INT32_MAX
        regs[1:64:2] = INT32_MIN
        val[:] = rng.randint(-10 ** 5, 10 ** 5, k)
    elif name == "out_of_range":
        bad = rng.choice(k, 1000, replace=False)
        idx[bad] = rng.choice([-1, -2 ** 31, n, n + 5, 2 ** 31 - 1], 1000)
    return regs, idx, val, val.astype(np.float32), 1


@pytest.mark.cuda
@pytest.mark.parametrize("case", CUDA_SCATTER_CASES)
def test_cuda_scatters_match_plain(cuda, case):
    """Both scatter kernels bitwise against their plain versions at the
    edges of the cluster lane and on the large lane; each launch counted
    on the lane its size takes. Out-of-range slots are skipped, so the
    plain version sees the stream without them."""
    regs, idx, val, f, scale = _scatter_case(case, tsparse.cluster_limits())
    keep = (idx >= 0) & (idx < len(regs))
    lane = tsparse.scatter_lane(len(regs), len(idx))
    assert (lane == "large") == case.endswith(("past_limit", "twice_limit"))
    for name, kernel, plain, v in (
            ("sparse_addto", tsparse.sparse_addto,
             tsparse.sparse_addto_plain, val),
            ("fused_scatter",
             lambda r, i, x: fused_gpv.fused_scatter(r, i, x, scale),
             lambda r, i, x: fused_gpv.fused_scatter_plain(r, i, x, scale),
             f)):
        before = dict(ops.KERNELS[name].lanes)
        got = kernel(_t(regs).to(cuda), _t(idx).to(cuda), _t(v).to(cuda))
        want = plain(_t(regs).to(cuda), _t(idx[keep]).to(cuda),
                     _t(v[keep]).to(cuda))
        torch.cuda.synchronize()
        assert torch.equal(got, want), name
        assert ops.KERNELS[name].lanes[lane] == before[lane] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(2))
def test_cuda_fused_fold_matches_plain(cuda, seed):
    rng = np.random.RandomState(seed)
    for rounds, scale in ((1, 1), (8, 10 ** 8), (3, 100)):
        f = _t(_fold_stack(rng, rounds, 262_144, scale)).to(cuda)
        got = fused_gpv.fused_fold(f, scale)
        want = fused_gpv.fused_fold_plain(f, scale)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(2))
def test_cuda_stream_kernels_match_plain(cuda, seed):
    rng = np.random.RandomState(seed)
    n = 1 << 20
    a = _t(_int_stream(rng, n)).to(cuda)
    qs = _t(np.stack([_int_stream(rng, n) for _ in range(16)])).to(cuda)
    assert torch.equal(inc_agg.sat_add(a, qs[0]),
                       inc_agg.sat_add_plain(a, qs[0]))
    assert torch.equal(inc_agg.sat_add_batch(a, qs),
                       inc_agg.sat_add_batch_plain(a, qs))
    for scale in (1, 10 ** 8):
        x = _t(_fvals(rng, n, scale)).to(cuda)
        q = tquantize.quantize(x, scale)
        assert torch.equal(q, tquantize.quantize_plain(x, scale))
        gv, gm = tdequantize.dequantize(q, scale)
        wv, wm = tdequantize.dequantize_plain(q, scale)
        assert torch.equal(gv.view(torch.int32), wv.view(torch.int32))
        assert torch.equal(gm, wm)
    torch.cuda.synchronize()


# (b, h, kv, s, d, window): the prefill of qwen2.5-3b (B=4, H=16, KV=2,
# S=2048, D=128), gemma3's window, S not a multiple of the 128-row tile,
# S inside one tile, a window narrower than a tile, D=64 and D=32; then the
# edges of the kernel's tiles (BM = 128 q rows; BN = 128 keys, 64 at
# D=256): S = 1 and BM -+ 1, S = BN + 1 at D=256, windows of 1 and BN -+ 1,
# H = KV (stablelm: D=64, 32 heads) and recurrentgemma-9b's local layer
# (H=16, KV=1, D=256, window 2048) at B=1
CUDA_FLASH_CASES = [(4, 16, 2, 2048, 128, None), (2, 16, 2, 2048, 128, 1024),
                    (2, 4, 2, 1000, 128, None), (1, 4, 1, 384, 128, None),
                    (2, 2, 2, 40, 128, None), (1, 4, 2, 700, 128, 40),
                    (1, 8, 2, 300, 64, None), (2, 4, 2, 77, 32, 20),
                    (1, 4, 2, 1, 128, None), (2, 4, 2, 127, 128, None),
                    (2, 4, 2, 129, 128, None), (1, 4, 2, 65, 256, None),
                    (1, 4, 2, 300, 128, 1), (1, 4, 2, 500, 128, 127),
                    (1, 4, 2, 500, 128, 129), (1, 4, 2, 300, 256, 63),
                    (1, 4, 2, 300, 256, 65), (1, 32, 32, 300, 64, None),
                    (1, 16, 1, 4096, 256, 2048)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CUDA_FLASH_CASES)
def test_cuda_flash_attention_matches_plain(cuda, case):
    """bf16 on the card; the kernel rounds p to bf16 before p.V where the
    plain version keeps fp32, so the tolerance is test_kernels_flash.py's
    bf16 one (atol 2e-2, rtol 5e-2)."""
    b, h, kv, s, d, window = case
    rng = np.random.RandomState(s)
    q = torch.from_numpy(rng.randn(b, s, h, d).astype(np.float32))
    k = torch.from_numpy(rng.randn(b, s, kv, d).astype(np.float32))
    v = torch.from_numpy(rng.randn(b, s, kv, d).astype(np.float32))
    q, k, v = (t.to(cuda, torch.bfloat16) for t in (q, k, v))
    before = ops.launch_counts()["flash_attention"]
    got = ops.flash_attention(q, k, v, causal=True, window=window)
    want = tflash.flash_attention_plain(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == before + 1
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=5e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [128, 256])
def test_cuda_flash_attention_reads_strided_views_and_non_causal(cuda, d):
    """(B,H,S,D) tensors seen as (B,S,H,D) views run without a copy; the
    non-causal lane masks only the keys past a ragged S."""
    rng = np.random.RandomState(5)
    b, h, kv, s = 2, 4, 2, 200
    q = torch.from_numpy(rng.randn(b, h, s, d).astype(np.float32))
    k = torch.from_numpy(rng.randn(b, kv, s, d).astype(np.float32))
    v = torch.from_numpy(rng.randn(b, kv, s, d).astype(np.float32))
    q, k, v = (t.to(cuda, torch.bfloat16).transpose(1, 2)
               for t in (q, k, v))
    for causal in (True, False):
        got = ops.flash_attention(q, k, v, causal=causal)
        want = tflash.flash_attention_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                                   rtol=5e-2)
    with pytest.raises(TypeError):
        ops.flash_attention(q.float(), k.float(), v.float())


@pytest.mark.cuda
def test_cuda_flash_attention_rejects_a_head_dim_it_does_not_take(cuda):
    """The kernel takes D in HEAD_DIMS; a CUDA tensor of another D raises
    rather than fall back to the plain version."""
    q, k, v = (torch.zeros(1, 64, h, 48, device=cuda, dtype=torch.bfloat16)
               for h in (4, 2, 2))
    before = ops.launch_counts()["flash_attention"]
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, v)
    assert ops.launch_counts()["flash_attention"] == before


@pytest.mark.cuda
def test_cuda_kernels_run_on_a_side_stream(cuda):
    """Each wrapper launches on PyTorch's current stream, handed to the
    kernel as a pointer, also where its ctypes signature leaves the
    stream out (sat_add): a side stream gives the same results."""
    rng = np.random.RandomState(9)
    a = _t(_int_stream(rng, 1 << 16)).to(cuda)
    b = _t(_int_stream(rng, 1 << 16)).to(cuda)
    q, k, v = (torch.from_numpy(rng.randn(1, 256, h, 64).astype(np.float32))
               .to(cuda, torch.bfloat16) for h in (4, 2, 2))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got_sum = inc_agg.sat_add(a, b)
        got_att = ops.flash_attention(q, k, v)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    assert torch.equal(got_sum, inc_agg.sat_add_plain(a, b))
    torch.testing.assert_close(got_att.float(),
                               tflash.flash_attention_plain(q, k, v).float(),
                               atol=2e-2, rtol=5e-2)
