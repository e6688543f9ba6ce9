"""The port's array-native GPV wire path against the JAX package: the 27
tests (43 cases) of ``tests/test_wire_path.py`` mirrored under their
names.

Each body runs once on the reference and once on the port (every runtime
and register file on ``device="cpu"``) through ``_torch_front``: the
vectorized quantize against the scalar oracle, the GPV path against the
per-element dict path (replies, final map state, every data-plane stat),
the folded spill and miss/grant accounting, and the reply shapes. Within
each package the reference's assertions hold; across the packages the
quantized streams, replies, states and stats are equal, bit for bit.

The device lane goes through the port's public names: the reference's
``fused_addto_pallas`` and ``fused_read_pallas`` (interpret mode) against
``fused_gpv.fused_addto`` and ``fused_gpv.fused_read`` on CPU tensors (their
plain versions). ``cuda``-marked twins hold the hand kernels against the
plain versions on the card. The JAX package is imported only inside the
CPU-lane tests: the card's machine has no JAX.
"""
import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
from _torch_front import mirror, port, ref, same


@pytest.fixture
def gpv_on():
    prevs = [(pk, pk.rpc.set_gpv(True)) for pk in (ref(), port())]
    yield
    for pk, prev in prevs:
        pk.rpc.set_gpv(prev)


# ---- quantize/dequantize: vectorized == scalar oracle ------------------------

def _stream_vs_scalar(pk, precision, xs):
    scale = 10 ** precision
    out = []
    for dtype in (np.float64, np.float32):
        arr = np.array(xs, dtype)
        want = pk.inc_map.quantize_scalar_ref(list(arr), scale)
        got = pk.inc_map.quantize_stream(arr, scale)
        assert got.tolist() == want, (dtype, precision)
        out.append(got)
    return out


@settings(max_examples=30, deadline=None)
@given(st.integers(0, 8),
       st.lists(st.floats(-2e4, 2e4), min_size=1, max_size=40))
def test_quantize_stream_matches_scalar(precision, xs):
    mirror(_stream_vs_scalar, precision, xs)


def _halfway(pk, precision):
    scale = 10 ** precision
    xs = (np.arange(-25, 25) + 0.5) / scale
    want = pk.inc_map.quantize_scalar_ref(list(xs), scale)
    got = pk.inc_map.quantize_stream(xs, scale)
    assert got.tolist() == want
    return got


@pytest.mark.parametrize("precision", range(0, 9))
def test_quantize_halfway_cases_round_to_even(precision):
    mirror(_halfway, precision)


def _int_pass(pk):
    im = pk.inc_map
    vals = [0, 1, -7, 123456, -2**31 + 1]
    outs = [im.quantize_stream(np.array(vals), s) for s in (1, 100)]
    for s, o in zip((1, 100), outs):
        assert o.tolist() == im.quantize_scalar_ref(vals, s)
    mixed = [1, 2.5, -3]
    outs.append(im.quantize_values(mixed, 10))
    assert outs[-1].tolist() == im.quantize_scalar_ref(mixed, 10)
    return outs


def test_quantize_int_values_pass_through():
    mirror(_int_pass)


def _carry(pk, precision, qs):
    scale = 10 ** precision
    q = np.array(qs, np.int64)
    floats = q / scale
    requant = pk.inc_map.quantize_stream(floats, scale)
    assert requant.tolist() == q.tolist()
    assert pk.inc_map.quantize_scalar_ref(list(floats), scale) == q.tolist()
    return requant


@settings(max_examples=20, deadline=None)
@given(st.integers(0, 8), st.lists(st.integers(-2**31 + 1, 2**31 - 1),
                                   min_size=1, max_size=40))
def test_phase1_fixed_point_carry_is_identity(precision, qs):
    mirror(_carry, precision, qs)


def _reply_dequant(pk):
    """The host lane's reply dequantize is ``raw / scale`` in float64:
    as the reference checks it, then end to end in each package, every
    ``raw`` put through a ``Precision`` service and read back."""
    raw = np.array([-10**9, -3, 0, 7, 10**9], np.int64)
    out = []
    for precision in range(0, 9):
        scale = 10 ** precision
        want = [int(r) / scale for r in raw]
        assert (raw / scale).tolist() == want
        svc = pk.Service("T")
        svc.rpc("Put", [pk.Field("kvs", "STRINTMap")], [pk.Field("msg")],
                pk.NetFilter.from_dict({"AppName": f"RD-{precision}",
                                        "Precision": precision,
                                        "addTo": "R.kvs"}))
        svc.rpc("Get", [pk.Field("kvs", "STRINTMap")],
                [pk.Field("kvs", "STRINTMap")],
                pk.NetFilter.from_dict({"AppName": f"RD-{precision}",
                                        "Precision": precision,
                                        "get": "Y.kvs"}))
        stub = pk.NetRPC().make_stub(svc)
        stub.call("Put", {"kvs": {f"r{i}": int(r) / scale
                                  for i, r in enumerate(raw)}})
        got = stub.call("Get", {"kvs": {f"r{i}": 0
                                        for i in range(len(raw))}})["kvs"]
        assert [got[f"r{i}"] for i in range(len(raw))] == want
        out.append(got)
    return out


def test_reply_dequantize_matches_scalar_division():
    mirror(_reply_dequant)


def _nonfinite(pk):
    import warnings
    im = pk.inc_map
    half = np.array([0.5, 300.0], np.float16)
    errs = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for call, kinds in (
                (lambda: im.quantize_stream(half, 10 ** 6), OverflowError),
                (lambda: im.quantize_scalar_ref(list(half), 10 ** 6),
                 (OverflowError, ValueError)),
                (lambda: im.quantize_stream(np.array([np.nan]), 10),
                 ValueError),
                (lambda: im.quantize_scalar_ref([float("nan")], 10),
                 ValueError)):
            with pytest.raises(kinds) as ei:
                call()
            errs.append((type(ei.value).__name__, str(ei.value)))
    return errs


def test_quantize_nonfinite_raises_like_scalar_oracle():
    mirror(_nonfinite)


def _overflow(pk):
    im = pk.inc_map
    errs = []
    for call in (lambda: im.quantize_stream(np.array([2 ** 60], np.int64),
                                            100),
                 lambda: pk.rpc._int32_checked(np.array([10 ** 10],
                                                        np.int64)),
                 lambda: im.quantize_stream(np.array([1e19]), 1),
                 lambda: im.quantize_stream(np.array([2 ** 63], np.uint64),
                                            1)):
        with pytest.raises(OverflowError) as ei:
            call()
        errs.append(str(ei.value))
    big = 2 ** 53 + 1
    exact = im.quantize_values([big, 0.5], 1)
    assert exact.tolist() == im.quantize_scalar_ref([big, 0.5], 1)
    return errs, exact


def test_quantize_overflow_stays_loud():
    mirror(_overflow)


def _versions(pk):
    s = pk.inc_map._SpillMap()
    v = s.version
    s[3] += 5
    assert s.version > v and s[3] == 5
    bumps = []
    for mutate in (lambda: s.setdefault(9, 2), lambda: s.pop(9),
                   lambda: s.update({4: 1}), lambda: s.popitem(),
                   lambda: s.clear()):
        v = s.version
        mutate()
        assert s.version > v
        bumps.append(s.version - v)
    return bumps, dict(s)


def test_spill_map_version_tracks_every_mutation():
    mirror(_versions)


# ---- device-lane quantize and read: the port's kernels' entry points --------

def _halfway_stream(precision):
    scale = 10 ** precision
    ks = np.arange(-25, 25)
    rng = np.random.RandomState(precision)
    return np.concatenate([
        (ks + 0.5) / scale,
        ks / scale,
        rng.uniform(-20.0, 20.0, 64),
    ]).astype(np.float32)


def _addto_entry(xs, scale, device):
    from repro_torch.kernels import fused_gpv
    regs = torch.zeros(len(xs), dtype=torch.int32, device=device)
    fused_gpv.fused_addto(regs, 0, torch.from_numpy(xs).to(device), scale)
    return regs.cpu().numpy()


@pytest.mark.parametrize("precision", range(0, 9))
def test_device_quantize_matches_host_across_signs_and_halfway(precision):
    """``fused_gpv.fused_addto`` into a zeroed segment leaves exactly
    ``quantize_stream(xs)`` behind, as the reference's
    ``fused_addto_pallas`` (interpret mode) does on the same stream."""
    import jax.numpy as jnp
    from repro.kernels.fused_gpv import fused_addto_pallas
    scale = 10 ** precision
    xs = _halfway_stream(precision)
    want = port().inc_map.quantize_stream(xs, scale).astype(np.int32)
    got = _addto_entry(xs, scale, "cpu")
    np.testing.assert_array_equal(got, want)
    jax_got = np.asarray(fused_addto_pallas(
        jnp.zeros(len(xs), jnp.int32), 0, jnp.asarray(xs), scale,
        interpret=True))
    same(got, jax_got)
    same(want, ref().inc_map.quantize_stream(xs, scale).astype(np.int32))


def _sentinel_raw(pk):
    c = pk.constants
    return np.array([0, 5, -7, 123456789, c.INT32_MAX, c.INT32_MIN,
                     c.SAT_MAX, c.SAT_MIN], np.int32)


def _read_entry(raw, scale, device):
    from repro_torch.kernels import fused_gpv
    vals, mask = fused_gpv.fused_read(torch.from_numpy(raw).to(device), 0,
                                      len(raw), scale)
    return vals.cpu().numpy(), mask.cpu().numpy()


def test_device_read_dequant_contract_and_sentinel_mask():
    """``fused_gpv.fused_read`` replies ``raw * (1 / float32(scale))`` with
    the overflow sentinels masked, as the reference's
    ``fused_read_pallas`` (interpret mode) does."""
    import jax.numpy as jnp
    from repro.kernels.fused_gpv import fused_read_pallas
    raw = _sentinel_raw(port())
    same(raw, _sentinel_raw(ref()))
    vals, mask = _read_entry(raw, 10 ** 6, "cpu")
    inv = np.float32(1.0) / np.float32(10.0 ** 6)
    np.testing.assert_array_equal(vals, raw.astype(np.float32) * inv)
    assert mask.tolist() == [False] * 4 + [True, True, False, False]
    jv, jm = fused_read_pallas(jnp.asarray(raw), 0, len(raw), 10 ** 6,
                               interpret=True)
    same(vals, np.asarray(jv))
    same(mask, np.asarray(jm))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("precision", range(0, 9))
def test_cuda_device_quantize_matches_plain(cuda, precision):
    """The hand kernel behind ``fused_gpv.fused_addto`` against its plain
    version on the card, on the halfway streams above, bit for bit."""
    from repro_torch.kernels import fused_gpv, ops
    scale = 10 ** precision
    xs = _halfway_stream(precision)
    ops.reset_counts()
    got = _addto_entry(xs, scale, cuda)
    assert ops.launch_counts()["fused_addto"] == 1
    want = fused_gpv.fused_addto_plain(
        torch.zeros(len(xs), dtype=torch.int32, device=cuda), 0,
        torch.from_numpy(xs).to(cuda), scale).cpu().numpy()
    same(got, want)
    same(got, port().inc_map.quantize_stream(xs, scale).astype(np.int32))


@pytest.mark.cuda
def test_cuda_device_read_dequant_contract_and_sentinel_mask(cuda):
    """The hand kernel behind ``fused_gpv.fused_read`` against its plain
    version on the card: the reciprocal multiply and the sentinel mask."""
    from repro_torch.kernels import fused_gpv, ops
    raw = _sentinel_raw(port())
    ops.reset_counts()
    got = _read_entry(raw, 10 ** 6, cuda)
    assert ops.launch_counts()["fused_read"] == 1
    want = fused_gpv.fused_read_plain(torch.from_numpy(raw).to(cuda), 0,
                                      len(raw), 10 ** 6)
    same(got, tuple(w.cpu().numpy() for w in want))
    assert got[1].tolist() == [False] * 4 + [True, True, False, False]


# ---- fold_stream_host: one pass == Counter reference -------------------------

def _fold(pk, pairs):
    from collections import Counter
    logs = np.array([l for l, _ in pairs], np.uint32)
    vals = np.array([v for _, v in pairs], np.int64)
    keys, counts, sums = pk.ops.fold_stream_host(logs, vals)
    seen, order_ref = set(), []
    for l, _ in pairs:
        if l not in seen:
            seen.add(l)
            order_ref.append(l)
    assert keys.tolist() == order_ref
    cnt_ref = Counter(l for l, _ in pairs)
    sum_ref = Counter()
    for l, v in pairs:
        sum_ref[l] += v
    assert counts.tolist() == [cnt_ref[l] for l in order_ref]
    assert sums.tolist() == [sum_ref[l] for l in order_ref]
    return keys, counts, sums


@settings(max_examples=20, deadline=None)
@given(st.lists(st.tuples(st.integers(0, 12), st.integers(-50, 50)),
                min_size=1, max_size=60))
def test_fold_stream_host_matches_counter(pairs):
    mirror(_fold, pairs)


# ---- end-to-end: GPV path == dict path ---------------------------------------

def _tensor_service(pk, app, precision, clear, modify):
    svc = pk.Service("T")
    mod = ("nop" if modify == "nop"
           else {"op": modify[0], "para": modify[1]})
    svc.rpc("Update", [pk.Field("tensor", "FPArray")],
            [pk.Field("tensor", "FPArray")],
            pk.NetFilter.from_dict({"AppName": app, "Precision": precision,
                                    "get": "A.tensor", "addTo": "N.tensor",
                                    "clear": clear, "modify": mod}))
    return svc


def _run_stream(pk, gpv, app, precision, clear, modify, tensors, collide):
    prev = pk.rpc.set_gpv(gpv)
    try:
        stub = pk.NetRPC().make_stub(
            _tensor_service(pk, app, precision, clear, modify))
        if collide:
            stub.agents["Update"].logical(2**32 + 2)
        replies = [stub.call("Update", {"tensor": t}) for t in tensors]
        srv = stub.agents["Update"].server
        n = max(len(np.ravel(t)) for t in tensors)
        state = srv.read_batch(np.arange(n, dtype=np.uint32)).tolist()
        stats = {"hits": srv.hits, "misses": srv.misses,
                 "inc_bytes": srv.inc_bytes, "host_bytes": srv.host_bytes,
                 "spill": dict(srv.spill), "mapped": set(srv.mapping)}
        return replies, state, stats
    finally:
        pk.rpc.set_gpv(prev)


CLEARS = ("nop", "copy")
MODIFIES = ("nop", ("max", 30), ("add", 5))


def _gpv_vs_dict(pk, app, precision, clear, modify, collide, tensors):
    r_gpv, s_gpv, st_gpv = _run_stream(pk, True, app + "-g", precision,
                                       clear, modify, tensors, collide)
    r_dict, s_dict, st_dict = _run_stream(pk, False, app + "-d", precision,
                                          clear, modify, tensors, collide)
    for got, want, t in zip(r_gpv, r_dict, tensors):
        want_vec = [want["tensor"][i] for i in range(len(t))]
        got_vec = [got["tensor"][i] for i in range(len(t))]
        assert got_vec == want_vec
    assert s_gpv == s_dict
    assert st_gpv == st_dict
    return r_gpv, s_gpv, st_gpv


@settings(max_examples=10, deadline=None)
@given(st.integers(0, 2),
       st.sampled_from(CLEARS),
       st.sampled_from(MODIFIES),
       st.integers(0, 1),
       st.lists(st.lists(st.floats(-60.0, 60.0), min_size=1, max_size=9),
                min_size=1, max_size=6))
def test_gpv_equals_dict_path_end_to_end(precision, clear, modify, collide,
                                         payloads):
    tag = modify if isinstance(modify, str) else f"{modify[0]}{modify[1]}"
    app = f"WPEQ-{precision}-{clear}-{tag}-{collide}"
    tensors = [np.array(p, np.float32) for p in payloads]
    mirror(_gpv_vs_dict, app, precision, clear, modify, collide, tensors)


def _batch_cntfwd(pk):
    def build(gpv):
        prev = pk.rpc.set_gpv(gpv)
        try:
            svc = pk.Service("G")
            svc.rpc("Update", [pk.Field("tensor", "FPArray")],
                    [pk.Field("tensor", "FPArray")],
                    pk.NetFilter.from_dict({
                        "AppName": f"WPCF-{int(gpv)}", "Precision": 4,
                        "get": "A.tensor", "addTo": "N.tensor",
                        "clear": "copy",
                        "CntFwd": {"to": "ALL", "threshold": 2,
                                   "key": "ClientID"}}))
            stub = pk.NetRPC().make_stub(svc)
            rng = np.random.RandomState(7)
            reqs = [{"tensor": rng.randn(16).astype(np.float32)}
                    for _ in range(4)]
            return stub.call_batch("Update", reqs)
        finally:
            pk.rpc.set_gpv(prev)

    got = build(True)
    want = build(False)
    assert got[0] == {} and got[2] == {}
    for g, w in zip(got, want):
        if not w:
            assert g == w
            continue
        assert [g["tensor"][i] for i in range(16)] == \
            [w["tensor"][i] for i in range(16)]
    return got


def test_gpv_batch_and_cntfwd_match_dict_path(gpv_on):
    mirror(_batch_cntfwd)


# ---- spill batching: folded update == per-item loop --------------------------

def _agent(pk, **kw):
    return pk.ServerAgent(pk.SwitchMemory(2, 64), gaid=1, n_slots=8, **kw)


def _spill(pk):
    pairs = [(3, 5), (9, -2), (3, 7), (40, 0), (9, 1)]
    a, b = _agent(pk), _agent(pk)
    a.spill_host(list(pairs))
    for l, v in pairs:
        b.spill[l] += v
        b.host_bytes += 8
    assert dict(a.spill) == dict(b.spill)
    assert a.host_bytes == b.host_bytes
    assert a.misses == b.misses == 0
    return dict(a.spill), a.host_bytes, a.misses


def test_spill_host_matches_per_item_loop():
    mirror(_spill)


def _folded_stats(pk):
    rng = np.random.RandomState(3)
    logs = (rng.zipf(1.4, 200) % 24).astype(np.uint32)
    vals = rng.randint(-9, 9, 200)
    batched = _agent(pk, window=64)
    for i in range(0, 200, 40):
        batched.addto_batch(logs[i:i + 40], vals[i:i + 40])
    assert batched.hits + batched.misses == 200
    assert batched.inc_bytes == 8 * batched.hits
    assert batched.host_bytes == 8 * batched.misses
    total = {int(k): 0 for k in set(logs.tolist())}
    for l, v in zip(logs.tolist(), vals.tolist()):
        total[l] += v
    reads = {l: batched.read(l) for l in sorted(total)}
    for l, want in total.items():
        assert reads[l] == want, l
    return (batched.hits, batched.misses, batched.inc_bytes,
            batched.host_bytes, dict(batched.spill), reads)


def test_addto_batch_folded_stats_match_reference():
    mirror(_folded_stats)


# ---- reply shapes ------------------------------------------------------------

def _grad_shape(pk):
    inc = pk.inc

    @inc.service(app="WPSH-1")
    class GradShape:
        @inc.rpc(request_msg="N", reply_msg="A")
        def Update(self, tensor: inc.Agg[inc.FPArray](precision=6,
                                                      clear="copy")
                   ) -> {"tensor": inc.Get[inc.FPArray]}: ...
    return GradShape


def _typed_shape(pk):
    stub = pk.NetRPC().make_stub(_grad_shape(pk))
    g = np.arange(12, dtype=np.float32).reshape(3, 4) / 8
    out = stub.Update(tensor=g).result()["tensor"]
    assert isinstance(out, np.ndarray) and out.shape == (3, 4)
    np.testing.assert_allclose(out, g, atol=1e-6)
    out2 = stub.Update(tensor={0: 1.0, 1: 2.0}).result()["tensor"]
    assert isinstance(out2, dict)
    return out, out2


def test_typed_stub_returns_request_shaped_ndarray(gpv_on):
    mirror(_typed_shape)


def _legacy_dict(pk):
    stub = pk.NetRPC().make_stub(
        _tensor_service(pk, "WPSH-2", 6, "copy", "nop"))
    out = stub.call("Update", {"tensor": np.array([1.5, -2.25])})["tensor"]
    assert isinstance(out, dict)
    assert out == {0: 1.5, 1: -2.25}
    st_ = stub.channels["Update"].stats
    assert st_.gpv_calls == 1 and st_.gpv_elems == 2
    return out, st_.gpv_calls, st_.gpv_elems


def test_legacy_service_stub_keeps_dict_reply(gpv_on):
    mirror(_legacy_dict)


def _forced_dict(pk):
    prev = pk.rpc.set_gpv(False)
    try:
        stub = pk.NetRPC().make_stub(_grad_shape(pk))
        out = stub.Update(tensor=np.array([0.5, 1.5])).result()["tensor"]
        assert isinstance(out, dict)
        assert stub.channels["Update"].stats.gpv_calls == 0
        return out
    finally:
        pk.rpc.set_gpv(prev)


def test_set_gpv_false_forces_dict_marshalling():
    mirror(_forced_dict)


def _items(pk):
    si = pk.rpc._stream_items
    assert isinstance(si({"t": np.zeros(3)}, "M.t"), pk.TensorSegment)
    assert isinstance(si({"t": [1, 2, 3]}, "M.t"), pk.TensorSegment)
    out = [si({"t": {"a": 1}}, "M.t"), si({"t": 3.5}, "M.t"),
           si({"t": ["a", "b"]}, "M.t"), si({}, "M.t")]
    assert out == [{"a": 1}, {0: 3.5}, {0: "a", 1: "b"}, {}]
    return out


def test_stream_items_shapes_fast_vs_dict_path(gpv_on):
    mirror(_items)


# ---- dense collision table ---------------------------------------------------

def _client(pk):
    return pk.ClientAgent(pk.ServerAgent(pk.SwitchMemory(2, 64), gaid=1,
                                         n_slots=32))


def _dense_foreign(pk):
    cl = _client(pk)
    logs, vals, spills = cl.resolve_dense(8, np.arange(8, dtype=np.int64))
    assert spills == [] and len(logs) == 8
    assert cl.logical(2**32 + 3) is None
    assert cl.collisions[2**32 + 3] == 3
    return logs, vals, spills, dict(cl.collisions)


def test_dense_then_foreign_key_collides(gpv_on):
    mirror(_dense_foreign)


def _foreign_dense(pk):
    cl = _client(pk)
    assert cl.logical(2**32 + 3) == 3
    logs, vals, spills = cl.resolve_dense(8, np.arange(10, 18,
                                                       dtype=np.int64))
    assert spills == [(3, 13)]
    assert 3 not in logs.tolist()
    assert len(logs) == 7
    return logs, vals, spills


def test_foreign_then_dense_index_collides(gpv_on):
    mirror(_foreign_dense)


def _grows(pk):
    cl = _client(pk)
    a = cl.dense_addrs(4)
    b = cl.dense_addrs(16)
    assert a.tolist() == list(range(4))
    assert b.tolist() == list(range(16))
    assert cl.logical(5) == 5
    return a, b


def test_dense_table_grows_and_caches(gpv_on):
    mirror(_grows)


# ---- pure-query (ReadMostly) array requests ----------------------------------

def _read_svc(pk, app="WPRQ-1", precision=4, clear=None):
    inc = pk.inc
    fetch_kw = {"precision": precision}
    if clear is not None:
        fetch_kw["clear"] = clear

    @inc.service(app=app)
    class ReadSvc:
        @inc.rpc(request_msg="Accum")
        def Accum(self, tensor: inc.Agg[inc.FPArray](
                precision=precision)): ...

        @inc.rpc(request_msg="FetchReq", reply_msg="FetchReply")
        def Fetch(self, tensor: inc.ReadMostly[inc.FPArray](
                **fetch_kw)): ...
    return ReadSvc


def _pure_query(pk):
    stub = pk.NetRPC().make_stub(_read_svc(pk), n_slots=64)
    g = np.arange(12, dtype=np.float32).reshape(3, 4) / 8
    stub.Accum(tensor=g).result()
    stub.Accum(tensor=g).result()
    ch = stub.channels["Fetch"]
    before = (ch.stats.gpv_calls, ch.stats.gpv_elems)
    out = stub.Fetch(tensor=np.zeros((3, 4), np.float32)).result()["tensor"]
    assert isinstance(out, np.ndarray) and out.shape == (3, 4)
    np.testing.assert_allclose(out, 2 * g, atol=1e-3)
    assert ch.stats.gpv_calls == before[0] + 1
    assert ch.stats.gpv_elems == before[1] + 12
    return out, before


def test_pure_query_array_rides_gpv_path(gpv_on):
    mirror(_pure_query)


def _query_legs(pk, n, precision, arr):
    legs = {}
    for gpv in (True, False):
        prev = pk.rpc.set_gpv(gpv)
        try:
            stub = pk.NetRPC().make_stub(
                _read_svc(pk, "WPRQ-prop", precision), n_slots=64)
            stub.Accum(tensor=arr).result()
            stub.Accum(tensor=-2 * arr).result()
            out = stub.Fetch(tensor=np.zeros(n)).result()["tensor"]
            legs[gpv] = (out.tolist() if isinstance(out, np.ndarray)
                         else [out[i] for i in range(n)])
            assert (stub.channels["Fetch"].stats.gpv_calls > 0) == gpv
        finally:
            pk.rpc.set_gpv(prev)
    assert legs[True] == legs[False]
    return legs


@settings(max_examples=10, deadline=None)
@given(st.integers(1, 24), st.integers(0, 4),
       st.lists(st.floats(-100.0, 100.0), min_size=1, max_size=24))
def test_pure_query_gpv_equals_dict_reference(n, precision, xs):
    arr = np.array((xs * ((n // len(xs)) + 1))[:n], np.float64)
    mirror(_query_legs, n, precision, arr)


def _dict_query(pk):
    stub = pk.NetRPC().make_stub(_read_svc(pk), n_slots=64)
    stub.Accum(tensor=np.array([1.0, 2.0, 3.0])).result()
    out = stub.Fetch(tensor={0: 0, 2: 0}).result()["tensor"]
    assert isinstance(out, dict)
    assert out == {0: 1.0, 2: 3.0}
    assert stub.channels["Fetch"].stats.gpv_calls == 1
    return out


def test_pure_query_dict_request_still_dict_everywhere(gpv_on):
    mirror(_dict_query)


def _clear_once(pk):
    stub = pk.NetRPC().make_stub(
        _read_svc(pk, "WPRQ-clr", precision=2, clear="copy"), n_slots=64)
    g = np.array([1.25, -2.5, 3.75])
    stub.Accum(tensor=g).result()
    first = stub.Fetch(tensor=np.zeros(3)).result()["tensor"]
    np.testing.assert_allclose(first, g, atol=1e-2)
    second = stub.Fetch(tensor=np.zeros(3)).result()["tensor"]
    np.testing.assert_allclose(second, np.zeros(3))
    return first, second


def test_pure_query_clear_applies_once(gpv_on):
    mirror(_clear_once)


def _empty_query(pk):
    legs = {}
    for gpv in (True, False):
        prev = pk.rpc.set_gpv(gpv)
        try:
            stub = pk.NetRPC().make_stub(_read_svc(pk), n_slots=0)
            stub.Accum(tensor={"spilled": 7.0}).result()
            legs[gpv] = stub.Fetch(tensor=np.zeros(0)).result()["tensor"]
        finally:
            pk.rpc.set_gpv(prev)
    assert legs[True] == legs[False]
    assert legs[True]
    return legs


def test_pure_query_empty_array_matches_dict_fallback(gpv_on):
    mirror(_empty_query)
