"""The port's INC map against the JAX package's, op for op.

The same operation sequence goes to a JAX ``ServerAgent``/``ClientAgent``
(numpy host segments, Pallas interpret-mode device segments on the CPU)
and to the port's on ``device="cpu"`` (numpy host segments, plain-version
device segments). Registers (``state_dict``), hits, misses, spill and byte
counters, and every read must be equal; fp32 reads bit for bit.
"""
import numpy as np
import pytest
import torch

from repro.core import inc_map as J
from repro_torch.core import inc_map as T


def _pair(policy="netrpc-lru", capacity=8, window=64, device=False,
          geometry=(2, 64), tensor_host=False):
    """(JAX agent, port agent). ``tensor_host`` gives the port's host
    segments CPU tensors, the layout a CUDA switch uses for every segment,
    so their int updates take the sparse_addto wrapper."""
    kw = dict(gaid=1, n_slots=capacity, policy=policy, window=window,
              device=device)
    sw = T.SwitchMemory(*geometry, device="cpu")
    if tensor_host:
        for seg in sw.segments:
            seg.regs = torch.from_numpy(seg.regs)
    return (J.ServerAgent(J.SwitchMemory(*geometry), **kw),
            T.ServerAgent(sw, **kw))


def _assert_same(j, t):
    js = j.switch.state_dict()
    ts = T.to_jax_state(t.switch.state_dict())
    assert js["partitions"] == ts["partitions"]
    assert js["next_free"] == ts["next_free"]
    for a, b in zip(js["regs"], ts["regs"]):
        np.testing.assert_array_equal(a, b)
    assert (j.hits, j.misses, j.inc_bytes, j.host_bytes) == \
        (t.hits, t.misses, t.inc_bytes, t.host_bytes)
    assert dict(j.spill) == dict(t.spill)
    assert dict(j.mapping) == dict(t.mapping)


def test_hash_and_quantize_match():
    for k in ("hello", b"bytes", 12345, 2 ** 40 + 7, "__cntfwd__ClientID"):
        assert T.hash_key(k) == J.hash_key(k)
    rng = np.random.RandomState(3)
    for arr in ((rng.randn(64) * 9).astype(np.float32), rng.randn(64),
                rng.randint(-99, 99, 64)):
        for scale in (1, 10 ** 4, 10 ** 8):
            np.testing.assert_array_equal(T.quantize_stream(arr, scale),
                                          J.quantize_stream(arr, scale))


@pytest.mark.parametrize("lane", ["host", "tensor_host", "device"])
@pytest.mark.parametrize("policy", J.CACHE_POLICIES)
def test_agent_op_sequence_matches(policy, lane):
    """Duplicate-heavy int and fp32 streams over more keys than the
    partition holds: hits, misses, spill, grants, evictions and reads."""
    j, t = _pair(policy, capacity=8, window=40, device=lane == "device",
                 tensor_host=lane == "tensor_host")
    rng = np.random.RandomState(5)
    for step in range(12):
        logs = (rng.zipf(1.4, 30) % 24).astype(np.uint32)
        if step % 2:
            fv = (rng.randn(30) * 10).astype(np.float32)
            j.addto_batch_f32(logs, fv, 10 ** 4)
            t.addto_batch_f32(logs, fv, 10 ** 4)
        else:
            v = rng.randint(-50, 50, 30)
            j.addto_batch(logs, v)
            t.addto_batch(logs, v)
        probe = np.unique(logs)
        np.testing.assert_array_equal(j.read_batch(probe),
                                      t.read_batch(probe))
    _assert_same(j, t)
    j.end_window()
    t.end_window()
    _assert_same(j, t)
    assert j.read_all() == t.read_all()
    j.retrieve_all()
    t.retrieve_all()
    _assert_same(j, t)
    j.clear_all()
    t.clear_all()
    _assert_same(j, t)


def test_lru_evicts_cold_keys_without_value_loss():
    j, t = _pair("netrpc-lru", capacity=2, window=8)
    for a in (j, t):
        a.addto_batch(np.array([1, 2], np.uint32), np.array([10, 20]))
        for _ in range(4):
            a.addto_batch(np.array([3, 4], np.uint32), np.array([1, 1]))
    assert set(t.mapping) == {3, 4}
    assert [t.read(k) for k in (1, 2, 3, 4)] == [10, 20, 4, 4]
    _assert_same(j, t)


def test_client_agent_resolution_and_collisions():
    j, t = _pair(capacity=16)
    cj, ct = J.ClientAgent(j), T.ClientAgent(t)
    kv = {"a": 1.5, "b": -2.25, 7: 3.0, 2 ** 33 + 7: 1.0}
    for c in (cj, ct):
        c.logical("a")
        c.key_of[J.hash_key("b")] = "a"        # force a collision for "b"
        c.collisions["b"] = J.hash_key("b")
    rj, rt = cj.resolve(kv, 4), ct.resolve(kv, 4)
    for a, b in zip(rj[:2], rt[:2]):
        np.testing.assert_array_equal(a, b)
    assert rj[2] == rt[2]
    f = np.linspace(-3, 3, 12, dtype=np.float32)
    for a, b in zip(cj.resolve_dense_f32(12, f, 10 ** 4)[:2],
                    ct.resolve_dense_f32(12, f, 10 ** 4)[:2]):
        np.testing.assert_array_equal(a, b)
    cj.addto(kv, 4)
    ct.addto(kv, 4)
    _assert_same(j, t)


def test_read_batch_dev_fast_and_fallback_paths():
    """The fused single-segment read and the spill fallback both return
    fp32 tensors bitwise equal to the JAX device reply."""
    j, t = _pair(capacity=16, device=True)
    fv = np.arange(16, dtype=np.float32) / 3
    logs = np.arange(16, dtype=np.uint32)
    for a in (j, t):
        a.addto_batch_f32(logs, fv, 10 ** 4)      # miss, grant, migrate
        a.addto_batch_f32(logs, fv, 10 ** 4)      # hit: fused addto
    vj, rj = j.read_batch_dev(logs, 10 ** 4, need_raw=True)
    vt, rt = t.read_batch_dev(logs, 10 ** 4, need_raw=True)
    assert isinstance(vt, torch.Tensor) and vt.dtype == torch.float32
    np.testing.assert_array_equal(vt.numpy().view(np.int32),
                                  np.asarray(vj).view(np.int32))
    np.testing.assert_array_equal(rt, rj)
    for a in (j, t):
        a.spill_host([(999, 7)])
    q = np.array([999, 3], np.uint32)
    np.testing.assert_array_equal(
        t.read_batch_dev(q, 10 ** 4)[0].numpy().view(np.int32),
        np.asarray(j.read_batch_dev(q, 10 ** 4)[0]).view(np.int32))
    _assert_same(j, t)


def test_scatter_with_duplicate_slots_after_regrant():
    """A device partition whose mapping is not contiguous takes the fused
    scatter lane: duplicates saturate in stream order as in the JAX
    package."""
    j, t = _pair("fcfs", capacity=8, device=True)
    logs0 = np.array([5, 1, 7, 3, 0, 2, 6, 4], np.uint32)
    fv = np.array([2.0e5, -1.5, 0.25, 2.5, -1e5, 1e5, 3.0, -2.0],
                  np.float32)
    for a in (j, t):
        a.addto_batch_f32(logs0, fv, 10 ** 4)     # grants in this order
    T.ops.reset_counts()
    logs = np.array([1, 1, 5, 5, 5, 3, 1], np.uint32)
    big = np.array([1.5e5, 1.5e5, 1.5e5, -2e5, 1.5e5, 0.5, -1.5e5],
                   np.float32)
    for a in (j, t):
        a.addto_batch_f32(logs, big, 10 ** 4)
    assert T.ops.plain_counts()["fused_scatter"] == 1
    _assert_same(j, t)


def test_addto_dense_matches_sparse_addto_and_jax():
    rng = np.random.default_rng(7)
    for start, n in ((0, 16), (50, 40), (63, 2)):
        a = T.SwitchMemory(2, 64, device="cpu")
        b = T.SwitchMemory(2, 64, device="cpu")
        b.segments[1].regs = torch.from_numpy(b.segments[1].regs)
        c = J.SwitchMemory(2, 64)
        phys = np.arange(start, start + n, dtype=np.int64)
        for vals in (rng.integers(-999, 999, size=n).astype(np.int32),
                     np.full(n, 2_000_000_000, np.int32),
                     np.full(n, 2_000_000_000, np.int32)):
            a.addto(phys, vals)
            b.addto_dense(start, vals)
            c.addto_dense(start, vals)
        np.testing.assert_array_equal(a.get(phys), b.get(phys))
        np.testing.assert_array_equal(a.get(phys), c.get(phys))


def test_state_dict_round_trip_with_jax():
    """A JAX register file loads into the port (host and device segments)
    and comes back unchanged."""
    js = J.SwitchMemory(2, 64)
    assert js.reserve(1, 80)
    js.addto(np.arange(0, 80, 3), np.arange(27, dtype=np.int32) * 1000 - 7)
    state = js.state_dict()
    ts = T.SwitchMemory(2, 64, device="cpu")
    ts.reserve(9, 40, device=True)              # segment 0 device-resident
    ts.load_state(T.from_jax_state(state))
    assert isinstance(ts.segments[0].regs, torch.Tensor)
    assert isinstance(ts.segments[1].regs, np.ndarray)
    back = T.to_jax_state(ts.state_dict())
    assert back["partitions"] == state["partitions"]
    for a, b in zip(back["regs"], state["regs"]):
        np.testing.assert_array_equal(a, b)
    js2 = J.SwitchMemory(2, 64)
    js2.load_state(back)
    np.testing.assert_array_equal(js2.get(np.arange(128)),
                                  js.get(np.arange(128)))


def test_switch_geometry_and_device_default():
    with pytest.raises(ValueError, match="geometry"):
        T.SwitchMemory(2, 64, device="cpu").load_state(
            T.from_jax_state(J.SwitchMemory(3, 64).state_dict()))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            T.SwitchMemory(2, 64)
