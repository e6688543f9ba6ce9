"""The device-resident GPV lane of the port against the JAX package.

Mirrors the result tests of ``tests/test_device_path.py``: the same
seeded numpy streams go down the JAX package's device lane (its Pallas
kernels in interpret mode on the CPU) and down the port's on
``device="cpu"`` (the plain PyTorch versions of the kernels). Registers,
replies and channel statistics must be bitwise equal between the two
packages, and each package's device lane must equal its own host lane,
as the reference test asserts.

The reference's tests of its Pallas mode selection (the interpret switch,
its environment override, compiled against interpret) have no
counterpart: the port has no interpret mode.
"""
import numpy as np
import pytest
import torch

import repro_torch.api as tinc
from repro_torch.core import rpc as trpc
from repro_torch.core.inc_map import ServerAgent as TServerAgent
from repro_torch.core.inc_map import SwitchMemory as TSwitch
from repro_torch.core.inc_map import quantize_stream
from repro_torch.core.rpc import NetRPC as TNetRPC
from repro_torch.kernels import fused_gpv

PKGS = ("jax", "torch")


def _pkg(pkg):
    """(api, rpc module, NetRPC factory, ServerAgent, SwitchMemory) of a
    package; the port's on the CPU."""
    if pkg == "jax":
        import repro.api as jinc
        from repro.core import rpc as jrpc
        from repro.core.inc_map import ServerAgent, SwitchMemory
        from repro.core.rpc import NetRPC
        return jinc, jrpc, NetRPC, ServerAgent, SwitchMemory
    return (tinc, trpc, lambda: TNetRPC(device="cpu"), TServerAgent,
            lambda *a: TSwitch(*a, device="cpu"))


def _np(x):
    """A reply (jax array, tensor or numpy) as numpy."""
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _grad_pair(pkg, app, *, precision=6, clear="nop", n_slots=64):
    """(host stub, device stub) of one package over identical schemas
    modulo device=."""
    inc, _, make_rt, _, _ = _pkg(pkg)
    stubs = []
    for device in (False, True):
        @inc.service(app=f"{app}-{'dev' if device else 'host'}")
        class Svc:
            @inc.rpc(request_msg="NewGrad", reply_msg="AgtrGrad")
            def Update(self, tensor: inc.Agg[inc.FPArray](
                    precision=precision, clear=clear, device=device)
                    ) -> {"tensor": inc.Get[inc.FPArray]}: ...
        stubs.append(make_rt().make_stub(Svc, n_slots=n_slots))
    return stubs[0], stubs[1]


def _raw_state(stub, n):
    srv = stub.agents["Update"].server
    return np.asarray(srv.read_batch(np.arange(n, dtype=np.uint32))).tolist()


def _stats(stub):
    srv = stub.agents["Update"].server
    return {"hits": srv.hits, "misses": srv.misses,
            "inc_bytes": srv.inc_bytes, "host_bytes": srv.host_bytes,
            "spill": dict(srv.spill)}


def _same_bits(a, b):
    a, b = _np(a), _np(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


# ---- end-to-end: device lane == host lane, port == reference ---------------

def _registers_and_replies(pkg, precision, clear):
    host, dev = _grad_pair(pkg, f"TDP-eq-{precision}-{clear}",
                           precision=precision, clear=clear, n_slots=48)
    rng = np.random.RandomState(11)
    inv = np.float32(1.0) / np.float32(10.0 ** precision)
    replies = []
    for _ in range(3):
        g = (rng.randn(48) * 5).astype(np.float32)
        r_host = host.Update(tensor=g).result()["tensor"]
        r_dev = dev.Update(tensor=g).result()["tensor"]
        assert _np(r_dev).dtype == np.float32 and _np(r_dev).shape == g.shape
        raw = np.rint(_np(r_host) * 10.0 ** precision).astype(np.int64)
        np.testing.assert_array_equal(_np(r_dev),
                                      raw.astype(np.float32) * inv)
        replies += [r_host, r_dev]
    assert _raw_state(host, 48) == _raw_state(dev, 48)
    assert _stats(host) == _stats(dev)
    return replies, _raw_state(dev, 48), _stats(dev)


@pytest.mark.parametrize("clear", ["nop", "copy"])
@pytest.mark.parametrize("precision", [0, 4, 6])
def test_device_registers_and_replies_match_host(precision, clear):
    got = _registers_and_replies("torch", precision, clear)
    want = _registers_and_replies("jax", precision, clear)
    assert isinstance(got[0][1], torch.Tensor)
    for a, b in zip(got[0], want[0]):
        _same_bits(a, b)
    assert got[1:] == want[1:]


def test_float64_stream_routes_to_host_quantize_and_still_matches():
    """float64 payloads are host-quantized (the fused quantize is fp32),
    and the device registers stay equal to the host lane's, in both
    packages."""
    out = {}
    for pkg in PKGS:
        host, dev = _grad_pair(pkg, "TDP-f64", precision=6, clear="copy",
                               n_slots=32)
        g = np.linspace(-3.0, 3.0, 32, dtype=np.float64) + 1e-9
        for stub in (host, dev):
            stub.Update(tensor=g).result()
        assert _raw_state(host, 32) == _raw_state(dev, 32)
        assert _stats(host) == _stats(dev)
        reply = dev.Update(tensor=np.zeros(32)).result()["tensor"]
        assert _np(reply).dtype == np.float32
        out[pkg] = (_raw_state(dev, 32), _stats(dev), reply)
    assert out["torch"][:2] == out["jax"][:2]
    _same_bits(out["torch"][2], out["jax"][2])


def test_gpv_off_dict_path_equals_device_lane():
    """With GPV marshalling off, per-element dict updates through the int
    addto lane end on the registers of the array-native device path."""
    out = {}
    for pkg in PKGS:
        _, rpc_mod, _, _, _ = _pkg(pkg)
        host, dev = _grad_pair(pkg, "TDP-dict", precision=4, n_slots=16)
        g = np.array([1.25, -2.5, 0.0, 3.75] * 4, np.float32)
        dev.Update(tensor=g).result()
        prev = rpc_mod.set_gpv(False)
        try:
            host.Update(tensor=g).result()
        finally:
            rpc_mod.set_gpv(prev)
        assert _raw_state(host, 16) == _raw_state(dev, 16)
        out[pkg] = _raw_state(dev, 16)
    assert out["torch"] == out["jax"]


def test_empty_batch_both_lanes():
    out = {}
    for pkg in PKGS:
        host, dev = _grad_pair(pkg, "TDP-empty", precision=2, n_slots=8)
        for stub in (host, dev):
            r = stub.Update(tensor=np.zeros(0, np.float32)).result()
            assert len(np.ravel(_np(r["tensor"]))) == 0
        assert _stats(host) == _stats(dev)
        out[pkg] = _stats(dev)
    assert out["torch"] == out["jax"]


# ---- agent-level parity: misses, spill, duplicate addresses ----------------

def _agent(pkg, device, n_slots=8):
    _, _, _, agent, switch = _pkg(pkg)
    return agent(switch(2, 64), gaid=1, n_slots=n_slots, device=device)


@pytest.mark.parametrize("seed", [5, 6, 7])
def test_addto_f32_miss_and_spill_stats_parity(seed):
    """A duplicate-heavy stream over more keys than the partition holds:
    hit/miss routing, spill, byte counters and registers of the device
    lane equal the host lane's, and the port's equal the reference's."""
    rng = np.random.RandomState(seed)
    logs = (rng.zipf(1.4, 300) % 24).astype(np.uint32)
    fvals = (rng.randn(300) * 10).astype(np.float32)
    probe = np.unique(logs)
    out = {}
    for pkg in PKGS:
        agents = {d: _agent(pkg, d) for d in (False, True)}
        for i in range(0, 300, 50):
            for a in agents.values():
                a.addto_batch_f32(logs[i:i + 50], fvals[i:i + 50], 10 ** 4)
        host, dev = agents[False], agents[True]
        assert (host.hits, host.misses) == (dev.hits, dev.misses)
        assert host.inc_bytes == dev.inc_bytes
        assert host.host_bytes == dev.host_bytes
        assert dict(host.spill) == dict(dev.spill)
        np.testing.assert_array_equal(host.read_batch(probe),
                                      dev.read_batch(probe))
        out[pkg] = (dev.hits, dev.misses, dev.inc_bytes, dev.host_bytes,
                    dict(dev.spill), np.asarray(dev.read_batch(probe)))
    assert out["torch"][:5] == out["jax"][:5]
    _same_bits(out["torch"][5], out["jax"][5])


def test_read_batch_dev_fallback_equals_fast_path():
    """read_batch_dev's contiguous fast path and its fallback (a spilled
    key) follow the same reciprocal dequantize, in both packages."""
    out = {}
    inv = np.float32(1.0) / np.float32(10.0 ** 4)
    for pkg in PKGS:
        dev = _agent(pkg, True, n_slots=16)
        fv = np.arange(16, dtype=np.float32) / 3
        dev.addto_batch_f32(np.arange(16, dtype=np.uint32), fv, 10 ** 4)
        logs = np.arange(16, dtype=np.uint32)
        vals, raw = dev.read_batch_dev(logs, 10 ** 4, need_raw=True)
        assert raw is not None
        want_raw = dev.read_batch(logs)
        np.testing.assert_array_equal(raw, want_raw)
        np.testing.assert_array_equal(_np(vals),
                                      want_raw.astype(np.float32) * inv)
        dev.spill_host([(999, 7)])
        probe = np.array([999, 3], np.uint32)
        vals2, _ = dev.read_batch_dev(probe, 10 ** 4)
        np.testing.assert_array_equal(
            _np(vals2), dev.read_batch(probe).astype(np.float32) * inv)
        out[pkg] = (vals, raw, vals2)
    for a, b in zip(out["torch"], out["jax"]):
        _same_bits(a, b)


@pytest.mark.parametrize("seed", range(3))
def test_device_kernel_duplicate_addresses_match_host(seed):
    """Duplicate addresses inside one fused-scatter batch apply in stream
    order: the port's wrapper (its plain version on a CPU tensor) equals
    the Pallas kernel in interpret mode and the host oracle."""
    import jax.numpy as jnp
    from repro.kernels.fused_gpv import fused_scatter_pallas
    regs0 = np.zeros(8, np.int32)
    idx = np.array([3, 3, 5, 3, 5], np.int32)
    fv = np.array([1.5, -0.25, 2.0, 1.0, -2.0], np.float32)
    if seed:
        rng = np.random.RandomState(seed)
        idx = rng.randint(0, 8, 64).astype(np.int32)
        fv = (rng.randn(64) * 3).astype(np.float32)
    want_pallas = np.asarray(fused_scatter_pallas(
        jnp.asarray(regs0), jnp.asarray(idx), jnp.asarray(fv), 100,
        interpret=True))
    got = fused_gpv.fused_scatter(torch.from_numpy(regs0.copy()),
                                  torch.from_numpy(idx),
                                  torch.from_numpy(fv), 100).numpy()
    want = regs0.copy().astype(np.int64)
    for j, v in zip(idx, quantize_stream(fv, 100)):
        want[j] += v
    np.testing.assert_array_equal(got, want.astype(np.int32))
    np.testing.assert_array_equal(got, want_pallas)


# ---- sharded runtime: device channel under concurrent drains ---------------

def _run_sharded(pkg, workers, n=32, rounds=10):
    inc = _pkg(pkg)[0]

    @inc.service(app=f"TDP-shard-{workers}")
    class Svc:
        @inc.rpc(request_msg="NewGrad", reply_msg="AgtrGrad")
        def Update(self, tensor: inc.Agg[inc.FPArray](
                precision=6, clear="copy", device=True)
                ) -> {"tensor": inc.Get[inc.FPArray]}: ...

    kw = {"device": "cpu"} if pkg == "torch" else {}
    rt = inc.IncRuntime(policy=inc.DrainPolicy(
        max_batch=3, max_delay=30.0, eager_window=False), workers=workers,
        **kw)
    try:
        stub = rt.make_stub(Svc, n_slots=n)
        rng = np.random.RandomState(17)
        futs = [stub.Update(tensor=(rng.randn(n) * 2).astype(np.float32))
                for _ in range(rounds)]
        outs = [_np(f.result(timeout=30)["tensor"]).tolist() for f in futs]
        state = _raw_state(stub, n)
        rt.scheduling_report()
        return outs, state
    finally:
        rt.close()


def test_sharded_device_channel_equals_sequential():
    want = _run_sharded("torch", 1)
    assert _run_sharded("torch", 4) == want
    assert _run_sharded("jax", 1) == want


# ---- schema gating ----------------------------------------------------------

def test_device_schema_on_host_channel_raises():
    inc, _, make_rt, _, _ = _pkg("torch")
    rt = make_rt()

    @inc.service(app="TDP-gate", name="Host")
    class HostSvc:
        @inc.rpc(request_msg="N", reply_msg="A")
        def Update(self, tensor: inc.Agg[inc.FPArray](precision=4)
                   ) -> {"tensor": inc.Get[inc.FPArray]}: ...

    @inc.service(app="TDP-gate", name="Dev")
    class DevSvc:
        @inc.rpc(request_msg="N", reply_msg="A")
        def Update(self, tensor: inc.Agg[inc.FPArray](
                precision=4, device=True)
                ) -> {"tensor": inc.Get[inc.FPArray]}: ...

    rt.make_stub(HostSvc, n_slots=16)
    with pytest.raises(ValueError, match="device"):
        rt.make_stub(DevSvc, n_slots=16)
    rt2 = make_rt()
    rt2.make_stub(DevSvc, n_slots=16)
    rt2.make_stub(HostSvc, n_slots=16)


def test_device_option_requires_array_iedt():
    from repro.core.schema import SchemaError as JSchemaError
    from repro_torch.core.schema import SchemaError
    with pytest.raises(SchemaError):
        tinc.Agg[tinc.STRINTMap](device=True)
    import repro.api as jinc
    with pytest.raises(JSchemaError):
        jinc.Agg[jinc.STRINTMap](device=True)


# ---- train-step integration (launch/steps.py) -------------------------------

def test_train_telemetry_gradient_aggregation_device_resident():
    """The telemetry's gradient aggregation keeps the tree, its leaves on
    the switch's device, and the dequantize contract; the port's values
    equal the reference's."""
    import jax.numpy as jnp
    from repro.launch.steps import TrainTelemetry as JTelemetry
    from repro_torch.launch.steps import TrainTelemetry
    w = np.linspace(-1, 1, 12, dtype=np.float32).reshape(3, 4)
    b = np.array([0.5, -0.25, 0.125], np.float32)
    tel = TrainTelemetry(app_prefix="TDP-train", grad_slots=64, device="cpu")
    try:
        out = tel.aggregate_gradients({"w": torch.from_numpy(w),
                                       "b": torch.from_numpy(b)})
    finally:
        tel.rt.close()
    jtel = JTelemetry(app_prefix="TDP-train", grad_slots=64)
    try:
        want = jtel.aggregate_gradients({"w": jnp.asarray(w),
                                         "b": jnp.asarray(b)})
    finally:
        jtel.rt.close()
    assert set(out) == {"w", "b"} and out["w"].shape == (3, 4)
    assert isinstance(out["w"], torch.Tensor)
    inv = np.float32(1.0) / np.float32(10.0 ** 6)
    for k, g in (("w", w), ("b", b)):
        raw = np.rint(g * np.float32(10.0 ** 6)).astype(np.int64)
        np.testing.assert_array_equal(out[k].numpy(),
                                      raw.astype(np.float32) * inv)
        _same_bits(out[k], want[k])
