"""The slice end to end: typed services through ``IncRuntime`` on both
packages, several rounds from two workers.

The port runs on ``device="cpu"``, the JAX package on its CPU backend.
Replies must be bitwise equal as numpy arrays, and register state
(``state_dict``) and every channel's ``ChannelStats`` equal. The port's
wrappers count the calls each lane sent to its plain version, which pins
the lanes every case reaches.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.api as jinc
import repro_torch.api as tinc
from repro.core.channel import Controller as JController
from repro.core.inc_map import SwitchMemory as JSwitch
from repro_torch.core.channel import Controller as TController
from repro_torch.core.inc_map import SwitchMemory as TSwitch
from repro_torch.core.inc_map import to_jax_state
from repro_torch.kernels import ops

ROUNDS = 3


def _grad_service(inc, app, device, precision=8):
    @inc.service(app=app, drain=inc.DrainPolicy(max_batch=2, max_delay=30.0,
                                                eager_window=False))
    class Grad:
        @inc.rpc(request_msg="NewGrad", reply_msg="AgtrGrad")
        def Update(self, tensor: inc.Agg[inc.FPArray](
                precision=precision, clear="copy", device=device)
                ) -> {"tensor": inc.Get[inc.FPArray]}: ...
    return Grad


def _quickstart_service(inc, app):
    @inc.service(app=app, drain=inc.DrainPolicy(max_batch=2, max_delay=30.0,
                                                eager_window=False))
    class Gradient:
        @inc.rpc(request_msg="NewGrad", reply_msg="AgtrGrad",
                 cnt_fwd=inc.CntFwd(to="ALL", threshold=2, key="ClientID"))
        def Update(self, tensor: inc.Agg[inc.FPArray](
                precision=8, clear="copy", device=True)
                ) -> {"tensor": inc.Get[inc.FPArray]}: ...
    return Gradient


def _runtime(pkg, geometry):
    if pkg == "jax":
        return jinc.IncRuntime(controller=JController(
            switch=JSwitch(*geometry)))
    return tinc.IncRuntime(controller=TController(
        switch=TSwitch(*geometry, device="cpu")))


def _reply_np(x):
    if x is None:
        return None
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _drive(pkg, make, grads, n_slots, geometry):
    """Two workers, ROUNDS rounds; returns (replies, jax-layout switch
    state, per-app ChannelStats dicts)."""
    inc = jinc if pkg == "jax" else tinc
    rt = _runtime(pkg, geometry)
    try:
        svc = make(inc)
        stubs = [rt.make_stub(svc, n_slots=n_slots) for _ in range(2)]
        replies = []
        for r in range(len(grads)):
            futs = [s.Update(tensor=grads[r][w])
                    for w, s in enumerate(stubs)]
            replies += [_reply_np(f.result(timeout=60).get("tensor"))
                        for f in futs]
        state = rt.controller.switch.state_dict()
        if pkg == "torch":
            state = to_jax_state(state)
        stats = {ch.netfilter.app_name: dataclasses.asdict(ch.stats)
                 for ch in rt.controller.channels.values()}
        rt.scheduling_report()              # per-channel stats audit
    finally:
        rt.close()
    return replies, state, stats


def _compare(make, grads, n_slots, geometry=(8, 256)):
    ops.reset_counts()
    got = _drive("torch", make, grads, n_slots, geometry)
    counts = ops.plain_counts()
    want = _drive("jax", make, grads, n_slots, geometry)
    for a, b in zip(got[0], want[0]):
        if b is None:
            assert a is None
            continue
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    assert got[1]["partitions"] == want[1]["partitions"]
    for a, b in zip(got[1]["regs"], want[1]["regs"]):
        np.testing.assert_array_equal(a, b)
    assert got[2] == want[2]
    return got[0], counts


def _grads(seed, n, zeros=0.0):
    rng = np.random.RandomState(seed)
    g = (rng.randn(ROUNDS, 2, n) * 0.05).astype(np.float32)
    if zeros:
        g[rng.rand(ROUNDS, 2, n) < zeros] = 0.0
    return g


def test_quickstart_service_cntfwd():
    """CntFwd puts the transmit stream down the int lane: the fused addTo
    never runs, the counters and clears go through sparse_addto, and the
    quorum call's Get takes the fused read."""
    g = _grads(1, 48)
    replies, counts = _compare(lambda inc: _quickstart_service(inc, "QS"),
                               g, n_slots=64)
    assert replies[0] is None             # below the quorum: no reply
    assert counts["fused_addto"] == 0 and counts["fused_scatter"] == 0
    assert counts["sparse_addto"] > 0 and counts["fused_read"] > 0
    scale = np.float32(1e8)
    q = np.rint(g[-1] * scale).astype(np.int64)
    np.testing.assert_array_equal(
        replies[-1], (q[0] + q[1]).astype(np.float32) * (np.float32(1)
                                                         / scale))


@pytest.mark.parametrize("device", [True, False])
def test_gradient_service(device):
    g = _grads(2, 96)
    replies, counts = _compare(
        lambda inc: _grad_service(inc, f"GR-{device}", device), g,
        n_slots=96)
    assert all(r.dtype == (np.float32 if device else np.float64)
               for r in replies)
    if device:
        # round 1 misses and migrates (int lane); hits from round 2 take
        # the fused addTo, and the one-segment replies the fused read
        assert counts["fused_addto"] > 0 and counts["fused_read"] > 0
        assert counts["sparse_addto"] > 0
    else:
        assert counts == {k: 0 for k in counts}   # numpy host kernels


@pytest.mark.parametrize("device", [True, False])
def test_spill_and_regrant(device):
    """A partition half the gradient's size, with sparse gradients: clear
    write-backs skew the LRU counts, re-grants scatter the mapping, and
    the device lane's hits go through the fused scatter."""
    g = _grads(3, 1536, zeros=0.5)         # every call ends an LRU window
    _, counts = _compare(
        lambda inc: _grad_service(inc, f"SP-{device}", device), g,
        n_slots=768, geometry=(8, 1024))
    if device:
        assert counts["fused_scatter"] > 0 and counts["sparse_addto"] > 0


def test_default_geometry_multi_segment_reply():
    """A partition spanning two 40 000-slot segments at the paper's
    geometry: the reply is one call of the fused read over both segments'
    runs and still matches the reference's get + dequantize bit for bit."""
    g = _grads(4, 40_010)[:2]
    _, counts = _compare(lambda inc: _grad_service(inc, "MS", True), g,
                         n_slots=40_010, geometry=(32, 40_000))
    assert counts["fused_read"] == 2 * len(g) and counts["fused_addto"] > 0
