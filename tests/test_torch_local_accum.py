"""The device lane of ``Agg[FPArray](device=True, local_accum=N)`` against
the JAX package.

The same calls go through the JAX ``IncRuntime`` (its fold is the Pallas
``fused_fold_pallas`` in interpret mode) and the port's
``IncRuntime(device="cpu")`` (the plain version of ``fused_fold``).
Replies must be bitwise equal, register state and every channel's
``ChannelStats`` (``local_folds``/``flushes`` included) equal. Within each
package the folded run must also equal the unfolded ``local_accum=1``
oracle where no fold saturates, as ``tests/test_local_accum.py`` pins for
the JAX package.
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

GEOMETRY = (8, 256)


def _service(inc, app, accum, clear="nop", precision=4):
    # no time trigger: the drain points are the calls' own, so both
    # packages batch alike however slow the interpreter is
    @inc.service(app=app, drain=inc.DrainPolicy(max_batch=64,
                                                max_delay=60.0,
                                                eager_window=False))
    class Tensor:
        @inc.rpc(request_msg="NewGrad", reply_msg="AgtrGrad")
        def Update(self, tensor: inc.Agg[inc.FPArray](
                precision=precision, device=True, local_accum=accum,
                clear=clear)
                ) -> {"tensor": inc.Get[inc.FPArray]}: ...
    return Tensor


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _drive(pkg, app, accum, rounds, n_slots, clear="nop", precision=4,
           final_read=True):
    """Issue every round as an async call, drain, then (optionally) one
    zero call whose reply reads the aggregate. Returns (replies, jax-layout
    switch state, per-app ChannelStats dicts)."""
    if pkg == "jax":
        inc = jinc
        rt = jinc.IncRuntime(controller=JController(switch=JSwitch(
            *GEOMETRY)))
    else:
        inc = tinc
        rt = tinc.IncRuntime(controller=TController(switch=TSwitch(
            *GEOMETRY, device="cpu")))
    try:
        stub = rt.make_stub(_service(inc, app, accum, clear, precision),
                            n_slots=n_slots)
        futs = [stub.Update(tensor=x) for x in rounds]
        rt.drain()
        if final_read:
            futs.append(stub.Update(
                tensor=np.zeros_like(rounds[0])))
        replies = [_np(f.result(timeout=60)["tensor"]) for f in futs]
        state = rt.controller.switch.state_dict()
        if pkg == "torch":
            state = to_jax_state(state)
        stats = {ch.netfilter.app_name: dataclasses.asdict(ch.stats)
                 for ch in rt.controller.channels.values()}
        rt.scheduling_report()              # per-channel stats audit
    finally:
        rt.close()
    return replies, state, stats


def _compare(app, accum, rounds, n_slots, **kw):
    ops.reset_counts()
    got = _drive("torch", app, accum, rounds, n_slots, **kw)
    folds = ops.plain_counts()["fused_fold"]
    want = _drive("jax", app, accum, rounds, n_slots, **kw)
    assert len(got[0]) == len(want[0])
    for a, b in zip(got[0], want[0]):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    assert got[1]["partitions"] == want[1]["partitions"]
    for a, b in zip(got[1]["regs"], want[1]["regs"]):
        np.testing.assert_array_equal(a, b)
    assert got[2] == want[2]
    return got, folds


@pytest.mark.parametrize("accum,seed,n_rounds",
                         [(2, 0, 5), (8, 1, 16), (8, 2, 3), (2, 3, 1)])
def test_tensor_lane_matches_jax_and_unfolded_oracle(accum, seed, n_rounds):
    rng = np.random.RandomState(seed)
    rounds = [(rng.randn(32) * 10).astype(np.float32)
              for _ in range(n_rounds)]
    (replies, _, stats), folds = _compare(
        f"LA-T{accum}-{seed}", accum, rounds, n_slots=64)
    assert folds > 0                      # the fold went through fused_fold
    app_stats = stats[f"LA-T{accum}-{seed}"]
    assert app_stats["local_folds"] >= app_stats["flushes"] > 0
    # the folded aggregate equals the unfolded run's, bit for bit
    unfolded, _, _ = _drive("torch", f"LA-T1-{seed}", 1, rounds, n_slots=64)
    assert replies[-1].tobytes() == unfolded[-1].tobytes()


@pytest.mark.parametrize("clear", ["copy", "shadow"])
def test_device_clears_match_jax(clear):
    rng = np.random.RandomState(11)
    rounds = [rng.randn(16).astype(np.float32) for _ in range(8)]
    (replies, _, stats), folds = _compare(f"LA-DC{clear}", 4, rounds,
                                          n_slots=32, clear=clear,
                                          final_read=False)
    assert folds == 2 and stats[f"LA-DC{clear}"]["flushes"] == 2
    # clear: each flush replies with its own cohort's aggregate
    q = np.rint(np.stack(rounds) * np.float32(1e4)).astype(np.int64)
    inv = np.float32(1) / np.float32(1e4)
    for cohort in range(2):
        want = q[4 * cohort:4 * cohort + 4].sum(0).astype(np.float32) * inv
        for r in replies[4 * cohort:4 * cohort + 4]:
            assert r.tobytes() == want.tobytes()


def test_saturating_fold_matches_jax():
    """Rounds whose fold overflows int32: the device lane saturates in the
    fold (the sticky sentinel of fused_fold_pallas), not the exact int64
    sum of the host lane's fold_rounds, in both packages alike."""
    rng = np.random.RandomState(5)
    rounds = [(rng.randn(24) * 10).astype(np.float32) for _ in range(4)]
    for r in rounds:
        r[:4] = [1.2e5, -1.2e5, 2.0e5, -2.0e5]      # 1.2e9 / 2e9 at 10**4
    _, folds = _compare("LA-SAT", 4, rounds, n_slots=32, final_read=False)
    assert folds == 1
    folded = ops.device_fold_rounds(rounds, 10 ** 4, torch.device("cpu"))
    assert folded[:4].tolist() == [2 ** 31 - 1, -(2 ** 31 - 1)] * 2
    exact = ops.fold_rounds([np.rint(r.astype(np.float64) * 1e4)
                             for r in rounds])
    assert abs(int(exact[0])) > 2 ** 31          # the host lane's sum
