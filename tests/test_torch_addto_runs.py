"""The multi-segment transmit: ``SwitchMemory.addto_f32`` over several
segments, whose contiguous device runs go down as one launch of
``fused_gpv.fused_addto_runs``.

CPU lane: a ``device="cpu"`` switch of the port against the JAX package's
``SwitchMemory`` (its Pallas kernels in interpret mode) on the same seeded
numpy streams; registers must be bitwise equal. The cases cover a run
that ends mid-segment, unaligned starts, a stream not sorted by segment,
more runs than one launch table holds, and device segments mixed with host
segments and with a device segment whose slots are not contiguous. The
port's wrapper counts its plain calls, one per launch it stands in for,
which pins how many launches each case takes. A stress test transmits
from four threads over overlapping segment ranges.

CUDA lane (marker ``cuda``, skipped without a card): the same cases on a
switch on the card against the same calls on a CPU switch, and the launch
counts. The card's machine has no JAX, so the JAX package is imported
only inside the CPU-lane tests.
"""
import sys
import threading

import numpy as np
import pytest
import torch

from repro_torch.core.inc_map import SwitchMemory as TSwitch
from repro_torch.kernels import fused_gpv, ops

SEG = 64            # slots per segment
N_SEGMENTS = 48
SCALE = 10 ** 4
MAX_RUNS = fused_gpv.MAX_RUNS


def _phys(runs):
    """Physical slots of ``(segment, first slot, length)`` runs, in order."""
    return np.concatenate([np.arange(s * SEG + a, s * SEG + a + n)
                           for s, a, n in runs]).astype(np.int64)


def _case(name):
    """(partitions as (gaid, slots, device), transmits as physical slot
    arrays, launches the port takes per transmit)."""
    if name == "ends_mid_segment":
        # a 7-segment partition after a 10-slot one: its run starts at slot
        # 10 of segment 0 and ends at slot 5 of segment 6
        parts = [(1, 10, False), (2, 6 * SEG - 10 + 6, True)]
        return parts, [np.arange(10, 6 * SEG + 6)], 1
    if name == "unaligned_starts":
        runs = [(0, 17, 40), (1, 3, 61), (2, 0, 1), (3, 63, 1), (4, 5, 59),
                (5, 1, 62), (6, 31, 2)]
        return [(1, 7 * SEG, True)], [_phys(runs)], 1
    if name == "unsorted_stream":
        # the same kind of runs, the segments in no order: the runs'
        # values are gathered before the one copy
        runs = [(4, 5, 50), (1, 3, 61), (6, 0, 64), (0, 17, 40), (3, 2, 9)]
        return [(1, 7 * SEG, True)], [_phys(runs)], 1
    if name == "past_run_table":
        n_runs = MAX_RUNS + 9
        runs = [(s, s % 7, SEG - 7) for s in range(n_runs)]
        return [(1, n_runs * SEG, True)], [_phys(runs)], 2
    if name == "device_and_host":
        # segments 0-1 host, 2-5 device, 6-7 host; segment 4's slots are
        # not contiguous (the fused scatter), the other device segments
        # are runs
        runs = [(0, 3, 60), (1, 0, 64), (2, 7, 50), (3, 0, 64), (5, 1, 30),
                (6, 0, 64), (7, 9, 20)]
        gap = np.array([4 * SEG + 2, 4 * SEG + 9, 4 * SEG + 9, 4 * SEG + 40])
        phys = _phys(runs)
        phys = np.concatenate([phys[phys < 4 * SEG], gap,
                               phys[phys >= 4 * SEG]])
        parts = [(1, 2 * SEG, False), (2, 4 * SEG, True), (3, 2 * SEG, False)]
        return parts, [phys], 1
    raise ValueError(name)


CASES = ("ends_mid_segment", "unaligned_starts", "unsorted_stream",
         "past_run_table", "device_and_host")


def _streams(case, rounds=2):
    """Registers to start from and fp32 transmits: ordinary values,
    halfway cases and values that saturate at SCALE."""
    rng = np.random.RandomState(sum(map(ord, case)))
    regs = rng.randint(-10 ** 6, 10 ** 6, (N_SEGMENTS, SEG)).astype(np.int64)
    regs[rng.rand(N_SEGMENTS, SEG) < 0.02] = 2 ** 31 - 1      # sentinels
    regs[rng.rand(N_SEGMENTS, SEG) < 0.02] = 2 ** 31 - 2 - 50
    _, transmits, _ = _case(case)
    out = []
    for phys in transmits:
        for _ in range(rounds):
            f = (rng.randn(len(phys)) * 20).astype(np.float32)
            pos = rng.choice(len(phys), 12, replace=False)
            f[pos[:6]] = np.float32([0.5, 1.5, -2.5, 2.5e-4, -0.5e-4, 1.5e-4])
            f[pos[6:]] = np.float32([3e5, -3e5, 2.2e5, -2.2e5, 1e5, 4e5])
            out.append((phys, f))
    return regs.astype(np.int32), out


def _switch(make, case, regs):
    """A switch with the case's partitions, each segment starting from
    ``regs`` in its own residency (numpy, tensor or jax array)."""
    parts, _, _ = _case(case)
    sw = make(N_SEGMENTS, SEG)
    for gaid, n, device in parts:
        assert sw.reserve(gaid, n, device=device)
    for seg, r in zip(sw.segments, regs):
        if isinstance(seg.regs, np.ndarray):
            seg.regs = r.copy()
        elif isinstance(seg.regs, torch.Tensor):
            seg.regs = torch.from_numpy(r.copy()).to(seg.regs.device)
        else:
            import jax.numpy as jnp
            seg.regs = jnp.asarray(r)
    return sw


def _regs(sw):
    return np.stack([np.asarray(r.cpu() if isinstance(r, torch.Tensor)
                                else r) for r in sw.state_dict()["regs"]])


def _torch_run(case, device):
    regs, streams = _streams(case)
    sw = _switch(lambda *g: TSwitch(*g, device=device), case, regs)
    ops.reset_counts()
    for phys, f in streams:
        sw.addto_f32(phys, f, SCALE)
    return _regs(sw), ops.launch_counts(), ops.plain_counts()


@pytest.mark.parametrize("case", CASES)
def test_addto_f32_multi_segment_matches_jax(case):
    from repro.core.inc_map import SwitchMemory as JSwitch
    regs, streams = _streams(case)
    jsw = _switch(JSwitch, case, regs)
    for phys, f in streams:
        jsw.addto_f32(phys, f, SCALE)
    got, _, plain = _torch_run(case, "cpu")
    np.testing.assert_array_equal(got, _regs(jsw))
    _, _, per_transmit = _case(case)
    assert plain["fused_addto"] == per_transmit * len(streams)
    assert (got != regs).any()


def test_addto_f32_single_segment_keeps_the_single_run_call(monkeypatch):
    """One segment takes ``device_addto_dense`` (the single-run kernel),
    never the runs dispatcher."""
    sw = TSwitch(4, SEG, device="cpu")
    assert sw.reserve(1, SEG, device=True)
    calls = []
    monkeypatch.setattr(ops, "device_addto_dense_runs",
                        lambda *a: calls.append(a))
    sw.addto_f32(np.arange(3, 50), np.ones(47, np.float32), SCALE)
    assert calls == []
    assert _regs(sw)[0, 3:50].tolist() == [SCALE] * 47


def test_concurrent_transmits_over_overlapping_segments():
    """Four threads, each transmitting over its own range of segments,
    ranges overlapping, some streams not sorted by segment: every
    transmit finishes within the time limit and the registers equal the
    sequential sum (no value saturates, so the order does not matter)."""
    n_seg, threads, per_thread = 12, 4, 25
    sw = TSwitch(n_seg, SEG, device="cpu")
    assert sw.reserve(1, n_seg * SEG, device=True)
    rng = np.random.RandomState(3)
    work = []
    for t in range(threads):
        lo = 2 * t                               # segments [lo, lo + 6)
        jobs = []
        for j in range(per_thread):
            runs = [(s, rng.randint(0, 8), SEG - 8) for s in range(lo, lo + 6)]
            if j % 3 == 2:
                runs = runs[::-1]                # not sorted by segment
            phys = _phys(runs)
            jobs.append((phys, rng.randint(-50, 50, len(phys))
                         .astype(np.float32) / SCALE))
        work.append(jobs)
    want = np.zeros(n_seg * SEG, np.int64)
    for jobs in work:
        for phys, f in jobs:
            np.add.at(want, phys, np.rint(f * np.float32(SCALE)).astype(
                np.int64))
    errors = []

    def transmit(jobs):
        try:
            for phys, f in jobs:
                sw.addto_f32(phys, f, SCALE)
        except Exception as e:          # reported by the main thread
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=transmit, args=(jobs,), daemon=True)
                for jobs in work]
        for th in pool:
            th.start()
        for th in pool:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in pool), "a transmit hung"
    finally:
        sys.setswitchinterval(old)
    assert errors == []
    np.testing.assert_array_equal(_regs(sw).reshape(-1), want)


# -- CUDA lane ----------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_cuda_addto_f32_multi_segment_matches_cpu(cuda, case):
    want, _, _ = _torch_run(case, "cpu")
    got, launches, plain = _torch_run(case, cuda)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got, want)
    _, transmits, per_transmit = _case(case)
    assert launches["fused_addto"] == per_transmit * 2 * len(transmits)
    assert plain["fused_addto"] == 0
