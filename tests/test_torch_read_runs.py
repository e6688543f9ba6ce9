"""The multi-segment reply: ``SwitchMemory.read_f32`` over several
segments, whose contiguous device runs come back in one launch of
``fused_gpv.fused_read_runs``.

CPU lane: a ``device="cpu"`` switch of the port and the JAX package's
``SwitchMemory`` (its Pallas kernels in interpret mode) reach the same
state from seeded numpy transmits at precision 8: sentinel registers,
2**30, -2**31 and values that saturate. ``read_f32`` must then return
bitwise equal values, and equal raw registers, on both, with and without
``need_raw``. The cases cover a reply that ends mid-segment, unaligned
starts and more runs than one launch table holds (the runs kernel), a
reply not sorted by segment, device segments mixed with host segments and
a device segment whose slots are not contiguous (``get`` and the host
dequantize), and a reply in one segment (the single-run kernel). The
port's wrapper counts its plain calls, one per launch it stands in for,
which pins the route each case takes. A stress test reads while other
threads transmit to overlapping segments.

CUDA lane (marker ``cuda``, skipped without a card): the same cases on a
switch on the card against the same calls on a CPU switch, with their
launch counts, and the kernel against its plain version at the path's
segment size. The card's machine has no JAX, so the JAX package is
imported only inside the CPU-lane tests.
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
SCALE = 10 ** 8     # precision 8: 30.0 quantizes past the int32 range
MAX_RUNS = fused_gpv.MAX_RUNS
SENTINELS = (2 ** 31 - 1, -(2 ** 31 - 1))
REG_EDGES = SENTINELS + (2 ** 30, -2 ** 31)


def _phys(runs):
    """Physical slots of ``(segment, first slot, length)`` runs, in order."""
    return np.concatenate([np.arange(s * SEG + a, s * SEG + a + n)
                           for s, a, n in runs]).astype(np.int64)


def _case(name):
    """(partitions as (gaid, slots, device), the reply's physical slots,
    the route the port takes and its plain fused_read calls a read)."""
    if name == "ends_mid_segment":
        # a 7-segment partition after a 10-slot one: its reply starts at
        # slot 10 of segment 0 and ends at slot 5 of segment 6
        parts = [(1, 10, False), (2, 6 * SEG - 10 + 6, True)]
        return parts, np.arange(10, 6 * SEG + 6), "runs", 1
    if name == "unaligned_starts":
        runs = [(0, 17, 40), (1, 3, 61), (2, 0, 1), (3, 63, 1), (4, 5, 59),
                (5, 1, 62), (6, 31, 2)]
        return [(1, 7 * SEG, True)], _phys(runs), "runs", 1
    if name == "past_run_table":
        n_runs = MAX_RUNS + 9
        runs = [(s, s % 7, SEG - 7) for s in range(n_runs)]
        return [(1, n_runs * SEG, True)], _phys(runs), "runs", 2
    if name == "unsorted_reply":
        runs = [(4, 5, 50), (1, 3, 61), (6, 0, 64), (0, 17, 40), (3, 2, 9)]
        return [(1, 7 * SEG, True)], _phys(runs), "get", 0
    if name == "device_and_host":
        # segments 0-1 host, 2-5 device, 6-7 host, every one a run
        runs = [(0, 3, 60), (1, 0, 64), (2, 7, 50), (3, 0, 64), (4, 0, 64),
                (5, 1, 30), (6, 0, 64), (7, 9, 20)]
        parts = [(1, 2 * SEG, False), (2, 4 * SEG, True), (3, 2 * SEG, False)]
        return parts, _phys(runs), "get", 0
    if name == "gap_in_segment":
        # every segment a device one, segment 2's slots not contiguous
        runs = [(0, 3, 61), (1, 0, 64), (2, 0, 20), (2, 21, 40), (3, 0, 9)]
        return [(1, 4 * SEG, True)], _phys(runs), "get", 0
    if name == "one_segment":
        return [(1, 3 * SEG, True)], _phys([(1, 5, 50)]), "single", 1
    raise ValueError(name)


CASES = ("ends_mid_segment", "unaligned_starts", "past_run_table",
         "unsorted_reply", "device_and_host", "gap_in_segment",
         "one_segment")


def _state(case):
    """Registers to start from (sentinels and edges among them) and two
    fp32 transmits over the reply's slots: ordinary values, halfway cases,
    and values that saturate at SCALE alone or when two meet. Four slots
    of the reply hold the edges and get zeros, so the read sees each."""
    rng = np.random.RandomState(sum(map(ord, case)))
    regs = rng.randint(-10 ** 8, 10 ** 8, (N_SEGMENTS, SEG)).astype(np.int64)
    pick = rng.rand(N_SEGMENTS, SEG)
    for i, edge in enumerate(REG_EDGES):
        regs[(pick >= 0.02 * i) & (pick < 0.02 * (i + 1))] = edge
    _, phys, _, _ = _case(case)
    kept = rng.choice(len(phys), len(REG_EDGES), replace=False)
    seg, slot = np.divmod(phys[kept], SEG)
    regs[seg, slot] = REG_EDGES
    streams = []
    for _ in range(2):
        f = (rng.randn(len(phys)) * 0.05).astype(np.float32)
        pos = rng.choice(len(phys), 10, replace=False)
        f[pos] = np.float32([0.5e-8, 1.5e-8, -2.5e-8, 30.0, -30.0, 12.0,
                             -12.0, 21.47483647, 2.0 ** 31 / 1e8, 15.0])
        f[kept] = 0.0
        streams.append(f)
    return regs.astype(np.int32), phys, streams


def _switch(make, case, regs):
    """A switch with the case's partitions, each segment starting from
    ``regs`` in its own residency (numpy, tensor or jax array)."""
    parts, _, _, _ = _case(case)
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


def _torch_read(case, device, need_raw, monkeypatch):
    """(values as numpy, raw, plain fused_read calls, launches, calls of the
    runs dispatcher) of the case's read on a port switch on ``device``."""
    regs, phys, streams = _state(case)
    sw = _switch(lambda *g: TSwitch(*g, device=device), case, regs)
    for f in streams:
        sw.addto_f32(phys, f, SCALE)
    runs_calls = []
    real = ops.device_read_dense_runs
    monkeypatch.setattr(ops, "device_read_dense_runs",
                        lambda *a, **k: runs_calls.append(1) or real(*a, **k))
    ops.reset_counts()
    vals, raw = sw.read_f32(phys, SCALE, need_raw=need_raw)
    plain = ops.plain_counts()["fused_read"]
    launches = ops.launch_counts()["fused_read"]
    assert vals.dtype == torch.float32 and vals.device.type == sw.device.type
    return vals.cpu().numpy(), raw, plain, launches, len(runs_calls)


@pytest.mark.parametrize("need_raw", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_read_f32_multi_segment_matches_jax(case, need_raw, monkeypatch):
    from repro.core.inc_map import SwitchMemory as JSwitch
    regs, phys, streams = _state(case)
    jsw = _switch(JSwitch, case, regs)
    for f in streams:
        jsw.addto_f32(phys, f, SCALE)
    want, want_raw = jsw.read_f32(phys, SCALE, need_raw=need_raw)
    got, got_raw, plain, _, runs_calls = _torch_read(case, "cpu", need_raw,
                                                     monkeypatch)
    want = np.asarray(want)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    if need_raw:
        assert got_raw.dtype == want_raw.dtype == np.int32
        np.testing.assert_array_equal(got_raw, want_raw)
    else:
        assert got_raw is None and want_raw is None
    _, _, route, per_read = _case(case)
    assert plain == per_read and runs_calls == (route == "runs")
    held = jsw.get(phys)
    assert np.isin(REG_EDGES, held).all()   # the reply holds every edge
    assert np.isin(held, SENTINELS).sum() > len(SENTINELS)  # and saturates


# (first slot, length) of each run of a fused_read_runs call, one segment
# of 256 slots a run: phase b's layout (whole segments, the last cut),
# unaligned starts and lengths, and more runs than one launch table holds
RUN_CASES = {
    "seven_segments": [(0, 256)] * 6 + [(0, 77)],
    "unaligned_starts": [(17, 160), (3, 253), (255, 1), (1, 1), (100, 99)],
    "past_run_table": [(r % 7, 37) for r in range(MAX_RUNS + 9)],
}


def _read_runs(rng, layout, n_slots):
    """(int32 registers a run, with sentinels and edges; (run, start, off,
    n) a run, the outputs in order; their total)."""
    regs = rng.randint(-10 ** 9, 10 ** 9, (len(layout), n_slots))
    for r in regs:
        r[rng.choice(n_slots, len(REG_EDGES), replace=False)] = REG_EDGES
    offs = np.cumsum([0] + [n for _, n in layout[:-1]])
    return regs.astype(np.int32), [
        (i, a, int(o), n) for i, ((a, n), o) in enumerate(zip(layout, offs))
    ], sum(n for _, n in layout)


@pytest.mark.parametrize("case", list(RUN_CASES))
def test_fused_read_runs_matches_pallas_run_by_run(case):
    import jax.numpy as jnp
    from repro.kernels.fused_gpv import fused_read_pallas
    rng = np.random.RandomState(len(case))
    regs, runs, m = _read_runs(rng, RUN_CASES[case], 256)
    tregs = [torch.from_numpy(r) for r in regs]
    ops.reset_counts()
    out, mask, raw = fused_gpv.fused_read_runs(
        [(tregs[i], a, o, n) for i, a, o, n in runs], m, SCALE,
        want_raw=True)
    assert ops.plain_counts()["fused_read"] == -(-len(runs) // MAX_RUNS)
    assert out.dtype == torch.float32 and mask.dtype == torch.bool \
        and raw.dtype == torch.int32 and out.shape == (m,)
    for i, a, o, n in runs:
        wv, wm = fused_read_pallas(jnp.asarray(regs[i]), a, n, SCALE,
                                   interpret=True)
        np.testing.assert_array_equal(out[o:o + n].numpy().view(np.int32),
                                      np.asarray(wv).view(np.int32))
        np.testing.assert_array_equal(mask[o:o + n].numpy(), np.asarray(wm))
        np.testing.assert_array_equal(raw[o:o + n].numpy(), regs[i][a:a + n])
    assert mask.any()


def test_fused_read_runs_rejects_bad_arguments():
    a = torch.arange(8, dtype=torch.int32)
    with pytest.raises(ValueError):             # no run
        fused_gpv.fused_read_runs([], 0, 1)
    with pytest.raises(ValueError, match="tile"):      # a gap
        fused_gpv.fused_read_runs([(a, 0, 0, 3), (a, 3, 4, 3)], 7, 1)
    with pytest.raises(ValueError, match="tile"):      # outputs overlap
        fused_gpv.fused_read_runs([(a, 0, 0, 3), (a, 3, 2, 3)], 5, 1)
    with pytest.raises(ValueError, match="tile"):      # one inside another
        fused_gpv.fused_read_runs([(a, 0, 0, 4), (a, 0, 2, 1)], 4, 1)
    with pytest.raises(ValueError, match="tile"):      # short of m
        fused_gpv.fused_read_runs([(a, 0, 0, 3)], 4, 1)
    with pytest.raises(ValueError):             # outputs past m
        fused_gpv.fused_read_runs([(a, 0, 2, 3)], 4, 1)
    with pytest.raises(ValueError):             # slots past the segment
        fused_gpv.fused_read_runs([(a, 6, 0, 3)], 3, 1)
    with pytest.raises(TypeError):
        fused_gpv.fused_read_runs([(a.long(), 0, 0, 3)], 3, 1)
    with pytest.raises(ValueError):             # not contiguous
        fused_gpv.fused_read_runs([(torch.arange(16, dtype=torch.int32)[::2],
                                    0, 0, 3)], 3, 1)
    with pytest.raises(ValueError):             # no kernel, no plain version
        fused_gpv.fused_read_runs([(torch.empty(8, dtype=torch.int32,
                                                device="meta"), 0, 0, 3)],
                                  3, 1)
    # reads of the same slots, outputs out of order, an empty run
    ops.reset_counts()
    out, mask, raw = fused_gpv.fused_read_runs(
        [(a, 4, 3, 4), (a, 0, 0, 3), (a, 0, 7, 0)], 7, 2, want_raw=True)
    assert raw.tolist() == [0, 1, 2, 4, 5, 6, 7]
    assert out.tolist() == [0.0, 0.5, 1.0, 2.0, 2.5, 3.0, 3.5]
    assert not mask.any() and ops.plain_counts()["fused_read"] == 1
    _, _, raw = ops.device_read_dense_runs([(a, 0, 0, 2)], 2, 1)
    assert raw is None and ops.plain_counts()["fused_read"] == 2


def test_concurrent_reads_and_transmits_over_overlapping_segments():
    """Four threads transmit over overlapping ranges of whole segments
    while two read ranges of segments that overlap theirs, some reads not
    sorted by segment: nothing hangs, every read sees each segment whole
    (a transmit adds one value to every slot of it, so a segment read
    mid-transmit would not be uniform), values are the raw registers
    dequantized, and the registers end at the sequential sum."""
    n_seg, writers, per_thread = 12, 4, 25
    sw = TSwitch(n_seg, SEG, device="cpu")
    assert sw.reserve(1, n_seg * SEG, device=True)
    rng = np.random.RandomState(5)
    work = []
    for t in range(writers):
        segs = [(s, 0, SEG) for s in range(2 * t, 2 * t + 6)]
        work.append([(_phys(segs), np.full(6 * SEG, rng.randint(1, 50)
                                           / SCALE, np.float32))
                     for _ in range(per_thread)])
    want = np.zeros(n_seg * SEG, np.int64)
    for jobs in work:
        for phys, f in jobs:
            np.add.at(want, phys, np.rint(f * np.float32(SCALE)).astype(
                np.int64))
    errors, reads = [], []
    stop = threading.Event()

    def transmit(jobs):
        try:
            for phys, f in jobs:
                sw.addto_f32(phys, f, SCALE)
        except Exception as e:          # reported by the main thread
            errors.append(e)

    def read(lo):
        try:
            while not stop.is_set():
                segs = [(s, 0, SEG) for s in range(lo, lo + 5)]
                if len(reads) % 3 == 2:
                    segs = segs[::-1]            # not sorted by segment
                vals, raw = sw.read_f32(_phys(segs), SCALE, need_raw=True)
                reads.append((vals.numpy(), raw))
        except Exception as e:
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=transmit, args=(jobs,), daemon=True)
                for jobs in work]
        readers = [threading.Thread(target=read, args=(lo,), daemon=True)
                   for lo in (1, 6)]
        for th in pool + readers:
            th.start()
        for th in pool:
            th.join(timeout=60)
        stop.set()
        for th in readers:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in pool + readers), "a call hung"
    finally:
        sys.setswitchinterval(old)
    assert errors == [] and len(reads) >= 2
    inv = np.float32(1) / np.float32(SCALE)
    for vals, raw in reads:
        assert (raw.reshape(5, SEG) == raw.reshape(5, SEG)[:, :1]).all()
        np.testing.assert_array_equal(
            vals.view(np.int32), (raw.astype(np.float32) * inv).view(np.int32))
    final, _ = sw.read_f32(np.arange(n_seg * SEG), SCALE)
    np.testing.assert_array_equal(
        final.numpy().view(np.int32),
        (want.astype(np.float32) * inv).view(np.int32))


# -- CUDA lane ----------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("need_raw", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_cuda_read_f32_multi_segment_matches_cpu(cuda, case, need_raw,
                                                 monkeypatch):
    want, want_raw, _, _, _ = _torch_read(case, "cpu", need_raw, monkeypatch)
    got, got_raw, plain, launches, runs_calls = _torch_read(
        case, cuda, need_raw, monkeypatch)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    if need_raw:
        assert got_raw.dtype == np.int32
        np.testing.assert_array_equal(got_raw, want_raw)
    else:
        assert got_raw is None
    _, _, route, per_read = _case(case)
    assert launches == per_read and plain == 0
    assert runs_calls == (route == "runs")


# fused_read_runs at the path's segments (40 000 slots): phase b's layout
# (7 runs, 262 144 values), unaligned starts and lengths, more runs than
# one launch table holds, and a single run
CUDA_RUN_CASES = {
    "phase_b": [(0, 40_000)] * 6 + [(0, 22_144)],
    "unaligned_starts": [(17, 39_983), (3, 20_000), (1, 1), (39_999, 1),
                         (5, 30_027)],
    "past_run_table": [(r % 7, 997) for r in range(MAX_RUNS + 9)],
    "one_run": [(123, 39_000)],
}


@pytest.mark.cuda
@pytest.mark.parametrize("want_raw", [False, True])
@pytest.mark.parametrize("case", list(CUDA_RUN_CASES))
def test_cuda_fused_read_runs_match_plain(cuda, case, want_raw):
    rng = np.random.RandomState(len(case))
    regs, spec, m = _read_runs(rng, CUDA_RUN_CASES[case], 40_000)
    tregs = [torch.from_numpy(r).to(cuda) for r in regs]
    runs = [(tregs[i], a, o, n) for i, a, o, n in spec]
    ops.reset_counts()
    got = fused_gpv.fused_read_runs(runs, m, SCALE, want_raw=want_raw)
    assert ops.launch_counts()["fused_read"] == -(-len(runs) // MAX_RUNS)
    want = fused_gpv.fused_read_runs_plain(runs, m, SCALE, want_raw)
    torch.cuda.synchronize()
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1])
    if want_raw:
        assert torch.equal(got[2], want[2])
    else:
        assert got[2] is None
