"""The port's roofline (``repro_torch.roofline``) against the reference's
(``repro.roofline``): ``test_roofline.py``'s cases where the model carries
over (the wire models, the dominant term, bytes by dtype, a loop counted
each time it runs, the dot FLOPs), the counter's views, peak and links,
and the meta lane of the four kernel modules on the step's path, whose
records must be the bytes of PERF.md's bounds. The reference parses HLO;
the port counts the aten and c10d ops of one call on the meta device.
A fake process group runs in a subprocess (its world is process-wide)."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import dequantize as tdequantize
from repro_torch.kernels import flash_attn as tflash
from repro_torch.kernels import inc_agg as tinc
from repro_torch.kernels import quantize as tquantize
from repro_torch.roofline import analysis, flash_model

SRC = Path(__file__).resolve().parents[1] / "src"
N = 6_553_600            # PERF.md §6 rows 6-8: a 25 MiB fp32 bucket


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("kind", ["all-reduce", "all-gather",
                                  "reduce-scatter", "all-to-all",
                                  "collective-permute"])
@pytest.mark.parametrize("group", [1, 2, 4, 16])
def test_wire_models(kind, group):
    """The port's CollectiveOp and the reference's on the same cases."""
    from repro.roofline import analysis as ja
    for out, mult in ((100, 1), (4096, 3)):
        want = ja.CollectiveOp(kind, "c", out_bytes=out, group_size=group,
                               multiplier=mult).wire_bytes
        got = analysis.CollectiveOp(kind, "c", out_bytes=out,
                                    group_size=group,
                                    multiplier=mult).wire_bytes
        assert got == want


def test_dominant_term():
    r = analysis.Roofline(flops=analysis.PEAK_FLOPS, hbm_bytes=0,
                          wire_bytes=0, raw_collective_bytes=0,
                          n_collectives=0)
    assert r.dominant == "compute" and r.compute_s == pytest.approx(1.0)
    r = analysis.Roofline(flops=0, hbm_bytes=analysis.HBM_BW,
                          wire_bytes=analysis.NVLINK_BW + analysis.IB_BW,
                          raw_collective_bytes=0, n_collectives=1,
                          ib_wire_bytes=analysis.IB_BW)
    # a second over NVLink and a second over InfiniBand
    assert r.collective_s == pytest.approx(2.0)
    assert r.dominant == "collective" and r.memory_s == pytest.approx(1.0)
    assert set(r.summary()) >= {
        "flops_per_dev", "hbm_bytes_per_dev", "wire_bytes_per_dev",
        "raw_collective_bytes", "n_collectives", "xla_flops", "xla_bytes",
        "compute_s", "memory_s", "collective_s", "dominant", "per_kind"}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8, torch.int32, torch.float64,
                                   torch.bool])
def test_bytes_by_dtype(dtype):
    """An elementwise op reads both operands and writes its output."""
    a, b = meta(64, 32, dtype=dtype), meta(64, 32, dtype=dtype)
    _, r = analysis.analyze(torch.maximum, a, b)
    size = torch.empty((), dtype=dtype).element_size()
    assert r.hbm_bytes == 3 * 64 * 32 * size
    assert analysis._nbytes((meta(2, 2), meta(4, dtype=torch.bfloat16))) \
        == 16 + 8


def test_loop_counted_each_time():
    """test_roofline.py's while loop of 15 trips: a Python loop of 15
    products is counted 15 times."""
    x, w = meta(128, 256), meta(256, 128)

    def loop(x, w):
        for _ in range(15):
            y = x @ w
        return y
    _, r = analysis.analyze(loop, x, w)
    assert r.flops == 15 * 2 * 128 * 128 * 256
    assert r.hbm_bytes == 15 * 4 * (128 * 256 + 256 * 128 + 128 * 128)
    assert r.n_ops == 15


@pytest.mark.parametrize("case", ["mm", "addmm", "bmm", "baddbmm", "einsum",
                                  "linear", "conv1d", "conv1d_backward"])
def test_dot_flops(case):
    """2 * out * contract for every product, whatever calls it."""
    b, m, k, n = 3, 8, 16, 4
    if case == "mm":
        fn, args, want = torch.mm, (meta(m, k), meta(k, n)), 2 * m * n * k
    elif case == "addmm":
        fn, args = torch.addmm, (meta(n), meta(m, k), meta(k, n))
        want = 2 * m * n * k
    elif case == "bmm":
        fn, args = torch.bmm, (meta(b, m, k), meta(b, k, n))
        want = 2 * b * m * n * k
    elif case == "baddbmm":
        fn, args = torch.baddbmm, (meta(b, m, n), meta(b, m, k),
                                   meta(b, k, n))
        want = 2 * b * m * n * k
    elif case == "einsum":
        fn = lambda x, y: torch.einsum("bmk,bkn->bmn", x, y)  # noqa: E731
        args, want = (meta(b, m, k), meta(b, k, n)), 2 * b * m * n * k
    elif case == "linear":
        fn = torch.nn.functional.linear
        args, want = (meta(b, m, k), meta(n, k), meta(n)), 2 * b * m * n * k
    else:
        # (B, C_in, L) * (C_out, C_in, K) -> (B, C_out, L - K + 1)
        x, w = meta(b, 6, 20), meta(5, 6, 3)
        per = 2 * b * 5 * 18 * 6 * 3
        if case == "conv1d":
            fn, args, want = torch.nn.functional.conv1d, (x, w), per
        else:
            x.requires_grad_(True)
            w.requires_grad_(True)

            def fn(x, w):
                y = torch.nn.functional.conv1d(x, w)
                return torch.autograd.grad(y.sum(), [x, w])
            args, want = (x, w), 3 * per     # forward, dx and dw
    _, r = analysis.analyze(fn, *args)
    assert r.flops == want


def test_views_count_no_bytes():
    x = meta(64, 32)

    def views(x):
        return (x.view(32, 64), x.t(), x.reshape(2048), x.detach(),
                x[::2], x.unsqueeze(0).expand(4, 64, 32), x.view(-1)[:10])
    _, r = analysis.analyze(views, x)
    assert r.hbm_bytes == 0 and r.flops == 0 and r.n_ops > 0
    _, r = analysis.analyze(lambda x: x.t().contiguous(), x)
    assert r.hbm_bytes == 2 * 64 * 32 * 4          # the copy: read, write


def test_peak_counts_arguments_and_frees():
    x = meta(1024)                                  # 4 KiB argument

    def fn(x):
        a = x * 2                                   # +4 KiB
        b = a + 1                                   # +4 KiB: 12 KiB live
        del a                                       # -4 KiB
        return b * 3                                # 12 KiB again
    _, r = analysis.analyze(fn, x)
    assert r.arg_bytes == 4096
    assert r.peak_bytes == 3 * 4096
    # a view shares its storage: no new bytes
    _, r = analysis.analyze(lambda x: x.view(32, 32).t(), x)
    assert r.peak_bytes == 4096


WORLD_CODE = """
import json
import torch
import torch.distributed as dist
from repro_torch.launch import dryrun
from repro_torch.roofline import analysis
dryrun.fake_world(16)
node = dist.new_group(list(range(8)))           # one node: NVLink
pair = dist.new_group([0, 8])                   # two nodes: InfiniBand
four = dist.new_group([0, 1, 2, 3])
x = torch.empty(128, 256, device="meta")        # 131 072 bytes


def ring(x):
    for _ in range(15):
        out = torch.empty_like(x)
        for r in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, x, 1, node),
                dist.P2POp(dist.irecv, out, 7, node)]):
            r.wait()
        x = out
    return x


def rest(x):
    dist.all_reduce(x, group=pair)
    dist.all_gather([torch.empty_like(x) for _ in range(4)], x, group=four)
    part = torch.empty(32, 256, device="meta")
    dist.reduce_scatter_tensor(part, x, group=four)


out = {}
for name, fn in (("ring", ring), ("rest", rest)):
    _, r = analysis.analyze(fn, x)
    out[name] = dict(r.summary())
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def world():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", WORLD_CODE], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_ring_hops_counted_each_time(world):
    """The reference's collective-permute inside a 15-trip while: the
    ring's send of each hop, 15 times, over NVLink (peer in the node)."""
    r = world["ring"]
    b = 128 * 256 * 4
    assert r["per_kind"] == {"collective-permute": 15 * b}
    assert r["n_collectives"] == 15
    assert r["calls"] == {"collective-permute": {
        ",".join(map(str, range(8))): 15}}
    assert r["ib_wire_bytes_per_dev"] == 0
    assert r["collective_s"] == pytest.approx(15 * b / analysis.NVLINK_BW)


def test_collective_wire_bytes_and_links(world):
    r = world["rest"]
    b = 128 * 256 * 4
    assert r["per_kind"]["all-reduce"] == 2 * b * 0.5       # g = 2
    assert r["per_kind"]["all-gather"] == 512 * 256 * 4 * 0.75
    assert r["per_kind"]["reduce-scatter"] == 32 * 256 * 4 * 3
    assert r["n_collectives"] == 3
    # the pair spans two nodes: its all-reduce goes over InfiniBand
    assert r["ib_wire_bytes_per_dev"] == b
    nv = r["wire_bytes_per_dev"] - b
    assert r["collective_s"] == pytest.approx(b / analysis.IB_BW
                                              + nv / analysis.NVLINK_BW)
    # each collective reads and writes its output in HBM
    assert r["hbm_bytes_per_dev"] == 2 * (b + 512 * 256 * 4 + 32 * 256 * 4)


# PERF.md §6's bounds of rows 6, 6b, 7, 8 and 11 (p's shape), in ms
STREAMS = {
    "quantize": (lambda: tquantize.quantize(meta(N), 1e8), tquantize,
                 [((N,), torch.int32)], 0.015650),
    "dequantize": (lambda: tdequantize.dequantize(
        meta(N, dtype=torch.int32), 1e8), tdequantize,
        [((N,), torch.float32), ((N,), torch.bool)], 0.017607),
    "sat_add": (lambda: tinc.sat_add(meta(N, dtype=torch.int32),
                                     meta(N, dtype=torch.int32)),
                tinc.sat_add, [((N,), torch.int32)], 0.023476),
    "sat_add_batch": (lambda: tinc.sat_add_batch(
        meta(40_000, dtype=torch.int32), meta(16, 40_000,
                                              dtype=torch.int32)),
        tinc.sat_add_batch, [((40_000,), torch.int32)], 0.000860),
    "flash_attention": (lambda: tflash.flash_attention(
        meta(4, 416, 16, 64, dtype=torch.bfloat16),
        meta(4, 416, 16, 64, dtype=torch.bfloat16),
        meta(4, 416, 16, 64, dtype=torch.bfloat16)), tflash.flash_attention,
        [((4, 416, 16, 64), torch.bfloat16)], 0.004069),
}


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_meta_lane_records_the_kernels_bytes(name):
    """A meta tensor returns the kernel's shapes and dtypes and records
    one launch of the kernel's bytes (PERF.md's bound); it reaches
    neither the plain version nor the card."""
    call, wrapper, outs, bound_ms = STREAMS[name]
    wrapper = getattr(wrapper, name, wrapper)
    before = (wrapper.launches, wrapper.plain_calls)
    with analysis.Counter() as c:
        got = call()
    got = got if isinstance(got, tuple) else (got,)
    assert [(tuple(t.shape), t.dtype) for t in got] == outs
    assert all(t.device.type == "meta" for t in got)
    rec = c.kernels[name]
    assert rec["launches"] == 1
    assert round(rec["bytes"] / analysis.HBM_BW * 1e3, 6) == bound_ms
    assert (wrapper.launches, wrapper.plain_calls) == before
    # the wrapper's meta lane stands alone: no counter open, no record
    call()
    assert (wrapper.launches, wrapper.plain_calls) == before


def test_flash_meta_lane_keeps_the_kernels_checks():
    q = meta(1, 128, 2, 64)
    with pytest.raises(TypeError, match="bf16"):
        tflash.flash_attention(q, q, q)
    q = meta(1, 128, 2, 96, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="D in"):
        tflash.flash_attention(q, q, q)
    # under grad: kernel 11 with its lse, then the three backward kernels
    q = meta(1, 128, 2, 64, dtype=torch.bfloat16).requires_grad_(True)
    with analysis.Counter() as c:
        o = tflash.flash_attention(q, q, q)
        o.backward(torch.empty_like(o))
    assert {k: v["launches"] for k, v in c.kernels.items()} == dict.fromkeys(
        ("flash_attention",) + flash_model.BWD_KERNELS, 1)
    assert q.grad.shape == q.shape and q.grad.device.type == "meta"
    with pytest.raises(TypeError, match="fp32"):
        tflash.flash_bwd_dq(q, q, q, q, meta(1, 2, 128), meta(1, 2, 128,
                                                              dtype=torch.int32))


def test_flash_work_and_its_tiles():
    """flash_work is PERF.md's count (p's shape: 13 631 488 bytes); the
    tile model re-reads K and V once a q tile and a query head, so it is
    the floor exactly when one tile holds the sequence and KV == H, and
    more past it; a window reads fewer tiles than the full triangle."""
    assert flash_model.flash_work(4, 16, 16, 416, 64, None)[1] == 13_631_488
    for s in (64, 128):
        assert flash_model.call_traffic_bytes(2, 4, 4, s, 64, None) \
            == flash_model.flash_work(2, 4, 4, s, 64, None)[1]
    full = flash_model.call_traffic_bytes(4, 16, 2, 2048, 128, None)
    assert full > flash_model.flash_work(4, 16, 2, 2048, 128, None)[1]
    # 16 q tiles of 128 rows, tile i reads i + 1 key tiles of 128
    assert full == 2 * 4 * 16 * 128 * (2 * 2048 + 2 * 128 * 136)
    assert flash_model.call_traffic_bytes(4, 16, 2, 2048, 128, 256) < full
    # D = 256: 64-key tiles
    assert flash_model.block_n(256) == 64


def test_flash_bwd_work_and_its_kernels():
    """The backward's floor is five products over the kept pairs, 2.5
    times the forward's; its bytes are q, k, v, o, dO, lse and delta read
    and dq, dk, dv written once. Kernels (b) and (c) do four and three of
    the products, and each reads its own inputs once."""
    case = (2, 16, 2, 1024, 128, None)
    fwd = flash_model.flash_work(*case)
    bwd = flash_model.flash_bwd_work(*case)
    assert bwd[0] * 2 == fwd[0] * 5
    b, h, kv, s, d, _ = case
    assert bwd[1] == 2 * b * s * d * (4 * h + 4 * kv) + 8 * b * h * s
    work = {n: flash_model.bwd_kernel_work(n, *case)
            for n in flash_model.BWD_KERNELS}
    assert work["flash_bwd_dkdv"][0] == 2 * fwd[0]
    assert work["flash_bwd_dq"][0] * 2 == 3 * fwd[0]
    assert work["flash_bwd_delta"][1] == 2 * 2 * b * s * h * d + 4 * b * h * s
    # windowed: the kept pairs of the band
    win = flash_model.flash_bwd_work(2, 16, 2, 1024, 128, 256)
    assert win[0] * 2 == flash_model.flash_work(2, 16, 2, 1024, 128,
                                                256)[0] * 5
    with pytest.raises(ValueError):
        flash_model.bwd_kernel_work("flash_bwd_x", *case)


@pytest.mark.parametrize("name", flash_model.BWD_KERNELS)
def test_meta_lane_records_the_backward_kernels(name):
    """Each backward wrapper on meta tensors returns its outputs' shapes
    and records one launch of its kernel's own floor
    (``flash_model.bwd_kernel_work``), launching nothing."""
    b, h, kv, s, d, w = 2, 16, 2, 1024, 128, 256
    q = meta(b, s, h, d, dtype=torch.bfloat16)
    k = meta(b, s, kv, d, dtype=torch.bfloat16)
    lse, delta = meta(b, h, s), meta(b, h, s)
    wrapper = getattr(tflash, name)
    before = (wrapper.launches, wrapper.plain_calls)
    with analysis.Counter() as c:
        if name == "flash_bwd_delta":
            got = (wrapper(q, q),)
            outs = [((b, h, s), torch.float32)]
        elif name == "flash_bwd_dkdv":
            got = wrapper(q, k, k, q, lse, delta, True, w)
            outs = [((b, s, kv, d), torch.bfloat16)] * 2
        else:
            got = (wrapper(q, k, k, q, lse, delta, True, w),)
            outs = [((b, s, h, d), torch.bfloat16)]
    assert [(tuple(t.shape), t.dtype) for t in got] == outs
    rec = c.kernels[name]
    assert rec["launches"] == 1
    assert (rec["flops"], rec["bytes"]) == flash_model.bwd_kernel_work(
        name, b, h, kv, s, d, None if name == "flash_bwd_delta" else w)
    assert (wrapper.launches, wrapper.plain_calls) == before


def test_flashed_layers_route_as_the_port():
    from repro_torch.configs.base import SHAPES, get_arch
    g = get_arch("gemma3-27b")
    assert flash_model.flashed_layers(g, g.window) == (10, 0)
    assert flash_model.flashed_layers(g, g.window + 1) == (10, 52)
    assert flash_model.flashed_layers(get_arch("mamba2-780m"), 4096) \
        == (0, 0)
    w = get_arch("whisper-medium")
    assert flash_model.flashed_layers(w, 416) == (24, 0)
    q = get_arch("qwen2.5-3b")
    assert flash_model.flash_traffic_bytes(
        q, SHAPES["decode_32k"], n_dp=16, n_model=16) == 0.0
    # a train step: each microbatch's forward, recompute and backward, at
    # the kernels' records (16 rows a rank in 2 microbatches of 8)
    train = SHAPES["train_4k"]
    one = flash_model.train_call_bytes(8, 1, 1, 4096, 128, None)
    assert one == 2 * flash_model.flash_work(8, 1, 1, 4096, 128, None)[1] \
        + sum(flash_model.bwd_kernel_work(n, 8, 1, 1, 4096, 128, None)[1]
              for n in flash_model.BWD_KERNELS)
    assert flash_model.flash_traffic_bytes(
        q, train, n_dp=16, n_model=16, n_micro=2) == 2 * 36 * one
    got = flash_model.flash_traffic_bytes(q, SHAPES["prefill_32k"],
                                          n_dp=16, n_model=16)
    # 2 rows a rank, 1 query head and the KV head it reads
    assert got == 36 * flash_model.call_traffic_bytes(2, 1, 1, 32_768, 128,
                                                      None)
