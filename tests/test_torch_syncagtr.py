"""The SyncAgtr aggregation of the port (``core/quantize.py``,
``core/ring.py``, ``core/inc_agg.py``) against the JAX package.

Single rank: ``core/quantize.py`` against the JAX one on the same seeded
inputs — exact ints, bitwise fp32, equal masks.

Multi-rank: gloo ranks (``torch.multiprocessing``, spawn) at world sizes
1, 2 and 4 (4 as a ``(pod, data) = (2, 2)`` mesh, and as one ring of four,
whose hops a ring of two cannot order wrongly) run ``all_reduce``,
``reduce_scatter`` and ``all_gather`` in all four modes on per-rank
buffers made from a seed, with 1% of the lanes at +-30.0, which
overflows int32 at ``precision=8``. The JAX package runs the same calls
in ``shard_map`` in a subprocess with four forced host devices.
Tolerances:

  bitwise      fp32-ring, netrpc-opt, every reduce_scatter/all_gather of
               netrpc (its repair is the fp32 ring), and the netrpc
               all-reduce lanes that did not overflow;
  equal        the overflow masks;
  sum-close    the lanes that the netrpc all-reduce repaired with psum,
               and the whole of xla-psum: the order of those fp32 sums
               belongs to the collective library, so |got - want| may
               reach 1e-6 * sum_r |x_r|, the bound of a reordered fp32
               sum of four terms with room to spare.

The JAX package is imported only inside the tests and the subprocess, so
the spawned ranks import the port alone.
"""
import json
import os
import subprocess
import sys
import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest
import torch

SRC = str(Path(__file__).resolve().parents[1] / "src")
L = 2048                        # per-rank bucket: pad_multiple((2, 2), 4)
PRECISION = 8
# label -> (mesh shape, axis names); the world size is the shape's product
MESHES = {"1": ((1,), ("data",)), "2": ((2,), ("data",)),
          "2x2": ((2, 2), ("pod", "data")), "4": ((4,), ("data",))}
MODES = ("xla-psum", "fp32-ring", "netrpc", "netrpc-opt")
STREAMS = (1, 4)
TIMEOUT = 240


def rank_buffers(world: int) -> np.ndarray:
    """(world, L) fp32: N(0, 0.05^2), with 1% of each rank's lanes set to
    +-30.0 (3e9 at precision 8: the quantize sentinel)."""
    rng = np.random.RandomState(2026)
    x = (rng.randn(4, L) * 0.05).astype(np.float32)
    for r in range(4):
        lanes = rng.choice(L, L // 100, replace=False)
        x[r, lanes] = rng.choice([-30.0, 30.0], len(lanes))
    return x[:world]


def _world(label: str) -> int:
    return int(np.prod(MESHES[label][0]))


def _owned_lanes(world: int, streams: int) -> np.ndarray:
    """Lane of the bucket at each place of the rank-major reduce_scatter
    output: rank r holds, per stream, the r-th chunk of that stream."""
    per = L // streams
    c = per // world
    return np.concatenate([s * per + r * c + np.arange(c)
                           for r in range(world) for s in range(streams)])


def _key(mode, streams, what):
    return f"{mode}|{streams}|{what}"


# -- the port's ranks ---------------------------------------------------------

def _torch_rank(rank: int, out_dir: str) -> None:
    """One gloo rank: every mesh it belongs to, each mesh's results
    written to ``out_dir/torch-<label>-<rank>.npz``."""
    import torch.distributed as dist

    from repro_torch import compat
    from repro_torch.core import inc_agg
    for label, (shape, names) in MESHES.items():
        world = _world(label)
        if rank >= world:
            continue
        dist.init_process_group(
            "gloo", init_method=f"file://{out_dir}/store-{label}",
            rank=rank, world_size=world, timeout=timedelta(seconds=120))
        try:
            mesh = compat.make_mesh(shape, names, device="cpu")
            axes = mesh.axes_of(names)
            g = torch.from_numpy(rank_buffers(world)[rank].copy())
            res = {}
            for mode in MODES:
                for ns in STREAMS:
                    cfg = inc_agg.IncAggConfig(mode=mode,
                                               precision=PRECISION,
                                               n_streams=ns)
                    out, mask = inc_agg.all_reduce(g, axes, cfg)
                    res[_key(mode, ns, "ar")] = out.numpy()
                    if mask is not None:
                        res[_key(mode, ns, "mask")] = mask.numpy()
                    chunk = inc_agg.reduce_scatter(g, axes, cfg)
                    res[_key(mode, ns, "rs")] = chunk.numpy()
                    res[_key(mode, ns, "ag")] = inc_agg.all_gather(
                        chunk, axes, cfg).numpy()
            np.savez(f"{out_dir}/torch-{label}-{rank}.npz", **res)
        finally:
            dist.destroy_process_group()


def _run_torch_ranks(out_dir: Path) -> None:
    import torch.multiprocessing as mp
    ctx = mp.start_processes(_torch_rank, args=(str(out_dir),), nprocs=4,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + TIMEOUT
    try:
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                raise TimeoutError(f"gloo ranks still running after "
                                   f"{TIMEOUT} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)


# -- the JAX reference (subprocess with four host devices) --------------------

def jax_reference(out_dir: str) -> None:
    """Every mesh on the first ``world`` of four host devices; one
    ``jax-<label>.npz`` each, results laid out rank-major."""
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from repro import compat
    from repro.core import inc_agg
    for label, (shape, names) in MESHES.items():
        world = _world(label)
        mesh = Mesh(np.array(jax.devices()[:world]).reshape(shape), names)
        spec = P(names)
        x = jax.device_put(rank_buffers(world).reshape(-1),
                           NamedSharding(mesh, spec))

        def smap(f):
            return jax.jit(compat.shard_map(
                f, mesh=mesh, in_specs=spec, out_specs=spec,
                axis_names=set(names), check_vma=False))

        res = {}
        for mode in MODES:
            for ns in STREAMS:
                cfg = inc_agg.IncAggConfig(mode=mode, precision=PRECISION,
                                           n_streams=ns)

                def calls(v, cfg=cfg):
                    out, mask = inc_agg.all_reduce(v, names, cfg)
                    chunk = inc_agg.reduce_scatter(v, names, cfg)
                    return (out, chunk, inc_agg.all_gather(chunk, names, cfg),
                            *(() if mask is None else (mask,)))

                got = [np.asarray(a) for a in smap(calls)(x)]
                for what, a in zip(("ar", "rs", "ag", "mask"), got):
                    res[_key(mode, ns, what)] = a
        np.savez(f"{out_dir}/jax-{label}.npz", **res)
    print("JAX_REFERENCE_DONE")


def _start_jax_reference(out_dir: Path) -> subprocess.Popen:
    """The JAX reference in a subprocess with four forced host devices,
    running while the gloo ranks do."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        [SRC, str(Path(__file__).parent), env.get("PYTHONPATH", "")])
    code = ("import test_torch_syncagtr as t; "
            f"t.jax_reference({json.dumps(str(out_dir))})")
    return subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = tmp_path_factory.mktemp("syncagtr")
    ref = _start_jax_reference(out)
    try:
        _run_torch_ranks(out)
        stdout, stderr = ref.communicate(timeout=TIMEOUT)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0 and "JAX_REFERENCE_DONE" in stdout, \
        f"JAX reference failed:\n{stdout}\n{stderr}"
    got = {}
    for label in MESHES:
        per_rank = [dict(np.load(out / f"torch-{label}-{r}.npz"))
                    for r in range(_world(label))]
        got[label] = {k: np.concatenate([d[k] for d in per_rank])
                      for k in per_rank[0]}
    want = {m: dict(np.load(out / f"jax-{m}.npz")) for m in MESHES}
    return got, want


def _bitwise(a, b, what):
    assert a.dtype == b.dtype and a.shape == b.shape, what
    bad = np.flatnonzero(a.view(np.uint8).reshape(len(a), -1)
                         != b.view(np.uint8).reshape(len(b), -1))
    assert a.tobytes() == b.tobytes(), f"{what}: {len(bad)} bytes differ"


def _sum_close(a, b, mag, what):
    assert a.dtype == b.dtype and a.shape == b.shape, what
    err = np.abs(a.astype(np.float64) - b.astype(np.float64))
    assert np.all(err <= 1e-6 * mag), f"{what}: max err {err.max()}"


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("mode", MODES)
def test_inc_agg_matches_jax(results, mesh, mode):
    got, want = results[0][mesh], results[1][mesh]
    world = _world(mesh)
    x = rank_buffers(world)
    # per lane of the rank-major all-reduce output: sum_r |x_r|
    mag = np.tile(np.abs(x).sum(0), world)
    for ns in STREAMS:
        k = lambda what: _key(mode, ns, what)      # noqa: E731
        tag = f"{mode} n_streams={ns} mesh={mesh}"
        if mode in ("fp32-ring", "netrpc-opt"):
            for what in ("ar", "rs", "ag"):
                _bitwise(got[k(what)], want[k(what)], f"{tag} {what}")
        elif mode == "netrpc":
            mask = want[k("mask")]
            np.testing.assert_array_equal(got[k("mask")], mask)
            assert mask.any() and not mask.all()
            _bitwise(got[k("ar")][~mask], want[k("ar")][~mask], tag)
            _sum_close(got[k("ar")][mask], want[k("ar")][mask], mag[mask],
                       f"{tag} repaired lanes")
            for what in ("rs", "ag"):
                _bitwise(got[k(what)], want[k(what)], f"{tag} {what}")
        else:
            _sum_close(got[k("ar")], want[k("ar")], mag, f"{tag} ar")
            # the owned chunks, rank-major, are one copy of the sum in
            # ownership order, and all_gather gives every rank that copy
            owned = np.abs(x).sum(0)[_owned_lanes(world, ns)]
            _sum_close(got[k("rs")], want[k("rs")], owned, f"{tag} rs")
            _sum_close(got[k("ag")], want[k("ag")], np.tile(owned, world),
                       f"{tag} ag")


def test_overflow_lanes_are_repaired(results):
    """netrpc on the (2, 2) mesh: every lane with a +-30.0 overflows and
    is flagged, and after the repair every lane is the sum, within the
    fixed-point step (4 ranks x 0.5e-8) and fp32 rounding."""
    got = results[0]["2x2"]
    x = rank_buffers(4)
    mask = got[_key("netrpc", 1, "mask")][:L]
    np.testing.assert_array_equal(mask, (np.abs(x) == 30.0).any(0))
    exact = x.astype(np.float64).sum(0)
    err = np.abs(got[_key("netrpc", 1, "ar")][:L] - exact)
    assert np.all(err <= 1e-6 * np.abs(x).sum(0) + 2e-8)


# -- single rank: core/quantize.py --------------------------------------------

@pytest.mark.parametrize("precision", [0, 4, 8])
def test_quantize_dequantize_match_jax(precision):
    import jax.numpy as jnp

    from repro.core import quantize as jq
    from repro_torch.core import quantize as tq
    rng = np.random.RandomState(precision)
    x = (rng.randn(3, 700) * 20).astype(np.float32)
    x[0, :6] = [0.5, 1.5, 2.5, -0.5, 30.0, -30.0]
    x[1, :4] = np.array([2.0 ** 31, -2.0 ** 31, 2.0 ** 32, -2.0 ** 32],
                        np.float32) / np.float32(10.0 ** precision)
    assert tq.precision_scale(precision) == float(
        jq.precision_scale(precision))
    want_q = np.asarray(jq.quantize(jnp.asarray(x), precision))
    got_q = tq.quantize(torch.from_numpy(x), precision)
    assert got_q.dtype == torch.int32
    np.testing.assert_array_equal(got_q.numpy(), want_q)
    wv, wm = jq.dequantize(jnp.asarray(want_q), precision)
    gv, gm = tq.dequantize(got_q, precision)
    _bitwise(gv.numpy().reshape(-1), np.asarray(wv).reshape(-1), "dequant")
    np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
    assert gm.any()


def test_with_fallback_identity_reduce_matches_jax():
    import jax.numpy as jnp

    from repro.core import quantize as jq
    from repro_torch.core import quantize as tq
    rng = np.random.RandomState(3)
    x = (rng.randn(512) * 0.05).astype(np.float32)
    x[::50] = 30.0
    q = np.array(jq.quantize(jnp.asarray(x), 8))
    wv, wm = jq.with_fallback(jnp.asarray(q), jnp.asarray(x), 8,
                              lambda v: v)
    gv, gm = tq.with_fallback(torch.from_numpy(q), torch.from_numpy(x), 8,
                              lambda v: v)
    _bitwise(gv.numpy(), np.asarray(wv), "with_fallback")
    np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
    np.testing.assert_array_equal(gv.numpy()[::50], x[::50])


# -- CUDA lane ----------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_opt_encode_matches_cpu(cuda):
    """netrpc-opt's encode on the card equals the CPU bit for bit (no
    mesh axes: the per-block amax is this rank's own)."""
    from repro_torch.core import inc_agg
    g = torch.from_numpy(rank_buffers(1)[0].copy())
    q_cpu, s_cpu = inc_agg._opt_encode(g, ())
    q_dev, s_dev = inc_agg._opt_encode(g.to(cuda), ())
    assert torch.equal(q_dev.cpu(), q_cpu)
    assert torch.equal(s_dev.cpu().view(torch.int32), s_cpu.view(torch.int32))
    r = inc_agg._opt_decode(q_dev, s_dev).cpu()
    assert torch.equal(r.view(torch.int32),
                       inc_agg._opt_decode(q_cpu, s_cpu).view(torch.int32))
