"""The per-leaf SyncAgtr API of the port (``core/inc_agg.py``:
``reduce_scatter_dim``, ``all_gather_dim``, ``all_gather_dim_q8``, the
train step's aggregation) against the JAX package, on the gloo harness of
``test_torch_syncagtr.py``: gloo ranks at world sizes 1, 2 and 4 (as a
``(pod, data) = (2, 2)`` mesh and as one ring of four) on the CPU, and the
JAX package in ``shard_map`` in a subprocess with four host devices.

Each rank holds an (8, 12, 16) fp32 leaf from a seed, with 1% of its
elements at +-30.0 (an int32 overflow at precision 8), scattered and
gathered along each of its three dims in all four modes. Tolerances:

  bitwise     fp32-ring, every all_gather_dim, and the netrpc lanes
              that did not overflow;
  2 ulps      netrpc-opt (rtol 2.4e-7, and 90% of the elements bitwise):
              the reference computes each row's scale, amax / 127, under
              jit, and XLA may compile it as a multiply by 1/127, which
              rounds some rows' scale the other way (measured: one row of
              16, 1 ulp, on one rank along dim 2);
  sum-close   the netrpc lanes that overflowed and the whole of
              xla-psum: the order of those fp32 sums belongs to the
              collective library, so |got - want| may reach 1e-6 *
              sum_r |x_r|. On one rank the overflowed lanes are held to
              the reference's; on several, to the reference's xla-psum
              (the witness), because the port repairs them with an fp32
              reduce-scatter and the reference's repair is not the sum
              (``test_netrpc_repair_is_the_sum``);
  q8          all_gather_dim_q8 of the bf16 leaf: for the same reason
              the reference's scale may round the other way, and an
              element near a rounding midpoint then lands on the next
              int8 step; each element is within one int8 step of its
              row (amax / 127), and 99% are bitwise equal.
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

from test_torch_syncagtr import MESHES, MODES, PRECISION, SRC, TIMEOUT, _world

SHAPE = (8, 12, 16)
DIMS = (0, 1, 2)


def leaf_buffers(world: int) -> np.ndarray:
    """(world, 8, 12, 16) fp32: N(0, 0.05^2), 1% of each rank's elements
    at +-30.0."""
    rng = np.random.RandomState(2027)
    x = (rng.randn(4, *SHAPE) * 0.05).astype(np.float32)
    n = int(np.prod(SHAPE))
    for r in range(4):
        flat = x[r].reshape(-1)
        lanes = rng.choice(n, n // 100, replace=False)
        flat[lanes] = rng.choice([-30.0, 30.0], len(lanes))
    return x[:world]


def _key(mode, dim, what):
    return f"{mode}|{dim}|{what}"


def _torch_rank(rank: int, out_dir: str) -> None:
    import torch
    import torch.distributed as dist

    from repro_torch import compat
    from repro_torch.core import inc_agg
    for label, (shape, names) in MESHES.items():
        world = _world(label)
        if rank >= world:
            continue
        dist.init_process_group(
            "gloo", init_method=f"file://{out_dir}/store-leaf-{label}",
            rank=rank, world_size=world, timeout=timedelta(seconds=120))
        try:
            axes = compat.make_mesh(shape, names,
                                    device="cpu").axes_of(names)
            g = torch.from_numpy(leaf_buffers(world)[rank].copy())
            res = {}
            for dim in DIMS:
                for mode in MODES:
                    cfg = inc_agg.IncAggConfig(mode=mode,
                                               precision=PRECISION)
                    rs = inc_agg.reduce_scatter_dim(g, dim, axes, cfg)
                    res[_key(mode, dim, "rs")] = rs.numpy()
                    res[_key(mode, dim, "ag")] = inc_agg.all_gather_dim(
                        rs, dim, axes, cfg).contiguous().numpy()
                res[_key("q8", dim, "ag")] = inc_agg.all_gather_dim_q8(
                    g.bfloat16(), dim, axes).float().numpy()
            np.savez(f"{out_dir}/torch-leaf-{label}-{rank}.npz", **res)
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


def jax_reference(out_dir: str) -> None:
    """Every mesh on the first ``world`` of four host devices; one
    ``jax-leaf-<label>.npz`` each, results stacked rank-major."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from repro import compat
    from repro.core import inc_agg
    for label, (shape, names) in MESHES.items():
        world = _world(label)
        mesh = Mesh(np.array(jax.devices()[:world]).reshape(shape), names)
        spec = P(names)
        x = jax.device_put(leaf_buffers(world), NamedSharding(mesh, spec))

        def smap(f):
            return jax.jit(compat.shard_map(
                f, mesh=mesh, in_specs=spec, out_specs=spec,
                axis_names=set(names), check_vma=False))

        res = {}
        for dim in DIMS:
            for mode in MODES:
                cfg = inc_agg.IncAggConfig(mode=mode, precision=PRECISION)

                def calls(v, dim=dim, cfg=cfg):
                    rs = inc_agg.reduce_scatter_dim(v[0], dim, names, cfg)
                    ag = inc_agg.all_gather_dim(rs, dim, names, cfg)
                    return rs[None], ag[None]

                rs, ag = smap(calls)(x)
                res[_key(mode, dim, "rs")] = np.asarray(rs)
                res[_key(mode, dim, "ag")] = np.asarray(ag)

            def q8(v, dim=dim):
                out = inc_agg.all_gather_dim_q8(v[0].astype(jnp.bfloat16),
                                                dim, names)
                return out.astype(jnp.float32)[None]
            res[_key("q8", dim, "ag")] = np.asarray(smap(q8)(x))
        np.savez(f"{out_dir}/jax-leaf-{label}.npz", **res)
    print("JAX_REFERENCE_DONE")


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = tmp_path_factory.mktemp("leafagg")
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        [SRC, str(Path(__file__).parent), env.get("PYTHONPATH", "")])
    code = ("import test_torch_leafagg as t; "
            f"t.jax_reference({json.dumps(str(out))})")
    ref = subprocess.Popen([sys.executable, "-c", code], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
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
        per_rank = [dict(np.load(out / f"torch-leaf-{label}-{r}.npz"))
                    for r in range(_world(label))]
        got[label] = {k: np.stack([d[k] for d in per_rank])
                      for k in per_rank[0]}
    want = {m: dict(np.load(out / f"jax-leaf-{m}.npz")) for m in MESHES}
    return got, want


def _owned(a: np.ndarray, dim: int, world: int) -> np.ndarray:
    """Rank r's chunk of ``a`` (full leaf shape) along ``dim``, stacked:
    the rank-major layout of the reduce_scatter outputs."""
    return np.stack(np.split(a, world, axis=dim))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("mode", MODES)
def test_leaf_agg_matches_jax(results, mesh, mode):
    got, want = results[0][mesh], results[1][mesh]
    world = _world(mesh)
    x = leaf_buffers(world)
    for dim in DIMS:
        tag = f"{mode} dim={dim} mesh={mesh}"
        rs, wrs = got[_key(mode, dim, "rs")], want[_key(mode, dim, "rs")]
        ag, wag = got[_key(mode, dim, "ag")], want[_key(mode, dim, "ag")]
        assert rs.shape == wrs.shape and rs.dtype == wrs.dtype, tag
        assert ag.shape == wag.shape == x.shape, tag
        # ownership: rank r holds the r-th chunk of the reduced leaf
        mag = _owned(np.abs(x).sum(0), dim, world)
        if mode == "fp32-ring":
            assert rs.tobytes() == wrs.tobytes(), tag
        elif mode == "netrpc-opt":
            assert np.all(np.abs(rs - wrs) <= 2.4e-7 * np.abs(wrs)), tag
            assert (rs == wrs).mean() >= 0.9, tag
        elif mode == "netrpc":
            ovf = _owned((np.abs(x) == 30.0).any(0), dim, world)
            assert ovf.any() and not ovf.all()
            assert rs[~ovf].tobytes() == wrs[~ovf].tobytes(), tag
            witness = wrs if world == 1 else \
                want[_key("xla-psum", dim, "rs")]
            assert np.all(np.abs(rs - witness)[ovf] <= 1e-6 * mag[ovf]), tag
        else:
            assert np.all(np.abs(rs - wrs) <= 1e-6 * mag), tag
        # all_gather_dim moves bytes: every rank gets the ranks' chunks
        full = np.concatenate(list(rs), axis=dim)
        for r in range(world):
            assert ag[r].tobytes() == full.tobytes(), tag


def test_overflow_lanes_are_repaired_on_one_rank(results):
    """netrpc on one rank (the card's train step): every lane of the
    leaf is its input after the repair, within the fixed-point step.
    Several ranks: ``test_netrpc_repair_is_the_sum``."""
    x = leaf_buffers(1)[0]
    for dim in DIMS:
        full = results[0]["1"][_key("netrpc", dim, "ag")][0]
        assert np.all(np.abs(full - x) <= 0.5e-8 + 1e-7 * np.abs(x)), dim
        ovf = np.abs(x) == 30.0
        assert ovf.any() and full[ovf].tobytes() == x[ovf].tobytes()


@pytest.mark.parametrize("mesh", [m for m in MESHES if _world(m) > 1])
def test_netrpc_repair_is_the_sum(results, mesh):
    """At world 2 and 4 the port's overflowed netrpc lanes are the sum
    over the ranks (the xla-psum result, within sum-close), and the
    reference's are not: its ``reduce_scatter_dim`` psums each rank's
    OWN chunk of its own leaf, masked by its own chunk's overflow lanes
    (reference ``core/inc_agg.py:271-277``), so rank r's repaired lanes
    add chunk r of rank r to chunk s of rank s. The port repairs with an
    fp32 reduce-scatter of the leaf along the same dim, as the flat API
    does (reference lines 146-151)."""
    got, want = results[0][mesh], results[1][mesh]
    world = _world(mesh)
    x = leaf_buffers(world)
    for dim in DIMS:
        tag = f"dim={dim} mesh={mesh}"
        ovf = _owned((np.abs(x) == 30.0).any(0), dim, world)
        mag = _owned(np.abs(x).sum(0), dim, world)
        witness = want[_key("xla-psum", dim, "rs")]
        port = got[_key("netrpc", dim, "rs")]
        ref = want[_key("netrpc", dim, "rs")]
        assert np.all(np.abs(port - witness)[ovf] <= 1e-6 * mag[ovf]), tag
        assert not np.all(np.abs(ref - witness)[ovf] <= 1e-6 * mag[ovf]), \
            tag
        assert port[~ovf].tobytes() == ref[~ovf].tobytes(), tag


@pytest.mark.parametrize("mesh", list(MESHES))
def test_quantized_gather_matches_jax(results, mesh):
    """Every rank's bf16 leaf, taken as its shard, int8-gathered along
    ``dim``: each rank gets the ranks' leaves side by side, each within
    one int8 step of its row."""
    got, want = results[0][mesh], results[1][mesh]
    world = _world(mesh)
    x = leaf_buffers(world)
    for dim in DIMS:
        a, b = got[_key("q8", dim, "ag")], want[_key("q8", dim, "ag")]
        src = np.concatenate(list(x), axis=dim)
        src = torch.from_numpy(src).bfloat16().float().numpy()
        assert a.shape == b.shape == (world,) + src.shape
        rows = np.moveaxis(np.abs(src), dim, 0)
        amax = np.moveaxis(rows.reshape(rows.shape[0], -1).max(1).reshape(
            (-1,) + (1,) * (src.ndim - 1)), 0, dim)
        assert np.all(np.abs(a - b) <= amax / 127.0 * (1 + 1e-6)), dim
        assert (a == b).mean() >= 0.99, dim
        for r in range(world):
            assert np.all(np.abs(a[r] - src) <= amax / 127.0), dim


@pytest.mark.parametrize("shape,dim", [((40, 3, 500), 0), ((40, 3, 500), 1),
                                       ((40, 3, 500), 2), ((7001,), 0)])
def test_quantized_gather_blocks_equal_one_pass(shape, dim, monkeypatch):
    """``all_gather_dim_q8`` over no rank takes the CPU's leaf a block of
    dim-0 slices at a time, dequantizing each block from its fp32 values:
    bit for bit the one-pass form (the reference's expression: the int8
    grid, then times the row's scale, rounded to the leaf's dtype), in
    several blocks along each dim, a ragged last block and a 1-D leaf."""
    from repro_torch.core import inc_agg
    monkeypatch.setattr(inc_agg, "_Q8_CPU_ELEMS", 4096)
    rng = np.random.RandomState(31)
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32)).bfloat16()
    x[(0,) * x.dim()] = 0.0
    y = torch.movedim(x, dim, 0).float()
    amax = y.abs().amax(dim=tuple(range(1, y.dim()))) if y.dim() > 1 \
        else y.abs()
    scale = inc_agg._lead(inc_agg._int8_scale(amax), y.dim())
    q = torch.clamp(torch.round(y / scale), -127, 127).to(torch.int8)
    want = torch.movedim(q.float() * scale, 0, dim).to(x.dtype)
    got = inc_agg.all_gather_dim_q8(x, dim, ())
    assert got.is_contiguous() and torch.equal(got, want)
