"""The train step over several data-parallel ranks (``launch/steps.py``
at ``n_dp > 1``, zero1 and fsdp) against the JAX package: the reference's
``tests/multidevice/md_train_equiv.py`` mirrored on gloo ranks.

The port runs as gloo ranks (``torch.multiprocessing``, spawn) at world 2,
a ``(data, model) = (2, 1)`` mesh, and world 4, ``(pod, data, model) =
(2, 2, 1)``, on reduced qwen2.5-3b at 2 layers, S = 64, a global batch
of 8 in 2 microbatches, precision 7 (md_train_equiv's). The reference
runs at the same meshes in subprocesses with forced host devices, one
a mesh, while the ranks run. Cases: zero1 in all four ``MODES`` and
fsdp in netrpc.

  one step      from the reference's state and tokens, carried across
                rank by rank (``params_from_jax`` / ``opt_from_jax``
                with the program's specs cut each rank's shards); the
                state gathered whole afterwards is held to the
                reference's with ``test_torch_train.py``'s tolerances
                (lr bitwise, loss rtol 2e-4, gnorm rtol 1e-3, m and v
                per leaf within 5e-2 of the norm, masters within 2.5 lr
                and at most 1% more than lr/100 apart, params the bf16
                rounding of the masters);
  three steps   the port alone from its own state, each mode's losses
                held to zero1 xla-psum's at md_train_equiv's bounds
                (atol 1e-3, 2e-2 for netrpc-opt, 2e-3 for fsdp);
  twelve steps  zero1 netrpc: the loss falls;
  modalities    one fsdp netrpc step of the reduced whisper-medium at
                world 2 (its encoder's layers gathered under scope
                "enc") from the reference's state and stub frames: loss
                and gnorm as ``test_torch_train.py`` holds whisper's
                step;
  fp32 chunks   at world 2 with one microbatch, fsdp and zero1 in
                xla-psum end bit for bit in the same state: the gathers'
                backward keeps the reduced chunk in fp32, as the
                reference does (rounded to bf16 it would differ); at one
                rank in the main process the same holds with two
                microbatches for qwen2.5-3b, whisper-medium and
                llama-3.2-vision-90b (fsdp is its mode: ``mproj``
                gathered whole, the ``cross`` gates not scattered);
  checkpoint    the fsdp state after the step, written by the 2 ranks,
                restores in the reference bit for bit; the reference's
                written after its step restores in the port's ranks, in
                the fsdp and the zero1 layout, each shard bit for bit.

The JAX package is imported only inside the tests and the subprocesses,
so the spawned ranks import the port alone. Every gloo group has a
timeout, so a collective issued out of order fails rather than hangs.
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
ARCH, LAYERS, SEQ, BATCH, N_MICRO, PRECISION = "qwen2.5-3b", 2, 64, 8, 2, 7
STEP = 3                          # the one-step comparison's step
N_STEPS, LONG = 3, 12
OPT = dict(warmup_steps=2, total_steps=50)
MESHES = {"2": ((2, 1), ("data", "model")),
          "2x2": ((2, 2, 1), ("pod", "data", "model"))}
MODES = ("xla-psum", "fp32-ring", "netrpc", "netrpc-opt")
CASES = [("fsdp", "netrpc")] + [("zero1", m) for m in MODES]
BASE = ("zero1", "xla-psum")
# the arch of a mesh's one fsdp step with a memory input
EXTRA = {"2": "whisper-medium"}
TIMEOUT = 240


def _world(label: str) -> int:
    return int(np.prod(MESHES[label][0]))


def _case(case) -> str:
    return "-".join(case)


def _wait_for(path: Path, deadline: float) -> None:
    while not path.exists():
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} did not appear")
        time.sleep(0.2)


# -- the port's ranks ---------------------------------------------------------

def _flat_numpy(tree, prefix: str) -> dict:
    from repro_torch.models import api
    return {f"{prefix}/{n.replace('.', '/')}": t.detach().float().numpy()
            for n, t in api.named_leaves(tree)}


def _nested(flat: dict, prefix: str, shapes):
    """Copies of the stored arrays under ``prefix`` in the structure of
    the port's tree ``shapes``, as nested dicts and tuples of numpy (the
    step updates its state in place, and a leaf that is not cut shares
    the array's memory)."""
    from repro_torch.models import api
    return api.plain_tree(shapes, lambda n, _: np.array(flat[
        f"{prefix}/{n.replace('.', '/')}"]))


def _params(init: dict, shapes, prog, mesh):
    """This rank's shards of the reference's stored params (fp32 in the
    file), in the port's dtypes (exact: they were bf16 or fp32)."""
    from repro_torch.models import api
    dtypes = dict((n, t.dtype) for n, t in api.named_leaves(shapes))
    return api.map_named(lambda n, t: t.to(dtypes[n]), api.params_from_jax(
        _nested(init, "params", shapes), "cpu",
        specs=prog.meta["param_specs"], mesh=mesh))


def _opt(init: dict, shapes, prog, mesh) -> dict:
    from repro_torch.models import api
    return api.opt_from_jax({o: _nested(init, f"opt/{o}", shapes)
                             for o in ("master", "m", "v")}, "cpu",
                            specs=prog.meta["opt_specs"], mesh=mesh)


def _torch_rank(rank: int, out_dir: str) -> None:
    import torch.distributed as dist

    from repro_torch import compat
    from repro_torch.checkpoint.store import CheckpointStore
    from repro_torch.configs.base import ShapeConfig, get_arch
    from repro_torch.core.inc_agg import IncAggConfig
    from repro_torch.data import pipeline
    from repro_torch.launch import steps
    from repro_torch.launch.serve import with_layers
    from repro_torch.models import api
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.sharding import rules
    # one thread a rank: four ranks and two JAX processes share the host,
    # and each at the default thread count slows every step ~30 times
    torch.set_num_threads(1)
    out = Path(out_dir)
    deadline = time.monotonic() + TIMEOUT
    cfg = with_layers(get_arch(ARCH).reduced(), LAYERS)
    shape = ShapeConfig("t", seq_len=SEQ, global_batch=BATCH, kind="train")
    dcfg = pipeline.DataConfig(vocab=cfg.vocab, batch=BATCH, seq_len=SEQ,
                               kind="bigram")
    for label in ("2x2", "2"):
        mshape, names = MESHES[label]
        if rank >= _world(label):
            continue
        dist.init_process_group(
            "gloo", init_method=f"file://{out_dir}/store-{label}",
            rank=rank, world_size=_world(label),
            timeout=timedelta(seconds=120))
        try:
            mesh = compat.make_mesh(mshape, names, device="cpu")

            def build(case, arch_cfg=cfg, n_micro=N_MICRO):
                mode, inc_mode = case
                return steps.build_train_step(
                    arch_cfg, shape, mesh,
                    inc=IncAggConfig(mode=inc_mode, precision=PRECISION),
                    opt_cfg=AdamWConfig(**OPT), n_micro=n_micro, mode=mode,
                    device="cpu")

            def gathered(prog, params, opt, m):
                specs = steps.state_specs(prog)
                full = {}
                for k, tree, sp in (("params", params, specs["params"]),
                                    *((f"opt/{o}", opt[o], specs["opt"][o])
                                      for o in ("master", "m", "v"))):
                    full.update(_flat_numpy(api.map_named(
                        lambda n, t: rules.unshard(t, sp[n], mesh), tree), k))
                full.update({f"bf16/{n.replace('.', '/')}":
                             np.bool_(t.dtype == torch.bfloat16)
                             for n, t in api.named_leaves(params)})
                full.update({k: np.float32(float(v)) for k, v in m.items()})
                return full

            # the port alone from its own state: md_train_equiv's runs
            losses = {}
            for case in CASES + [("zero1", "netrpc-long")]:
                long = case[1] == "netrpc-long"
                prog = build(("zero1", "netrpc") if long else case)
                params, opt = steps.init_state(prog, cfg)
                ls = []
                for s in range(LONG if long else N_STEPS):
                    params, opt, m = prog.fn(
                        params, opt, pipeline.make_batch(dcfg, s), s)
                    ls.append(float(m["loss"]))
                losses[_case(case)] = ls

            # one step from the reference's state, rank by rank
            _wait_for(out / f"jax-{label}-init.npz", deadline)
            init = dict(np.load(out / f"jax-{label}-init.npz"))
            shapes = api.param_shapes(cfg)
            for case in CASES:
                prog = build(case)
                params = _params(init, shapes, prog, mesh)
                opt = _opt(init, shapes, prog, mesh)
                params, opt, m = prog.fn(
                    params, opt,
                    {"tokens": torch.from_numpy(init["batch/tokens"])}, STEP)
                full = gathered(prog, params, opt, m)
                if rank == 0:
                    np.savez(out / f"torch-{label}-{_case(case)}.npz", **full)
                if label == "2" and case[0] == "fsdp":
                    CheckpointStore(out / "ckpt-torch").save(
                        STEP, {"params": params, "opt": opt},
                        specs=steps.state_specs(prog), mesh=mesh,
                        async_=False)

            if label not in EXTRA:
                if rank == 0:
                    (out / f"torch-{label}-losses.json").write_text(
                        json.dumps(losses))
                continue

            # fsdp and zero1 in xla-psum, one microbatch: the same state
            for mode in ("zero1", "fsdp"):
                prog = build((mode, "xla-psum"), n_micro=1)
                params, opt = steps.init_state(prog, cfg)
                params, opt, m = prog.fn(params, opt,
                                         pipeline.make_batch(dcfg, 0), 0)
                full = gathered(prog, params, opt, m)
                if rank == 0:
                    np.savez(out / f"torch-{label}-{mode}-one-micro.npz",
                             **full)

            # fsdp with a memory input: the encoder's gather
            _wait_for(out / f"jax-{label}-extra-init.npz", deadline)
            init = dict(np.load(out / f"jax-{label}-extra-init.npz"))
            xcfg = get_arch(EXTRA[label]).reduced()
            prog = build(("fsdp", "netrpc"), xcfg)
            shapes = api.param_shapes(xcfg)
            params = _params(init, shapes, prog, mesh)
            opt = _opt(init, shapes, prog, mesh)
            batch = {k[len("batch/"):]: torch.from_numpy(v)
                     for k, v in init.items() if k.startswith("batch/")}
            for k in batch:
                if k != "tokens":
                    batch[k] = batch[k].to(torch.bfloat16)   # exact
            _, _, m = prog.fn(params, opt, batch, STEP)
            if rank == 0:
                np.savez(out / f"torch-{label}-extra.npz",
                         **{k: np.float32(float(v)) for k, v in m.items()})

            if label == "2":
                # the reference's checkpoint into this rank's shards
                _wait_for(out / "ckpt-jax" / f"step_{STEP:08d}" /
                          "manifest.json", deadline)
                store = CheckpointStore(out / "ckpt-jax")
                for mode in ("fsdp", "zero1"):
                    prog = build((mode, "netrpc"))
                    params, opt = steps.init_state(prog, cfg, seed=1)
                    got = store.restore(STEP, {"params": params, "opt": opt},
                                        specs=steps.state_specs(prog),
                                        mesh=mesh)
                    shards = _flat_numpy(got["params"], "params")
                    for o in ("master", "m", "v"):
                        shards.update(_flat_numpy(got["opt"][o], f"opt/{o}"))
                    np.savez(out / f"torch-restored-{mode}-{rank}.npz",
                             **shards)
            if rank == 0:
                (out / f"torch-{label}-losses.json").write_text(
                    json.dumps(losses))
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


# -- the JAX reference (one subprocess a mesh, forced host devices) ----------

def _ref_cfg():
    from dataclasses import replace

    from repro.configs.base import get_arch
    cfg = get_arch(ARCH).reduced()
    (pat, _), = cfg.pattern_groups
    return replace(cfg, n_layers=LAYERS, pattern_groups=((pat, LAYERS),))


def _flat_jax(tree, prefix: str) -> dict:
    """{"<prefix>/<path>": numpy}, floats as fp32 (bf16 exactly), ints as
    they are."""
    import jax

    def arr(x):
        a = np.asarray(x)
        return a if a.dtype.kind in "iu" else a.astype(np.float32)
    return {prefix + "/" + "/".join(
        str(getattr(k, "key", getattr(k, "idx", k))) for k in p): arr(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _save_init(out: Path, name: str, state, batch) -> None:
    """The state before the step and the inputs, written whole at once
    (the ranks wait for the file)."""
    np.savez(out / f"tmp-{name}", **_flat_jax(state[0], "params"),
             **_flat_jax(state[1], "opt"), **_flat_jax(batch, "batch"))
    os.replace(out / f"tmp-{name}", out / name)


def jax_reference(out_dir: str, label: str) -> None:
    """Every case one step from ``init_state`` at ``label``'s mesh:
    ``jax-<label>-init.npz`` (the state before and the batch) and
    ``jax-<label>-extra-init.npz`` (the same for ``EXTRA[label]``'s fsdp
    step) first, then ``jax-<label>-<case>.npz`` each and
    ``jax-<label>-extra.npz``; at world 2 the fsdp state after its step
    is also saved as a checkpoint."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from repro.checkpoint.store import CheckpointStore
    from repro.configs.base import ShapeConfig, get_arch
    from repro.core.inc_agg import IncAggConfig
    from repro.data import pipeline
    from repro.launch import steps
    from repro.optim.adamw import AdamWConfig
    out = Path(out_dir)
    shape_, names = MESHES[label]
    mesh = Mesh(np.array(jax.devices()[:_world(label)]).reshape(shape_),
                names)

    def build(cfg, mode, inc_mode):
        return steps.build_train_step(
            cfg, ShapeConfig("t", SEQ, BATCH, "train"), mesh,
            inc=IncAggConfig(mode=inc_mode, precision=PRECISION),
            opt_cfg=AdamWConfig(**OPT), n_micro=N_MICRO, mode=mode,
            donate=False)

    def inputs(cfg):
        dcfg = pipeline.DataConfig(vocab=cfg.vocab, batch=BATCH,
                                   seq_len=SEQ, kind="bigram")
        return pipeline.add_modality_stubs(pipeline.make_batch(dcfg, STEP),
                                           cfg, BATCH)

    cfg = _ref_cfg()
    batch = inputs(cfg)
    state = steps.init_state(build(cfg, *CASES[0]), cfg)
    _save_init(out, f"jax-{label}-init.npz", state, batch)
    if label in EXTRA:
        xcfg = get_arch(EXTRA[label]).reduced()
        xbatch = inputs(xcfg)
        xprog = build(xcfg, "fsdp", "netrpc")
        xstate = steps.init_state(xprog, xcfg)
        _save_init(out, f"jax-{label}-extra-init.npz", xstate, xbatch)
    for mode, inc_mode in CASES:
        prog = build(cfg, mode, inc_mode)
        # init_state's values in this program's shardings (one init, not
        # one a case: the same key draws the same values in any layout)
        o_shard = prog.meta["opt_shardings"]
        params = jax.device_put(state[0], prog.meta["param_shardings"])
        opt = jax.device_put(state[1], {"master": o_shard, "m": o_shard,
                                        "v": o_shard})
        p2, o2, m = prog.fn(params, opt, batch, jnp.int32(STEP))
        np.savez(out / f"jax-{label}-{mode}-{inc_mode}.npz",
                 **_flat_jax(p2, "params"), **_flat_jax(o2, "opt"),
                 **{k: np.float32(v) for k, v in m.items()})
        if label == "2" and mode == "fsdp":
            CheckpointStore(out / "ckpt-jax").save(
                STEP, {"params": p2, "opt": o2}, async_=False)
    if label in EXTRA:
        _, _, m = xprog.fn(*xstate, xbatch, jnp.int32(STEP))
        np.savez(out / f"jax-{label}-extra.npz",
                 **{k: np.float32(v) for k, v in m.items()})
    print("JAX_REFERENCE_DONE")


def _start_jax_reference(out_dir: Path, label: str) -> subprocess.Popen:
    env = dict(os.environ)
    env["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                        "--xla_cpu_multi_thread_eigen=false "
                        "intra_op_parallelism_threads=1")
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        [SRC, str(Path(__file__).parent), env.get("PYTHONPATH", "")])
    code = ("import test_torch_multirank as t; "
            f"t.jax_reference({json.dumps(str(out_dir))}, {label!r})")
    return subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = tmp_path_factory.mktemp("multirank")
    refs = {label: _start_jax_reference(out, label) for label in MESHES}
    try:
        _run_torch_ranks(out)
        for label, ref in refs.items():
            stdout, stderr = ref.communicate(timeout=TIMEOUT)
            assert ref.returncode == 0 and "JAX_REFERENCE_DONE" in stdout, \
                f"JAX reference at {label} failed:\n{stdout}\n{stderr}"
    finally:
        for ref in refs.values():
            if ref.poll() is None:
                ref.kill()
                ref.communicate()
    return out


# -- one step from the reference's state --------------------------------------

def _hold_to_reference(got: dict, want: dict, tag: str) -> None:
    """``test_torch_train.py``'s tolerances (see its docstring)."""
    assert np.float32(got["lr"]).view(np.int32) == \
        np.float32(want["lr"]).view(np.int32), tag
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=2e-4,
                               err_msg=tag)
    np.testing.assert_allclose(got["gnorm"], want["gnorm"], rtol=1e-3,
                               err_msg=tag)
    lr = float(want["lr"])
    names = [k for k in want if k.startswith("params/")]
    assert sorted(k for k in got if k.startswith("params/")) == sorted(names)
    for k in ("m", "v"):
        for n in names:
            key = f"opt/{k}/" + n[len("params/"):]
            err = np.linalg.norm(got[key] - want[key])
            assert err <= 5e-2 * np.linalg.norm(want[key]) + 1e-30, \
                (tag, key)
    d = np.concatenate([np.abs(got[k].astype(np.float64) - want[k]).ravel()
                        for k in want if k.startswith("opt/master/")])
    assert d.max() <= 2.5 * lr, (tag, d.max() / lr)
    assert (d > lr / 100).mean() <= 0.01, tag
    n_diff = n_all = 0
    for n in names:
        # each param is its own master rounded to its dtype
        mine = got["opt/master/" + n[len("params/"):]]
        if got["bf16/" + n[len("params/"):]]:
            mine = torch.from_numpy(mine).bfloat16().float().numpy()
        assert got[n].tobytes() == mine.tobytes(), (tag, n)
        n_diff += int((got[n] != want[n]).sum())
        n_all += want[n].size
    assert n_diff <= 0.01 * n_all, tag


@pytest.mark.parametrize("mesh", list(EXTRA))
def test_fsdp_step_with_memory_matches_reference(results, mesh):
    """whisper-medium at world 2: one fsdp netrpc step from the
    reference's state and stub frames (the encoder's layers gathered
    under scope "enc"), loss and gnorm as ``test_torch_train.py`` holds
    whisper's step."""
    got = dict(np.load(results / f"torch-{mesh}-extra.npz"))
    want = dict(np.load(results / f"jax-{mesh}-extra.npz"))
    tag = f"{EXTRA[mesh]} at {mesh}"
    assert got["lr"].tobytes() == want["lr"].tobytes(), tag
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=2e-4,
                               err_msg=tag)
    np.testing.assert_allclose(got["gnorm"], want["gnorm"], rtol=1e-3,
                               err_msg=tag)


@pytest.mark.parametrize("case", [_case(c) for c in CASES])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_step_matches_reference(results, mesh, case):
    got = dict(np.load(results / f"torch-{mesh}-{case}.npz"))
    want = dict(np.load(results / f"jax-{mesh}-{case}.npz"))
    _hold_to_reference(got, want, f"{case} at {mesh}")


# -- the port alone: md_train_equiv's bounds ------------------------------------

@pytest.mark.parametrize("case", [_case(c) for c in CASES
                                  if c != BASE])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_modes_agree_over_three_steps(results, mesh, case):
    losses = json.loads((results / f"torch-{mesh}-losses.json").read_text())
    ref, got = losses[_case(BASE)], losses[case]
    tol = {"fsdp-netrpc": 2e-3, "zero1-netrpc-opt": 2e-2}.get(case, 1e-3)
    assert len(got) == N_STEPS and np.all(np.isfinite(got))
    assert np.allclose(ref, got, atol=tol), (case, ref, got)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_loss_falls_over_twelve_steps(results, mesh):
    losses = json.loads((results / f"torch-{mesh}-losses.json").read_text())
    longer = losses["zero1-netrpc-long"]
    assert len(longer) == LONG and longer[-1] < longer[0], longer
    # the same run's first steps are the three-step run's
    assert longer[:N_STEPS] == losses["zero1-netrpc"]


# -- checkpoints across packages ------------------------------------------------

def test_port_checkpoint_restores_in_reference(results):
    """The fsdp state after the step at world 2, written by both ranks
    (rank 0 writes the gathered leaves), read by the reference's store
    into its own tree: every leaf equals the port's state."""
    from functools import partial

    import jax

    from repro.checkpoint.store import CheckpointStore
    from repro.models import api as japi
    cfg = _ref_cfg()
    shapes = jax.eval_shape(partial(japi.init_params, cfg=cfg),
                            jax.random.key(0))
    f32 = jax.tree.map(lambda l: jax.ShapeDtypeStruct(l.shape, np.float32),
                       shapes)
    store = CheckpointStore(results / "ckpt-torch")
    assert store.latest_step() == STEP and store.already_applied(STEP)
    got = store.restore(STEP, {"params": shapes,
                               "opt": {"master": f32, "m": f32, "v": f32}})
    flat = {**_flat_jax(got["params"], "params"),
            **_flat_jax(got["opt"], "opt")}
    port = dict(np.load(results / "torch-2-fsdp-netrpc.npz"))
    assert sorted(flat) == sorted(k for k in port
                                  if k.startswith(("params/", "opt/")))
    for k, v in flat.items():
        assert v.tobytes() == port[k].tobytes(), k


@pytest.mark.parametrize("mode", ["fsdp", "zero1"])
def test_reference_checkpoint_restores_in_port(results, mode):
    """The reference's fsdp state after its step at world 2, restored by
    the port's two ranks into the ``mode`` layout: each rank's shard is
    the cut of the stored leaf along its spec, bit for bit."""
    from repro_torch.compat import Mesh
    from repro_torch.launch import steps
    from repro_torch.launch.serve import with_layers
    from repro_torch.configs.base import get_arch
    from repro_torch.models import api
    from repro_torch.sharding import rules
    cfg = with_layers(get_arch(ARCH).reduced(), LAYERS)
    shapes = api.param_shapes(cfg)
    mesh = Mesh(*MESHES["2"], {})
    axes = rules.MeshAxes(("data",))
    dims = steps.scatter_dims_tree(shapes, 2, 1)
    pspecs = rules.param_specs(shapes, axes, mesh, mode)
    ospecs = steps.opt_specs(pspecs, dims, ("data",))
    d = results / "ckpt-jax" / f"step_{STEP:08d}"
    stored = {f"params/{k}": v for k, v in np.load(d / "params.npz").items()}
    stored.update({f"opt/{k}": v for k, v in np.load(d / "opt.npz").items()})
    cut = 0
    for rank in range(2):
        got = dict(np.load(results / f"torch-restored-{mode}-{rank}.npz"))
        assert sorted(got) == sorted(stored)
        for key, full in stored.items():
            name = key.split("/", 1)[1]
            if key.startswith("opt/"):
                name = name.split("/", 1)[1]
            spec = (ospecs if key.startswith("opt/") else pspecs)[
                name.replace("/", ".")]
            want = full
            for dim, entry in enumerate(spec):
                if entry == "data":
                    want = np.split(want, 2, axis=dim)[rank]
                    cut += 1
            assert got[key].tobytes() == want.tobytes(), (mode, rank, key)
    assert cut


def test_fsdp_keeps_the_reduced_chunk_in_fp32(results):
    """World 2, one microbatch, xla-psum: the fsdp gathers' backward
    reduce-scatters each layer's bf16 cotangent into an fp32 chunk and
    adds it to the fp32 accumulator as it is, as the reference's
    ``custom_vjp`` does (JAX keeps its fp32 cotangent for a bf16 chunk);
    zero1 reduce-scatters the same fp32 sums. So the two end in the same
    state bit for bit; a chunk rounded to bf16 (PyTorch's default for a
    backward's output) would not."""
    z = dict(np.load(results / "torch-2-zero1-one-micro.npz"))
    f = dict(np.load(results / "torch-2-fsdp-one-micro.npz"))
    assert sorted(z) == sorted(f)
    for k in z:
        assert z[k].tobytes() == f[k].tobytes(), k


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "whisper-medium",
                                  "llama-3.2-vision-90b"])
def test_fsdp_equals_zero1_on_one_rank(arch):
    """One rank, two microbatches, xla-psum: one fsdp step and one zero1
    step from the same state end in the same state bit for bit (at one
    rank the gather is a copy and its backward the fp32 cotangent)."""
    from repro_torch import compat
    from repro_torch.configs.base import ShapeConfig, get_arch
    from repro_torch.core.inc_agg import IncAggConfig
    from repro_torch.data import pipeline
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import one_rank_group
    from repro_torch.models import api
    from repro_torch.optim.adamw import AdamWConfig
    cfg = get_arch(arch).reduced()
    shape = ShapeConfig("t", seq_len=32, global_batch=4, kind="train")
    batch = pipeline.add_modality_stubs(pipeline.make_batch(
        pipeline.DataConfig(vocab=cfg.vocab, batch=4, seq_len=32,
                            kind="bigram"), STEP), cfg, 4)
    got = {}
    with one_rank_group(torch.device("cpu")):
        mesh = compat.make_mesh((1, 1), ("data", "model"), device="cpu")
        for mode in ("zero1", "fsdp"):
            prog = steps.build_train_step(
                cfg, shape, mesh, inc=IncAggConfig(mode="xla-psum"),
                opt_cfg=AdamWConfig(**OPT), n_micro=2, mode=mode,
                device="cpu")
            params, opt, m = prog.fn(*steps.init_state(prog, cfg), batch,
                                     STEP)
            got[mode] = {**{f"p/{n}": t for n, t in
                            api.named_leaves(params)},
                         **{f"{o}/{n}": t for o in opt for n, t in
                            api.named_leaves(opt[o])},
                         **{k: v.reshape(1) for k, v in m.items()}}
    assert got["zero1"].keys() == got["fsdp"].keys()
    for k, t in got["zero1"].items():
        assert torch.equal(t, got["fsdp"][k]), k
