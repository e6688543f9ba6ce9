"""Tensor parallelism over the "model" mesh axis (``sharding/tp.py``,
``Ctx.model``, ``launch/steps.py`` at a model axis above 1) against the
JAX package, whose GSPMD places the same collectives.

The port runs as gloo ranks (``torch.multiprocessing``, spawn, one thread
a rank) on ``(data, model)`` meshes of (1, 2), (2, 2) and (1, 4); the
reference runs at the same meshes in subprocesses with forced host
devices, one a mesh, while the ranks run. Reduced configs:

  qwen2.5-3b           ``global``; at model 4 its 4 query heads are cut
                       and its 2 KV heads are not (the mixed case: a rank
                       projects the one KV head its query head reads);
  gemma3-27b           ``local`` and ``global`` (the ring cache);
  moonshot-v1-16b-a3b  ``moe``: the experts' ff cut, the router whole; at
                       model 4 its 2 heads do not split, so the attention
                       runs whole on every rank with no all-reduce;
  grok-1-314b          ``moe`` in fsdp: trained at (2, 2), each layer's
                       gather over the data axis, its TP dims cut; served
                       at (2, 2) and (1, 4), with the plain and the int8
                       (q8) serve gather.

Cases (``TRAINS``, ``SERVES``):

  one step      from the reference's state and tokens, carried across
                rank by rank (``params_from_jax`` / ``opt_from_jax`` with
                the program's specs), the state gathered whole afterwards
                held with ``test_torch_multirank.py``'s tolerances; the
                reference's netrpc step fails under a model axis on a data
                axis of one rank on this JAX (an XLA SPMD check:
                "Cross-partition allreduce must be in (partial) manual
                partitioning mode"), so at (1, 2) and (1, 4) the step is
                xla-psum in both packages, at (2, 2) netrpc;
  three steps   the port alone: netrpc's losses (fsdp's for grok) held to
                zero1 xla-psum's at the same mesh at md_train_equiv's
                bounds (atol 1e-3, 2e-3 for fsdp);
  serve         the prefill program and 2 teacher-forced decode steps of
                the batch-sharded decode program (a batch of 2, a prompt
                of 40, past gemma's reduced window of 32), and at (2, 2)
                the sequence-sharded decode of a batch of 1 from a cache
                cut by ``shard_cache``, and grok's q8 gather (the
                reference's ``REPRO_QUANTIZED_GATHER=1`` set in its process
                while it builds those programs), each step's logits within
                ``LOGIT_TOL`` of the reference's programs at the same mesh;
  checkpoint    at (2, 2): the port's state after its step, written by 4
                ranks, restores in the reference bit for bit; the
                reference's restores into each rank's shard, cut over the
                data and the model axis, bit for bit.

Unit cases: each ``tp`` Function's forward and backward at model 4
against the one-rank sums, cuts and slices; ``make_host_mesh`` with
``shard_of``/``unshard`` round trips at each mesh; the pad columns of
qwen2.5-3b's full vocab (151 936 of 152 064) at model 4, all in the last
rank's shard; ``tp.kv_heads`` and the mixed-KV cache of each rank; no
all-reduce after a ``wo`` that is not cut. The other block types are
``test_torch_tp_families.py``'s.

The JAX package is imported only inside the tests and the subprocesses.
Every gloo group has a timeout.
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

from test_torch_multirank import (_flat_jax, _flat_numpy, _hold_to_reference,
                                  _nested, _save_init, _wait_for)

SRC = str(Path(__file__).resolve().parents[1] / "src")
MESHES = {"1x2": (1, 2), "2x2": (2, 2), "1x4": (1, 4)}
QWEN, GEMMA, MOON, GROK = ("qwen2.5-3b", "gemma3-27b",
                           "moonshot-v1-16b-a3b", "grok-1-314b")
SEQ, BATCH, N_MICRO, PRECISION, STEP, N_STEPS = 32, 4, 2, 7, 3, 3
OPT = dict(warmup_steps=2, total_steps=50)
# mesh -> (arch, mode, the one step's inc mode)
TRAINS = {"1x2": ((QWEN, "zero1", "xla-psum"), (GEMMA, "zero1", "xla-psum"),
                  (MOON, "zero1", "xla-psum")),
          "1x4": ((QWEN, "zero1", "xla-psum"), (MOON, "zero1", "xla-psum")),
          "2x2": ((QWEN, "zero1", "netrpc"), (GROK, "fsdp", "netrpc"))}
SERVES = {"1x2": (QWEN, GEMMA, MOON), "1x4": (QWEN, GEMMA, MOON, GROK),
          "2x2": (QWEN, GROK)}
PROMPT, DEC, SB = 40, 2, 2
SEQ_ARCH = QWEN                       # (2, 2), a batch of 1
Q8_ARCH = GROK                        # fsdp's serve gather in int8
LOGIT_TOL = 2e-2                      # as tests/test_torch_model.py
CKPT_ARCH = QWEN                      # the checkpoint's state, at (2, 2)
TIMEOUT = 600                         # beside the other files' workers


def _world(label: str) -> int:
    return int(np.prod(MESHES[label]))


def _serves(label: str) -> list[tuple[str, str]]:
    """(arch, variant) of each serve case at ``label``: "" the
    batch-sharded decode, "seq" the sequence-sharded one (a batch of 1),
    "q8" the fsdp serve gather in int8."""
    return [(a, "") for a in SERVES[label]] + \
        ([(SEQ_ARCH, "seq")] if label == "2x2" else []) + \
        ([(Q8_ARCH, "q8")] if label in ("2x2", "1x4") else [])


def _tag(arch: str, variant: str) -> str:
    return f"{arch}-{variant}" if variant else arch


def _tokens(vocab: int, b: int) -> np.ndarray:
    return np.random.RandomState(7).randint(
        0, vocab, (b, PROMPT + DEC)).astype(np.int32)


# -- the port's ranks ---------------------------------------------------------

def _reduced(arch):
    from repro_torch.configs.base import get_arch
    return get_arch(arch).reduced()


def _from_file(flat: dict, prefix: str, shapes):
    """The reference's stored tree (fp32 in the file) as the port's full
    tree in its dtypes (exact: they were bf16 or fp32)."""
    from repro_torch.models import api
    dtypes = dict((n, t.dtype) for n, t in api.named_leaves(shapes))
    return api.map_named(lambda n, t: t.to(dtypes[n]), api.params_from_jax(
        _nested(flat, prefix, shapes), "cpu"))


def _train_cases(label, mesh, rank, out, deadline):
    from repro_torch.checkpoint.store import CheckpointStore
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.inc_agg import IncAggConfig
    from repro_torch.data import pipeline
    from repro_torch.launch import steps
    from repro_torch.models import api
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.sharding import rules
    shape = ShapeConfig("t", seq_len=SEQ, global_batch=BATCH, kind="train")

    def build(cfg, mode, inc_mode):
        return steps.build_train_step(
            cfg, shape, mesh,
            inc=IncAggConfig(mode=inc_mode, precision=PRECISION),
            opt_cfg=AdamWConfig(**OPT), n_micro=N_MICRO, mode=mode,
            device="cpu")

    losses = {}
    for arch, mode, inc_mode in TRAINS[label]:
        cfg = _reduced(arch)
        dcfg = pipeline.DataConfig(vocab=cfg.vocab, batch=BATCH, seq_len=SEQ,
                                   kind="bigram")
        # the port alone from its own state
        for case in ((mode, "netrpc"), ("zero1", "xla-psum")):
            prog = build(cfg, *case)
            params, opt = steps.init_state(prog, cfg)
            ls = []
            for s in range(N_STEPS):
                params, opt, m = prog.fn(params, opt,
                                         pipeline.make_batch(dcfg, s), s)
                ls.append(float(m["loss"]))
            losses[f"{arch}/{'-'.join(case)}"] = ls
        # one step from the reference's state
        _wait_for(out / f"jax-{label}-{arch}-init.npz", deadline)
        init = dict(np.load(out / f"jax-{label}-{arch}-init.npz"))
        prog = build(cfg, mode, inc_mode)
        assert prog.meta["n_model"] == MESHES[label][1]
        shapes = api.param_shapes(cfg)
        params = api.shard_tree(_from_file(init, "params", shapes),
                                prog.meta["param_specs"], mesh)
        opt = api.opt_from_jax({o: _nested(init, f"opt/{o}", shapes)
                                for o in ("master", "m", "v")}, "cpu",
                               specs=prog.meta["opt_specs"], mesh=mesh)
        params, opt, m = prog.fn(
            params, opt, {"tokens": torch.from_numpy(init["batch/tokens"])},
            STEP)
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
        if rank == 0:
            np.savez(out / f"torch-{label}-{arch}.npz", **full)
        if label == "2x2" and arch == CKPT_ARCH:
            CheckpointStore(out / "ckpt-torch").save(
                STEP, {"params": params, "opt": opt}, specs=specs,
                mesh=mesh, async_=False)
            # the reference's checkpoint into this rank's shards
            _wait_for(out / "ckpt-jax" / f"step_{STEP:08d}" /
                      "manifest.json", deadline)
            params, opt = steps.init_state(prog, cfg, seed=1)
            got = CheckpointStore(out / "ckpt-jax").restore(
                STEP, {"params": params, "opt": opt}, specs=specs, mesh=mesh)
            shards = _flat_numpy(got["params"], "params")
            for o in ("master", "m", "v"):
                shards.update(_flat_numpy(got["opt"][o], f"opt/{o}"))
            np.savez(out / f"torch-restored-{rank}.npz", **shards)
    if rank == 0:
        (out / f"torch-{label}-losses.json").write_text(json.dumps(losses))


def _serve_cases(label, mesh, rank, out, deadline):
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import steps
    from repro_torch.launch.serve import grow_cache
    from repro_torch.models import api
    for arch, variant in _serves(label):
        seq = variant == "seq"
        cfg = _reduced(arch)
        _wait_for(out / f"jax-{label}-{arch}-serve-params.npz", deadline)
        flat = dict(np.load(out / f"jax-{label}-{arch}-serve-params.npz"))
        full = _from_file(flat, "params", api.param_shapes(cfg))
        b = 1 if seq else SB
        toks = torch.from_numpy(_tokens(cfg.vocab, b))
        total = PROMPT + DEC

        def build(kind, s):
            return steps.build_serve_step(
                cfg, ShapeConfig(kind, seq_len=s, global_batch=b, kind=kind),
                mesh, q8=variant == "q8", flash=False, device="cpu")
        dec = build("decode", total)
        assert dec.meta["seq_sharded"] == seq
        params = api.shard_tree(full, dec.meta["param_specs"], mesh)
        if seq:
            logits, cache = api.prefill(full, cfg,
                                        {"tokens": toks[:, :PROMPT]})
            cache = steps.shard_cache(grow_cache(cache, cfg, b, total), dec)
        else:
            pf = build("prefill", PROMPT)
            logits, cache = pf.fn(params, {"tokens": toks[:, :PROMPT]})
            cache = grow_cache(cache, cfg, b // dec.meta["n_dp"], total)
        every = [logits]
        for i in range(DEC):
            logits, cache = dec.fn(params, toks[:, PROMPT + i], PROMPT + i,
                                   cache)
            every.append(logits)
        got = torch.stack(every).float().numpy()
        np.save(out / f"torch-{label}-{_tag(arch, variant)}-{rank}.npy", got)


def _unit_cases(label, mesh, rank, out):
    """The tp Functions, the mesh's cuts, the pad columns, the mixed-KV
    cache and the uncut wo: rank r's results in ``torch-unit-{label}-r``."""
    from dataclasses import replace

    from repro_torch import compat
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import steps
    from repro_torch.models import api, blocks
    from repro_torch.models.blocks import Ctx
    from repro_torch.sharding import rules, tp
    model = mesh.axes["model"]
    res = {}
    # shard_of / unshard over both axes
    full = torch.arange(8 * 12 * 4, dtype=torch.float32).reshape(8, 12, 4)
    for i, spec in enumerate((rules.P("model"), rules.P(None, "model"),
                              rules.P("data", "model"),
                              rules.P(None, ("data", "model")),
                              rules.P("model", None, "data"))):
        shard = rules.shard_of(full, spec, mesh)
        res[f"shard/{i}"] = shard.numpy()
        res[f"unshard/{i}"] = rules.unshard(shard, spec, mesh).numpy()
    if label != "1x4":
        np.savez(out / f"torch-unit-{label}-{rank}.npz", **res)
        return
    # the Functions, each on this rank's own input and cotangent
    for name, fn, shape, ct_shape in (
            ("from", tp.from_model, (3, 8), (3, 8)),
            ("to", tp.to_model, (3, 8), (3, 8)),
            ("gather", lambda x, ax: tp.gather_model(x, 1, ax), (3, 8),
             (3, 32))):
        g = torch.Generator().manual_seed(rank)
        x = torch.randn(shape, generator=g).requires_grad_(True)
        ct = torch.randn(ct_shape, generator=torch.Generator().manual_seed(
            100 + rank))
        y = fn(x, model)
        y.backward(ct)
        res[f"{name}/y"], res[f"{name}/grad"] = (y.detach().numpy(),
                                                  x.grad.numpy())
    # the pad columns of qwen2.5-3b's full vocab
    cfg = replace(_reduced(QWEN), vocab=151_936)
    emb = api.init_params(0, cfg, device="cpu")["embed"].detach()
    x = torch.randn((2, 3, cfg.d_model),
                    generator=torch.Generator().manual_seed(5)).bfloat16()
    cut = rules.shard_of(emb, rules.P("model"), mesh)
    res["pad/tp"] = api.logits_of({"embed": cut}, cfg, x, model).float()\
        .numpy()
    res["pad/one"] = api.logits_of({"embed": emb}, cfg, x).float().numpy()
    res["pad/rows"] = np.int64(cut.shape[0])
    # the mixed-KV prefill cache, and the whole attention (no all-reduce
    # after a wo that is not cut)
    for arch in (QWEN, MOON):
        cfg = _reduced(arch)
        full = api.init_params(2, cfg, device="cpu")
        prog = steps.build_serve_step(
            cfg, ShapeConfig("p", 16, 2, "prefill"), mesh, flash=False,
            device="cpu")
        toks = torch.from_numpy(_tokens(cfg.vocab, 2)[:, :16])
        _, cache = prog.fn(api.shard_tree(full, prog.meta["param_specs"],
                                          mesh), {"tokens": toks})
        res[f"cache/{arch}/k"] = cache[0]["s0"]["k"].float().numpy()
        _, one = api.prefill(full, cfg, {"tokens": toks})
        res[f"cache/{arch}/one"] = one[0]["s0"]["k"].float().numpy()
        res[f"kv_heads/{arch}"] = np.array(prog.meta["kv_heads"])
        layer = api._layer(full["groups"][0]["s0"], 0)
        mine = api._layer(api.shard_tree(full, prog.meta["param_specs"],
                                         mesh)["groups"][0]["s0"], 0)
        h = torch.randn((2, 16, cfg.d_model),
                        generator=torch.Generator().manual_seed(9)).bfloat16()
        pos = torch.arange(16)
        y_tp, _ = blocks._mixer(mine, "moe" if arch == MOON else "global", h,
                                Ctx(cfg=cfg, positions=pos, model=model))
        y_one, _ = blocks._mixer(layer, "moe" if arch == MOON else "global",
                                 h, Ctx(cfg=cfg, positions=pos))
        res[f"mixer/{arch}/tp"] = y_tp.float().numpy()
        res[f"mixer/{arch}/one"] = y_one.float().numpy()
        res[f"mixer/{arch}/wq_rows"] = np.int64(mine["attn"]["wq"].shape[-2])
    assert compat.axis_size(model) == 4
    np.savez(out / f"torch-unit-{label}-{rank}.npz", **res)


def _torch_rank(rank: int, out_dir: str) -> None:
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    torch.set_num_threads(1)
    out = Path(out_dir)
    deadline = time.monotonic() + TIMEOUT
    # the meshes of every rank first: ranks 2 and 3 then wait for no one
    for label in ("2x2", "1x4", "1x2"):
        if rank >= _world(label):
            continue
        dist.init_process_group(
            "gloo", init_method=f"file://{out_dir}/store-{label}",
            rank=rank, world_size=_world(label),
            timeout=timedelta(seconds=300))
        try:
            mesh = make_host_mesh(model=MESHES[label][1], device="cpu")
            assert mesh.shape == MESHES[label]
            _unit_cases(label, mesh, rank, out)
            _serve_cases(label, mesh, rank, out, deadline)
            _train_cases(label, mesh, rank, out, deadline)
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

def jax_reference(out_dir: str, label: str) -> None:
    """At ``label``'s mesh: each serve arch's weights (``key(0)``) and the
    logits of its prefill and teacher-forced decode programs; each train
    case's state before and its tokens, then its one step; at (2, 2) the
    qwen state after its step as a checkpoint."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from repro.checkpoint.store import CheckpointStore
    from repro.configs.base import ShapeConfig, get_arch
    from repro.core.inc_agg import IncAggConfig
    from repro.data import pipeline
    from repro.launch import steps
    from repro.models import api
    from repro.optim.adamw import AdamWConfig
    out = Path(out_dir)
    mesh = Mesh(np.array(jax.devices()[:_world(label)]).reshape(
        MESHES[label]), ("data", "model"))
    total = PROMPT + DEC
    for arch, variant in _serves(label):
        seq = variant == "seq"
        # the reference reads its q8 switch when it builds a program
        os.environ.pop("REPRO_QUANTIZED_GATHER", None)
        if variant == "q8":
            os.environ["REPRO_QUANTIZED_GATHER"] = "1"
        cfg = get_arch(arch).reduced()
        params = api.init_params(jax.random.key(0), cfg)
        if not variant:
            np.savez(out / "tmp-serve.npz", **_flat_jax(params, "params"))
            os.replace(out / "tmp-serve.npz",
                       out / f"jax-{label}-{arch}-serve-params.npz")
        b = 1 if seq else SB
        toks = jnp.asarray(_tokens(cfg.vocab, b))
        dec = steps.build_serve_step(cfg, ShapeConfig("d", total, b,
                                                      "decode"), mesh)
        p = jax.device_put(params, dec.meta["param_shardings"])
        if seq:
            logits, cache = jax.jit(lambda q, t, _c=cfg: api.prefill(
                q, _c, {"tokens": t}))(params, toks[:, :PROMPT])
        else:
            pf = steps.build_serve_step(cfg, ShapeConfig("p", PROMPT, b,
                                                         "prefill"), mesh)
            logits, cache = pf.fn(p, {"tokens": toks[:, :PROMPT]})
        like = api.cache_specs(cfg, b, total)
        cache = jax.tree.map(lambda c, lk: c if c.shape == lk.shape else
                             jnp.pad(c, [(0, x - y) for y, x in
                                         zip(c.shape, lk.shape)]),
                             cache, like)
        cache = jax.device_put(cache, dec.meta["cache_shardings"])
        every = [logits]
        for i in range(DEC):
            logits, cache = dec.fn(p, toks[:, PROMPT + i],
                                   jnp.int32(PROMPT + i), cache)
            every.append(logits)
        np.save(out / f"jax-{label}-{_tag(arch, variant)}.npy",
                np.stack([np.asarray(x.astype(jnp.float32)) for x in every]))
    os.environ.pop("REPRO_QUANTIZED_GATHER", None)
    for arch, mode, inc_mode in TRAINS[label]:
        cfg = get_arch(arch).reduced()
        prog = steps.build_train_step(
            cfg, ShapeConfig("t", SEQ, BATCH, "train"), mesh,
            inc=IncAggConfig(mode=inc_mode, precision=PRECISION),
            opt_cfg=AdamWConfig(**OPT), n_micro=N_MICRO, mode=mode,
            donate=False)
        batch = pipeline.make_batch(pipeline.DataConfig(
            vocab=cfg.vocab, batch=BATCH, seq_len=SEQ, kind="bigram"), STEP)
        state = steps.init_state(prog, cfg)
        _save_init(out, f"jax-{label}-{arch}-init.npz", state, batch)
        p2, o2, m = prog.fn(*state, batch, jnp.int32(STEP))
        np.savez(out / f"jax-{label}-{arch}.npz", **_flat_jax(p2, "params"),
                 **_flat_jax(o2, "opt"),
                 **{k: np.float32(v) for k, v in m.items()})
        if label == "2x2" and arch == CKPT_ARCH:
            CheckpointStore(out / "ckpt-jax").save(
                STEP, {"params": p2, "opt": o2}, async_=False)
    print("JAX_REFERENCE_DONE")


def _start_jax_reference(out_dir: Path, label: str) -> subprocess.Popen:
    env = {k: v for k, v in os.environ.items()
           if k not in ("REPRO_QUANTIZED_GATHER", "REPRO_FLASH_ATTN")}
    env["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                        "--xla_cpu_multi_thread_eigen=false "
                        "intra_op_parallelism_threads=1")
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        [SRC, str(Path(__file__).parent), env.get("PYTHONPATH", "")])
    code = ("import test_torch_tp as t; "
            f"t.jax_reference({json.dumps(str(out_dir))}, {label!r})")
    return subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = tmp_path_factory.mktemp("tp")
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


def _unit(results, label: str) -> list[dict]:
    return [dict(np.load(results / f"torch-unit-{label}-{r}.npz"))
            for r in range(_world(label))]


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


# -- the train step -----------------------------------------------------------

TRAIN_CASES = [(label, arch) for label, cases in TRAINS.items()
               for arch, _, _ in cases]


@pytest.mark.parametrize("mesh,arch", TRAIN_CASES)
def test_step_matches_reference(results, mesh, arch):
    got = dict(np.load(results / f"torch-{mesh}-{arch}.npz"))
    want = dict(np.load(results / f"jax-{mesh}-{arch}.npz"))
    _hold_to_reference(got, want, f"{arch} at {mesh}")


@pytest.mark.parametrize("mesh,arch", TRAIN_CASES)
def test_gnorm_is_the_global_norm(results, mesh, arch):
    """The clip's global norm sums the squares of every leaf cut over
    "model" over the model axis too (and of a leaf whole over it once):
    the reference's, within 1e-3. Summed over the data axes only it is
    the norm of one rank's cut, a third of the global one and less at
    these meshes."""
    got = dict(np.load(results / f"torch-{mesh}-{arch}.npz"))
    want = dict(np.load(results / f"jax-{mesh}-{arch}.npz"))
    np.testing.assert_allclose(got["gnorm"], want["gnorm"], rtol=1e-3)


@pytest.mark.parametrize("mesh,arch", TRAIN_CASES)
def test_netrpc_agrees_with_xla_psum_over_three_steps(results, mesh, arch):
    losses = json.loads((results / f"torch-{mesh}-losses.json").read_text())
    mode = next(m for a, m, _ in TRAINS[mesh] if a == arch)
    ref, got = losses[f"{arch}/zero1-xla-psum"], losses[f"{arch}/{mode}-netrpc"]
    assert len(got) == N_STEPS and np.all(np.isfinite(got))
    assert np.allclose(ref, got, atol=2e-3 if mode == "fsdp" else 1e-3), \
        (ref, got)


def test_port_checkpoint_restores_in_reference(results):
    """The (2, 2) state after the port's step, gathered over both axes and
    written by rank 0, read by the reference's store into its own tree:
    every leaf equals the port's gathered state."""
    from functools import partial

    import jax

    from repro.checkpoint.store import CheckpointStore
    from repro.configs.base import get_arch
    from repro.models import api as japi
    cfg = get_arch(CKPT_ARCH).reduced()
    shapes = jax.eval_shape(partial(japi.init_params, cfg=cfg),
                            jax.random.key(0))
    f32 = jax.tree.map(lambda l: jax.ShapeDtypeStruct(l.shape, np.float32),
                       shapes)
    store = CheckpointStore(results / "ckpt-torch")
    assert store.latest_step() == STEP
    got = store.restore(STEP, {"params": shapes,
                               "opt": {"master": f32, "m": f32, "v": f32}})
    flat = {**_flat_jax(got["params"], "params"),
            **_flat_jax(got["opt"], "opt")}
    port = dict(np.load(results / f"torch-2x2-{CKPT_ARCH}.npz"))
    assert sorted(flat) == sorted(k for k in port
                                  if k.startswith(("params/", "opt/")))
    for k, v in flat.items():
        assert v.tobytes() == port[k].tobytes(), k


def test_reference_checkpoint_restores_in_port(results):
    """The reference's (2, 2) state after its step, restored by the port's
    4 ranks: each rank's shard is the stored leaf cut over "data" (its
    index r // 2) and "model" (r % 2) along its spec, bit for bit."""
    from repro_torch.compat import Mesh
    from repro_torch.launch import steps
    from repro_torch.models import api
    from repro_torch.sharding import rules
    cfg = _reduced(CKPT_ARCH)
    shapes = api.param_shapes(cfg)
    mesh = Mesh((2, 2), ("data", "model"), {})
    dims = steps.scatter_dims_tree(shapes, 2, 2)
    pspecs = rules.param_specs(shapes, rules.MeshAxes(("data",)), mesh,
                               "zero1")
    ospecs = steps.opt_specs(pspecs, dims, ("data",))
    d = results / "ckpt-jax" / f"step_{STEP:08d}"
    stored = {f"params/{k}": v for k, v in np.load(d / "params.npz").items()}
    stored.update({f"opt/{k}": v for k, v in np.load(d / "opt.npz").items()})
    cuts = {"data": 0, "model": 0}
    for rank in range(4):
        got = dict(np.load(results / f"torch-restored-{rank}.npz"))
        assert sorted(got) == sorted(stored)
        idx = {"data": rank // 2, "model": rank % 2}
        for key, full in stored.items():
            name = key.split("/", 1)[1]
            if key.startswith("opt/"):
                name = name.split("/", 1)[1]
            spec = (ospecs if key.startswith("opt/") else pspecs)[
                name.replace("/", ".")]
            want = full
            for dim, entry in enumerate(spec):
                if entry in idx:
                    want = np.split(want, 2, axis=dim)[idx[entry]]
                    cuts[entry] += 1
            assert got[key].tobytes() == want.tobytes(), (rank, key)
    assert cuts["data"] and cuts["model"]


# -- the serve step -------------------------------------------------------------

SERVE_CASES = [(label, _tag(*case)) for label in MESHES
               for case in _serves(label)]


@pytest.mark.parametrize("mesh,case", SERVE_CASES)
def test_serve_matches_reference(results, mesh, case):
    """The prefill's logits and each decode step's, on every rank the
    same, within ``LOGIT_TOL`` of the reference's programs at the same
    mesh (``-seq``: the sequence-sharded decode of a batch of 1, its
    cache cut over the data axis by position and over "model" by KV
    head; ``-q8``: fsdp's serve gather in int8, the reference's
    ``REPRO_QUANTIZED_GATHER=1``)."""
    ranks = [np.load(results / f"torch-{mesh}-{case}-{r}.npy")
             for r in range(_world(mesh))]
    want = np.load(results / f"jax-{mesh}-{case}.npy")[..., :512]
    for r in ranks[1:]:
        assert r.tobytes() == ranks[0].tobytes()
    got = ranks[0][..., :512]
    assert got.shape == want.shape == (DEC + 1, 1 if "seq" in case else SB,
                                       512)
    for t in range(DEC + 1):
        assert _rel(got[t], want[t]) < LOGIT_TOL, (mesh, case, t)


# -- units ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def units(results):
    return {label: _unit(results, label) for label in MESHES}


def test_tp_functions_forward_and_backward(units):
    """At model 4, each rank's input x_r and cotangent c_r: from_model
    gives sum_r x_r and passes c_r back; to_model gives x_r and passes
    sum_r c_r back; gather_model (dim 1) gives the x_r side by side and
    passes back rank r's columns of c_r."""
    ranks = units["1x4"]
    xs = [torch.randn((3, 8), generator=torch.Generator().manual_seed(r))
          .numpy() for r in range(4)]
    cts = {n: [torch.randn(s, generator=torch.Generator().manual_seed(
        100 + r)).numpy() for r in range(4)]
        for n, s in (("from", (3, 8)), ("to", (3, 8)), ("gather", (3, 32)))}
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(res["from/y"], sum(xs), rtol=1e-6)
        assert res["from/grad"].tobytes() == cts["from"][r].tobytes()
        assert res["to/y"].tobytes() == xs[r].tobytes()
        np.testing.assert_allclose(res["to/grad"], sum(cts["to"]),
                                   rtol=1e-6)
        assert res["gather/y"].tobytes() == np.concatenate(xs, 1).tobytes()
        assert res["gather/grad"].tobytes() == \
            cts["gather"][r][:, 8 * r:8 * (r + 1)].copy().tobytes()


@pytest.mark.parametrize("mesh", list(MESHES))
def test_host_mesh_cuts_and_gathers_both_axes(units, mesh):
    """``make_host_mesh(model=m)`` lays the ranks out data-major, and
    ``shard_of`` cuts (``unshard`` gathers back, bit for bit) over the
    model axis, the data axis and both."""
    from repro_torch.compat import Mesh
    from repro_torch.sharding import rules
    full = np.arange(8 * 12 * 4, dtype=np.float32).reshape(8, 12, 4)
    nd, nm = MESHES[mesh]
    specs = (rules.P("model"), rules.P(None, "model"),
             rules.P("data", "model"), rules.P(None, ("data", "model")),
             rules.P("model", None, "data"))
    for r, res in enumerate(units[mesh]):
        idx = {"data": r // nm, "model": r % nm}
        for i, spec in enumerate(specs):
            want = full
            for dim, entry in enumerate(spec):
                names = rules._entry_axes(entry)
                k, n = 0, 1
                for name in names:
                    size = nd if name == "data" else nm
                    k, n = k * size + idx[name], n * size
                want = np.split(want, n, axis=dim)[k]
            assert res[f"shard/{i}"].tobytes() == want.tobytes(), (r, spec)
            assert res[f"unshard/{i}"].tobytes() == full.tobytes(), (r, spec)
    assert Mesh(MESHES[mesh], ("data", "model"), {}).shape == MESHES[mesh]


def test_pad_columns_lie_in_the_last_shard(units):
    """qwen2.5-3b's vocab of 151 936 pads to 152 064: at model 4 each rank
    holds 38 016 rows, and the 128 pad columns, found by their global
    index, are all in rank 3's. The gathered logits are -1e30 there and
    nowhere else, and equal the one-rank logits."""
    pad = float(torch.tensor(-1e30).bfloat16())      # -1e30 in bf16
    for res in units["1x4"]:
        assert int(res["pad/rows"]) == 38_016
        tp, one = res["pad/tp"], res["pad/one"]
        assert tp.shape == one.shape == (2, 3, 152_064)
        assert (tp[..., 151_936:] == pad).all()
        assert not (tp[..., :151_936] == pad).any()
        np.testing.assert_allclose(tp, one, rtol=1e-6, atol=0)


def test_kv_heads_of_each_rank():
    """The mixed case: query head h reads KV head h // (H / KV), so a rank
    whose query heads are cut and KV heads are not holds the one KV head
    its block of query heads reads."""
    from repro_torch.sharding import tp
    assert [tp.kv_heads(16, 2, 4, r) for r in range(4)] == \
        [(0, 1), (0, 1), (1, 1), (1, 1)]                 # qwen2.5-3b
    assert [tp.kv_heads(4, 2, 4, r) for r in range(4)] == \
        [(0, 1), (0, 1), (1, 1), (1, 1)]                 # reduced qwen
    assert [tp.kv_heads(16, 2, 2, r) for r in range(2)] == [(0, 1), (1, 1)]
    assert [tp.kv_heads(48, 8, 4, r) for r in range(4)] == \
        [(0, 2), (2, 2), (4, 2), (6, 2)]                 # grok-1-314b
    assert tp.kv_heads(2, 2, 4, 3) == (0, 2)             # whole attention
    with pytest.raises(NotImplementedError, match="more than one"):
        tp.kv_heads(6, 3, 2, 0)


def test_mixed_kv_cache_holds_the_heads_its_queries_read(units):
    """Reduced qwen at model 4 (4 query heads, 2 KV heads): rank r's
    prefill cache is the one-rank cache's KV head r // 2 (heads 0.. would
    be wrong for ranks 2 and 3); the reduced moonshot's attention is
    whole (2 heads), so every rank holds both KV heads."""
    for r, res in enumerate(units["1x4"]):
        assert tuple(res[f"kv_heads/{QWEN}"]) == (r // 2, 1)
        k, one = res[f"cache/{QWEN}/k"], res[f"cache/{QWEN}/one"]
        assert k.shape[3] == 1
        assert _rel(k, one[:, :, :, r // 2:r // 2 + 1]) < LOGIT_TOL
        assert tuple(res[f"kv_heads/{MOON}"]) == (0, 2)
        assert res[f"cache/{MOON}/k"].tobytes() == \
            res[f"cache/{MOON}/one"].tobytes()


def test_no_all_reduce_after_an_uncut_wo(units):
    """The reduced moonshot at model 4: wq's 2 heads do not split, so wo
    is whole and the attention is the one-rank attention bit for bit (an
    all-reduce after it would add it 4 times); the reduced qwen's wo is
    cut, and its partial products are summed."""
    for res in units["1x4"]:
        assert int(res[f"mixer/{MOON}/wq_rows"]) == 2
        assert res[f"mixer/{MOON}/tp"].tobytes() == \
            res[f"mixer/{MOON}/one"].tobytes()
        assert int(res[f"mixer/{QWEN}/wq_rows"]) == 1
        assert _rel(res[f"mixer/{QWEN}/tp"], res[f"mixer/{QWEN}/one"]) \
            < LOGIT_TOL
