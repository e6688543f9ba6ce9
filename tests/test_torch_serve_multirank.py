"""The serve step over data-parallel ranks (``launch/steps.py:
build_serve_step``) against the JAX package: the reference's
``tests/multidevice/md_decode.py`` (``test_multidevice.py::
test_decode_sharding_equivalence``) mirrored on gloo ranks.

The port runs as gloo ranks (``torch.multiprocessing``, spawn, one thread
a rank) at world 2, a ``(data, model) = (2, 1)`` mesh, and world 4,
``(pod, data, model) = (2, 2, 1)``. The reference draws the weights and
tokens (md_decode's: reduced gemma3-27b from ``jax.random.key(0)``, tokens
from ``key(1)``) and computes its single-host forward in one subprocess;
the ranks wait for its file. Each rank prefills the whole batch with the
port's ``api.prefill``, grows the cache, cuts its shard (``shard_cache``)
and runs the decode program at ``S_PRE``:

  batch-sharded  a batch of 4, S_PRE 64, S_DEC 68 (its rows on each rank);
  sequence-sharded
                 a batch of 1 at S_PRE 64, S_DEC 68 (position 64 lands in
                 the last shard of 17 at world 4), and at S_PRE 20 with a
                 per-rank length of 17 (position 20 lands in shard 1: a
                 rank order with the data axis major would take it to
                 rank 2 at world 4); reduced whisper-medium (a
                 ``selfcross`` layer's self K/V, its 16 stub frames) at
                 world 2.

Each run is held three ways: to the reference's single-host forward at
md_decode's bounds (argmax equal, atol 0.4, rtol 0.15; whisper at the
reference's own coarser smoke bounds, atol 0.5, as
``test_torch_encdec.py`` holds it: its decode does not continue its
prefill), to the port's one-rank ``decode_step`` from the same cache
(``LOGIT_TOL``, argmax equal), and, sequence-sharded, the K/V row at
the position is written only in the shard that holds it, every other row
of every shard bit for bit as it was.

The fsdp serve gather: reduced llama-3.2-vision-90b (its mode is fsdp,
the cross gates set to 0.5) at world 2, a batch of 2, a prompt of 32 and
3 teacher-forced decode steps through the prefill and decode programs,
with the plain gather and with the q8 gather, each held within
``LOGIT_TOL`` to the reference's ``build_serve_step`` at the same mesh
(a subprocess with 2 forced host devices; ``REPRO_QUANTIZED_GATHER=1``
in the q8 one's environment only). The q8 logits differ from the plain
ones.

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

from test_torch_multirank import _flat_jax, _nested, _wait_for

SRC = str(Path(__file__).resolve().parents[1] / "src")
ARCH, WHISPER, FSDP_ARCH = "gemma3-27b", "whisper-medium", \
    "llama-3.2-vision-90b"
S_PRE, S_DEC, BATCH = 64, 68, 4
SHARD1_PRE, SHARD1_LEN = 20, 17        # position 20 in shard 1 of 17 each
FSDP_B, FSDP_PRE, FSDP_DEC, GATE = 2, 32, 3, 0.5
MESHES = {"2": ((2, 1), ("data", "model")),
          "2x2": ((2, 2, 1), ("pod", "data", "model"))}
LOGIT_TOL = 2e-2               # as tests/test_torch_model.py
MD_ATOL, MD_RTOL = 0.4, 0.15   # tests/multidevice/md_decode.py
SMOKE_ATOL = 0.5               # tests/test_models_smoke.py (whisper)
TIMEOUT = 180
# (case, arch, batch, prompt, decode length a rank, meshes); the decode
# length of the sequence-sharded shard-1 case is SHARD1_LEN a rank
DECODES = (("batch", ARCH, BATCH, S_PRE, S_DEC, ("2", "2x2")),
           ("seq", ARCH, 1, S_PRE, S_DEC, ("2", "2x2")),
           ("shard1", ARCH, 1, SHARD1_PRE, None, ("2", "2x2")),
           ("whisper", WHISPER, 1, S_PRE, S_DEC, ("2",)))
SEQ_CASES = [(c, m) for c, _, b, _, _, ms in DECODES if b == 1 for m in ms]


def _world(label: str) -> int:
    return int(np.prod(MESHES[label][0]))


def _dec_len(case, label) -> int:
    row = next(r for r in DECODES if r[0] == case)
    return row[4] or SHARD1_LEN * _world(label)


# -- the port's ranks ---------------------------------------------------------

def _port_params(flat: dict, prefix: str, cfg):
    """The reference's stored params (fp32 in the file) as the port's
    full tree in its dtypes (exact: they were bf16 or fp32)."""
    from repro_torch.models import api
    shapes = api.param_shapes(cfg)
    dtypes = dict((n, t.dtype) for n, t in api.named_leaves(shapes))
    return api.map_named(lambda n, t: t.to(dtypes[n]), api.params_from_jax(
        _nested(flat, prefix, shapes), "cpu"))


def _seq_leaves(cache, cfg) -> dict:
    """{name: fp32 numpy} of the sequence-sharded K/V of a cache."""
    from repro_torch.launch.steps import SEQ_SHARDED_BLOCKS
    return {f"{gi}/{s}/{k}": t.float().numpy().copy()
            for gi, ((pat, _), g) in enumerate(zip(cfg.pattern_groups, cache))
            for s, e in g.items() for k, t in e.items()
            if pat[int(s[1:])] in SEQ_SHARDED_BLOCKS and k in ("k", "v")}


def _decode_case(case, arch, b, prompt, label, inp, mesh, rank, out):
    """One decode program from the port's own prefill of the whole batch:
    this rank's logits and, sequence-sharded, its cache shard before and
    after; rank 0 also the one-rank ``decode_step`` from the same cache."""
    from repro_torch.configs.base import ShapeConfig, get_arch
    from repro_torch.launch import steps
    from repro_torch.launch.serve import grow_cache
    from repro_torch.models import api
    cfg = get_arch(arch).reduced()
    params = _port_params(inp, arch, cfg)
    toks = torch.from_numpy(inp[f"{arch}/tokens"][:b, :prompt + 1])
    batch = {"tokens": toks[:, :prompt]}
    if f"{arch}/frames" in inp:
        batch["frames"] = torch.from_numpy(inp[f"{arch}/frames"][:b]).to(
            torch.bfloat16)
    total = _dec_len(case, label)
    _, full = api.prefill(params, cfg, batch)
    full = grow_cache(full, cfg, b, total)
    prog = steps.build_serve_step(
        cfg, ShapeConfig("d", seq_len=total, global_batch=b, kind="decode"),
        mesh, flash=False, device="cpu")
    shard = steps.shard_cache(full, prog)
    # a cut leaf is a copy; a whole one (a local ring) is full's own
    shard = tuple({s: {k: t.clone() for k, t in e.items()}
                   for s, e in g.items()} for g in shard)
    before = _seq_leaves(shard, cfg)
    got, shard = prog.fn(api.shard_tree(params, prog.meta["param_specs"],
                                        mesh), toks[:, -1], prompt, shard)
    res = {"logits": got.float().numpy(),
           "seq_sharded": np.bool_(prog.meta["seq_sharded"])}
    if prog.meta["seq_sharded"]:
        res.update({f"before/{k}": v for k, v in before.items()})
        res.update({f"after/{k}": v
                    for k, v in _seq_leaves(shard, cfg).items()})
    if rank == 0:
        one, full = api.decode_step(params, cfg, toks[:, -1], prompt, full)
        res["one_rank"] = one.float().numpy()
        res.update({f"one_rank_cache/{k}": v[:, :, prompt]
                    for k, v in _seq_leaves(full, cfg).items()})
    np.savez(out / f"torch-{label}-{case}-{rank}.npz", **res)


def _fsdp_case(q8, inp, mesh, rank, out):
    """The prefill and decode programs of the reduced llama in fsdp:
    rank 0 keeps the logits of every step."""
    from repro_torch.configs.base import ShapeConfig, get_arch
    from repro_torch.launch import steps
    from repro_torch.launch.serve import grow_cache
    from repro_torch.models import api
    cfg = get_arch(FSDP_ARCH).reduced()
    params = _port_params(inp, FSDP_ARCH, cfg)
    toks = torch.from_numpy(inp[f"{FSDP_ARCH}/tokens"])
    patches = torch.from_numpy(inp[f"{FSDP_ARCH}/patches"]).to(
        torch.bfloat16)
    total = FSDP_PRE + FSDP_DEC

    def build(kind, seq):
        return steps.build_serve_step(
            cfg, ShapeConfig(kind, seq_len=seq, global_batch=FSDP_B,
                             kind=kind), mesh, q8=q8, flash=False,
            device="cpu")
    pf, dec = build("prefill", FSDP_PRE), build("decode", total)
    assert pf.meta["mode"] == "fsdp" and not dec.meta["seq_sharded"]
    params = api.shard_tree(params, pf.meta["param_specs"], mesh)
    logits, cache = pf.fn(params, {"tokens": toks[:, :FSDP_PRE],
                                   "patches": patches})
    cache = grow_cache(cache, cfg, FSDP_B // 2, total)
    every = [logits]
    for i in range(FSDP_DEC):
        logits, cache = dec.fn(params, toks[:, FSDP_PRE + i], FSDP_PRE + i,
                               cache)
        every.append(logits)
    if rank == 0:
        np.save(out / f"torch-fsdp-{'q8' if q8 else 'plain'}.npy",
                torch.stack(every).float().numpy())


def _torch_rank(rank: int, out_dir: str) -> None:
    import torch.distributed as dist

    from repro_torch import compat
    torch.set_num_threads(1)
    out = Path(out_dir)
    _wait_for(out / "jax-inputs.npz", time.monotonic() + TIMEOUT)
    inp = dict(np.load(out / "jax-inputs.npz"))
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
            for case, arch, b, prompt, _, meshes in DECODES:
                if label in meshes:
                    _decode_case(case, arch, b, prompt, label, inp, mesh,
                                 rank, out)
            if label == "2":
                for q8 in (False, True):
                    _fsdp_case(q8, inp, mesh, rank, out)
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


# -- the JAX reference --------------------------------------------------------

def _fsdp_inputs():
    """The reduced llama's weights (``key(0)``, the cross gates set to
    GATE), its tokens and stub patches."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import get_arch
    from repro.data import pipeline
    from repro.models import api
    cfg = get_arch(FSDP_ARCH).reduced()
    params = api.init_params(jax.random.key(0), cfg)
    groups = list(params["groups"])
    for gi, (pat, _) in enumerate(cfg.pattern_groups):
        for i, bt in enumerate(pat):
            if bt == "cross":
                slot = dict(groups[gi][f"s{i}"])
                slot["gate"] = jnp.full_like(slot["gate"], GATE)
                groups[gi] = {**groups[gi], f"s{i}": slot}
    params = {**params, "groups": tuple(groups)}
    toks = np.random.RandomState(3).randint(
        0, cfg.vocab, (FSDP_B, FSDP_PRE + FSDP_DEC)).astype(np.int32)
    patches = pipeline.add_modality_stubs({}, cfg, FSDP_B)["patches"]
    return cfg, params, toks, patches


def jax_inputs(out_dir: str) -> None:
    """Every case's weights and tokens, written whole at once (the ranks
    wait for the file), then the single-host forward's last logits of
    each decode case."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import get_arch
    from repro.data import pipeline
    from repro.models import api
    out = Path(out_dir)
    gcfg = get_arch(ARCH).reduced()
    gp = api.init_params(jax.random.key(0), gcfg)
    toks = jax.random.randint(jax.random.key(1), (BATCH, S_PRE + 1), 0,
                              gcfg.vocab, jnp.int32)
    wcfg = get_arch(WHISPER).reduced()
    wp = api.init_params(jax.random.key(0), wcfg)
    wtoks = np.random.RandomState(2).randint(
        0, wcfg.vocab, (1, S_PRE + 1)).astype(np.int32)
    frames = pipeline.add_modality_stubs({}, wcfg, 1)["frames"]
    _, lp, ltoks, patches = _fsdp_inputs()
    np.savez(out / "tmp-inputs.npz", **_flat_jax(gp, ARCH),
             **_flat_jax(wp, WHISPER), **_flat_jax(lp, FSDP_ARCH),
             **{f"{ARCH}/tokens": np.asarray(toks),
                f"{WHISPER}/tokens": wtoks,
                f"{WHISPER}/frames": np.asarray(frames, np.float32),
                f"{FSDP_ARCH}/tokens": ltoks,
                f"{FSDP_ARCH}/patches": np.asarray(patches, np.float32)})
    os.replace(out / "tmp-inputs.npz", out / "jax-inputs.npz")
    refs = {}
    for case, arch, b, prompt, _, _ in DECODES:
        cfg, params = (wcfg, wp) if arch == WHISPER else (gcfg, gp)
        batch = {"tokens": (wtoks if arch == WHISPER else toks)[
            :b, :prompt + 1]}
        if arch == WHISPER:
            batch["frames"] = frames
        logits, _ = jax.jit(lambda p, x, _c=cfg: api.forward(p, _c, x))(
            params, batch)
        refs[case] = np.asarray(logits[:, -1].astype(jnp.float32))
    np.savez(out / "jax-forward.npz", **refs)
    print("JAX_REFERENCE_DONE")


def jax_fsdp(out_dir: str) -> None:
    """The reference's prefill and decode programs of the reduced llama
    (fsdp, its mode) on a (2, 1) mesh of host devices, teacher forced:
    the logits of every step. The q8 gather iff this process's
    environment has ``REPRO_QUANTIZED_GATHER=1``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from repro.configs.base import ShapeConfig
    from repro.launch import steps
    from repro.models import api
    cfg, params, toks, patches = _fsdp_inputs()
    mesh = Mesh(np.array(jax.devices()[:2]).reshape(2, 1),
                ("data", "model"))
    total = FSDP_PRE + FSDP_DEC
    pf = steps.build_serve_step(cfg, ShapeConfig("p", FSDP_PRE, FSDP_B,
                                                 "prefill"), mesh)
    dec = steps.build_serve_step(cfg, ShapeConfig("d", total, FSDP_B,
                                                  "decode"), mesh)
    params = jax.device_put(params, pf.meta["param_shardings"])
    logits, cache = pf.fn(params, {"tokens": jnp.asarray(toks[:, :FSDP_PRE]),
                                   "patches": patches})
    like = api.cache_specs(cfg, FSDP_B, total)
    cache = jax.tree.map(lambda c, lk: c if c.shape == lk.shape else jnp.pad(
        c, [(0, a - b) for b, a in zip(c.shape, lk.shape)]), cache, like)
    cache = jax.device_put(cache, dec.meta["cache_shardings"])
    every = [logits]
    for i in range(FSDP_DEC):
        logits, cache = dec.fn(params, jnp.asarray(toks[:, FSDP_PRE + i]),
                               jnp.int32(FSDP_PRE + i), cache)
        every.append(logits)
    q8 = os.environ.get("REPRO_QUANTIZED_GATHER") == "1"
    np.save(Path(out_dir) / f"jax-fsdp-{'q8' if q8 else 'plain'}.npy",
            np.stack([np.asarray(x.astype(jnp.float32)) for x in every]))
    print("JAX_REFERENCE_DONE")


def _start_jax(out_dir: Path, fn: str, devices: int, **extra_env
               ) -> subprocess.Popen:
    env = {k: v for k, v in os.environ.items()
           if k != "REPRO_QUANTIZED_GATHER" and k != "REPRO_FLASH_ATTN"}
    env.update(extra_env)
    env["XLA_FLAGS"] = (f"--xla_force_host_platform_device_count={devices} "
                        "--xla_cpu_multi_thread_eigen=false "
                        "intra_op_parallelism_threads=1")
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        [SRC, str(Path(__file__).parent), env.get("PYTHONPATH", "")])
    code = (f"import test_torch_serve_multirank as t; "
            f"t.{fn}({json.dumps(str(out_dir))})")
    return subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = tmp_path_factory.mktemp("serve_multirank")
    refs = {"inputs": _start_jax(out, "jax_inputs", 1),
            "fsdp plain": _start_jax(out, "jax_fsdp", 2),
            "fsdp q8": _start_jax(out, "jax_fsdp", 2,
                                  REPRO_QUANTIZED_GATHER="1")}
    try:
        _run_torch_ranks(out)
        for what, ref in refs.items():
            stdout, stderr = ref.communicate(timeout=TIMEOUT)
            assert ref.returncode == 0 and "JAX_REFERENCE_DONE" in stdout, \
                f"JAX reference ({what}) failed:\n{stdout}\n{stderr}"
    finally:
        for ref in refs.values():
            if ref.poll() is None:
                ref.kill()
                ref.communicate()
    return out


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


def _ranks(results, label, case) -> list[dict]:
    return [dict(np.load(results / f"torch-{label}-{case}-{r}.npz"))
            for r in range(_world(label))]


def _held(results, label, case, atol) -> list[dict]:
    """Every rank's logits the same; rank 0's against the reference's
    forward (argmax, ``atol``, md_decode's rtol) and the one-rank decode
    (argmax, ``LOGIT_TOL``)."""
    ranks = _ranks(results, label, case)
    vocab = 512
    got = ranks[0]["logits"][:, :vocab]
    for r in ranks[1:]:
        assert r["logits"].tobytes() == ranks[0]["logits"].tobytes()
    want = dict(np.load(results / "jax-forward.npz"))[case][:, :vocab]
    assert np.array_equal(got.argmax(-1), want.argmax(-1))
    np.testing.assert_allclose(got, want, atol=atol, rtol=MD_RTOL)
    one = ranks[0]["one_rank"][:, :vocab]
    assert np.array_equal(got.argmax(-1), one.argmax(-1))
    assert _rel(got, one) < LOGIT_TOL
    return ranks


@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_sharded_decode_matches_reference(results, mesh):
    ranks = _held(results, mesh, "batch", MD_ATOL)
    assert not ranks[0]["seq_sharded"]


@pytest.mark.parametrize("case,mesh", SEQ_CASES)
def test_seq_sharded_decode_matches_reference(results, case, mesh):
    ranks = _held(results, mesh, case,
                  SMOKE_ATOL if case == "whisper" else MD_ATOL)
    assert ranks[0]["seq_sharded"]


@pytest.mark.parametrize("case,mesh", SEQ_CASES)
def test_seq_sharded_cache_written_only_where_it_lies(results, case, mesh):
    """The K/V row of the decoded position is written in the shard that
    holds it (close to the one-rank decode's row), and no other row of
    any shard changes by a bit."""
    row = next(r for r in DECODES if r[0] == case)
    pos = row[3]
    length = _dec_len(case, mesh) // _world(mesh)
    owner = pos // length
    ranks = _ranks(results, mesh, case)
    keys = [k[len("before/"):] for k in ranks[0] if k.startswith("before/")]
    assert keys
    for r, res in enumerate(ranks):
        for k in keys:
            before, after = res[f"before/{k}"], res[f"after/{k}"]
            assert before.shape[2] == length
            if r != owner:
                assert after.tobytes() == before.tobytes(), (r, k)
                continue
            i = pos - owner * length
            rest = np.delete(after, i, axis=2), np.delete(before, i, axis=2)
            assert rest[0].tobytes() == rest[1].tobytes(), (r, k)
            assert not before[:, :, i].any() and after[:, :, i].any(), (r, k)
            want = ranks[0][f"one_rank_cache/{k}"]
            assert _rel(after[:, :, i], want) < LOGIT_TOL, (r, k)


@pytest.mark.parametrize("gather", ["plain", "q8"])
def test_fsdp_serve_matches_reference(results, gather):
    got = np.load(results / f"torch-fsdp-{gather}.npy")[..., :512]
    want = np.load(results / f"jax-fsdp-{gather}.npy")[..., :512]
    assert got.shape == want.shape == (FSDP_DEC + 1, FSDP_B, 512)
    for t in range(FSDP_DEC + 1):
        assert _rel(got[t], want[t]) < LOGIT_TOL, (gather, t)


def test_q8_gather_changes_the_logits(results):
    plain = np.load(results / "torch-fsdp-plain.npy")
    q8 = np.load(results / "torch-fsdp-q8.npy")
    assert np.isfinite(q8).all() and not np.array_equal(plain, q8)
