"""Tensor parallelism over the "model" mesh axis for the ``bidir``,
``selfcross``, ``cross``, ``rglru`` and ``ssd`` blocks and ``mproj``
(``sharding/tp.py``, ``Ctx.model``), against the JAX package, whose GSPMD
places the same collectives, and against the port's own one-rank step.

The harness is ``test_torch_tp.py``'s: the port runs as gloo ranks
(``torch.multiprocessing``, spawn, one thread a rank, spawned once for
every mesh) on ``(data, model)`` meshes of (1, 2), (2, 2) and (1, 4); the
reference runs while the ranks run, in subprocesses with forced host
devices: one a mesh for the serve programs, and three for the train
steps at (2, 2). Reduced configs:

  whisper-medium        ``bidir`` encoder and ``selfcross`` decoder, the
                        GELU MLP; its 2 heads split at model 2 and run
                        whole at model 4; the encoder's final norm scale
                        (cut by its name, "norm") gathered whole;
  llama-3.2-vision-90b  ``global`` and ``cross`` (gates set to 0.5),
                        ``mproj`` cut on its output dim, fsdp; at model 4
                        its 4 query heads are cut and its 2 KV heads are
                        not (the mixed case, the memory's K/V too);
  recurrentgemma-9b     ``rglru`` (the width and its gate blocks cut) and
                        ``local``; at model 2 its 2 query heads read one
                        KV head;
  mamba2-780m           ``ssd``: its heads cut, B and C whole, the gated
                        norm summed over the axis.

Cases:

  serve        the prefill program and 2 teacher-forced decode steps (a
               batch of 2, a prompt of 40, past the reduced window of
               32) within ``LOGIT_TOL`` of the reference's programs at the
               same mesh; at (2, 2) also whisper's sequence-sharded decode
               (a batch of 1, a cache cut by ``shard_cache``) and the
               reduced llama's q8 serve gather (the reference's
               ``REPRO_QUANTIZED_GATHER=1`` while it builds those); the
               recurrent caches' states and conv tails against the
               reference's prefill cache at the same mesh;
  one step     at (2, 2), netrpc, each family in its mode (llama in fsdp)
               and whisper once more in fsdp (its encoder gathered under
               scope "enc" while it is cut over "model"), from the
               reference's state: loss, global norm, learning rate and the
               masters' update held to the reference's step with
               ``test_torch_multirank.py``'s bounds, and the whole state
               with all of them to the port's one-rank step from the same
               state (the reference's own (2, 2) step is more than their
               5% from its one-device step in m and v of two leaves); at
               (1, 2) and (1, 4), where the reference's
               step fails on this JAX (an XLA SPMD check:
               ``hlo->sharding().IsManualSubgroup()``) for three of the
               four, the port's step held at the same tolerances to the
               port's one-rank step from the same state (that step is
               held to the reference by ``test_torch_train.py``);
  build        every config of ``configs/`` (reduced) builds its train,
               prefill and decode programs at (1, 2).

Unit cases, each against the one-rank computation (fp32, or bf16 where
the layer computes in it; each fails with the fault it names put back):
the GELU MLP's whole b2 added once; the SSD mixer's output and every
gradient (the norm's sum over the axis both ways, ``to_model`` on B and
C and not on x); the memory gathered after ``mproj`` and the encoder's
norm scale gathered, forward and backward; ``shard_cache`` narrowing
the memory's K/V in the mixed case; ``grow_cache`` keeping a rank's cut
state; ``tp.sum_model``'s forward and backward; the SSD's gradient
finite where the reference's is NaN.

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

from repro_torch.configs.all import ALL_ARCHS
from test_torch_multirank import (_flat_jax, _flat_numpy, _hold_to_reference,
                                  _nested, _save_init, _wait_for)

SRC = str(Path(__file__).resolve().parents[1] / "src")
MESHES = {"1x2": (1, 2), "2x2": (2, 2), "1x4": (1, 4)}
WHISPER, LLAMA, RG, MAMBA = ("whisper-medium", "llama-3.2-vision-90b",
                             "recurrentgemma-9b", "mamba2-780m")
FAMILIES = (WHISPER, LLAMA, RG, MAMBA)
SEQ, BATCH, N_MICRO, PRECISION, STEP = 32, 4, 2, 7, 3
OPT = dict(warmup_steps=2, total_steps=50)
GATE = 0.5                            # the cross layers' gates
MODE = {WHISPER: "zero1", LLAMA: "fsdp", RG: "zero1", MAMBA: "zero1"}
# (arch, mode) of each train case: the family's mode, whisper in fsdp too
TRAINS = tuple(MODE.items()) + ((WHISPER, "fsdp"),)
# the reference's (2, 2) train cases, split over three subprocesses (its
# compiles are the long pole)
JAX_TRAINS = {"train-a": ((WHISPER, "zero1"), (WHISPER, "fsdp")),
              "train-b": ((LLAMA, "fsdp"),),
              "train-c": ((RG, "zero1"), (MAMBA, "zero1"))}
PROMPT, DEC, SB = 40, 2, 2
SEQ_ARCH, Q8_ARCH = WHISPER, LLAMA    # at (2, 2)
RECURRENT = (RG, MAMBA)
LOGIT_TOL = 2e-2                      # as tests/test_torch_model.py
UNIT_TOL = 1e-4                       # fp32 units against one rank
TIMEOUT = 600                         # beside the other files' workers


def _world(label: str) -> int:
    return int(np.prod(MESHES[label]))


def _serves(label: str) -> list[tuple[str, str]]:
    """(arch, variant) of each serve case at ``label``: "" the
    batch-sharded decode, "seq" the sequence-sharded one (a batch of 1),
    "q8" the fsdp serve gather in int8."""
    return [(a, "") for a in FAMILIES] + \
        ([(SEQ_ARCH, "seq"), (Q8_ARCH, "q8")] if label == "2x2" else [])


def _tag(arch: str, variant: str) -> str:
    return f"{arch}-{variant}" if variant else arch


def _tokens(vocab: int, b: int) -> np.ndarray:
    return np.random.RandomState(7).randint(
        0, vocab, (b, PROMPT + DEC)).astype(np.int32)


def _train_tag(arch: str, mode: str) -> str:
    return f"{arch}-{mode}"


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


def _stubs(flat: dict, prefix: str) -> dict:
    """The stored frames or patches (fp32 in the file) as bf16."""
    return {k: torch.from_numpy(flat[f"{prefix}/{k}"]).bfloat16()
            for k in ("frames", "patches") if f"{prefix}/{k}" in flat}


def _set_gates(tree, cfg) -> None:
    """Every cross layer's gate of a port tree to GATE, in place."""
    for gi, (pat, _) in enumerate(cfg.pattern_groups):
        for i, bt in enumerate(pat):
            if bt == "cross":
                tree["groups"][gi][f"s{i}"]["gate"].data.fill_(GATE)


def _train_build(cfg, mode, mesh):
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.inc_agg import IncAggConfig
    from repro_torch.launch import steps
    from repro_torch.optim.adamw import AdamWConfig
    return steps.build_train_step(
        cfg, ShapeConfig("t", SEQ, BATCH, "train"), mesh,
        inc=IncAggConfig(mode="netrpc", precision=PRECISION),
        opt_cfg=AdamWConfig(**OPT), n_micro=N_MICRO, mode=mode,
        device="cpu")


def _own_state(cfg):
    """The port's full state for the (1, m) steps: params from seed 2,
    fresh AdamW state, the cross gates at GATE (params and masters), and
    its batch (bigram tokens at STEP, the pipeline's stubs)."""
    from repro_torch.data import pipeline
    from repro_torch.launch import steps
    from repro_torch.models import api
    params = api.init_params(2, cfg, device="cpu")
    _set_gates(params, cfg)
    opt = steps.init_opt(params)
    batch = pipeline.add_modality_stubs(pipeline.make_batch(
        pipeline.DataConfig(vocab=cfg.vocab, batch=BATCH, seq_len=SEQ,
                            kind="bigram"), STEP), cfg, BATCH)
    return params, opt, batch


def _gathered(prog, params, opt, m, mesh) -> dict:
    """The state after a step gathered whole over every axis, and the
    metrics, as ``_hold_to_reference`` takes them."""
    from repro_torch.launch import steps
    from repro_torch.models import api
    from repro_torch.sharding import rules
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


def _train_cases(label, mesh, rank, out, deadline):
    """At (2, 2) each of TRAINS from the reference's state; at (1, m) from
    the port's own state (``_own_state``)."""
    from repro_torch.models import api
    for arch, mode in TRAINS if label == "2x2" else MODE.items():
        cfg = _reduced(arch)
        prog = _train_build(cfg, mode, mesh)
        assert prog.meta["n_model"] == MESHES[label][1]
        tag = _train_tag(arch, mode)
        if label == "2x2":
            _wait_for(out / f"jax-train-{tag}-init.npz", deadline)
            params, opt, batch = _reference_state(out, cfg, tag)
        else:
            params, opt, batch = _own_state(cfg)
        params = api.shard_tree(params, prog.meta["param_specs"], mesh)
        opt = {o: api.shard_tree(t, prog.meta["opt_specs"], mesh)
               for o, t in opt.items()}
        params, opt, m = prog.fn(params, opt, batch, STEP)
        full = _gathered(prog, params, opt, m, mesh)
        if rank == 0:
            np.savez(out / f"torch-{label}-{tag}.npz", **full)


def _reference_state(out: Path, cfg, tag: str):
    """A (2, 2) case's state before its step and its batch, as the
    reference wrote them: the port's full trees."""
    from repro_torch.models import api
    init = dict(np.load(out / f"jax-train-{tag}-init.npz"))
    shapes = api.param_shapes(cfg)
    opt = api.opt_from_jax({o: _nested(init, f"opt/{o}", shapes)
                            for o in ("master", "m", "v")}, "cpu")
    return _from_file(init, "params", shapes), opt, {
        "tokens": torch.from_numpy(init["batch/tokens"]),
        **_stubs(init, "batch")}


def _one_rank_steps(jobs, rank, out_dir) -> None:
    """The port's one-rank step of each job, over a group of this rank
    alone: ("own", arch) from ``_own_state`` in the family's mode,
    ("ref", arch, mode) from the reference's (2, 2) state."""
    import torch.distributed as dist

    from repro_torch import compat
    out = Path(out_dir)
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/one-"
                            f"{rank}", rank=0, world_size=1,
                            timeout=timedelta(seconds=300))
    try:
        mesh = compat.make_mesh((1, 1), ("data", "model"), device="cpu")
        for kind, arch, *mode in jobs:
            cfg = _reduced(arch)
            mode = mode[0] if mode else MODE[arch]
            prog = _train_build(cfg, mode, mesh)
            if kind == "own":
                params, opt, batch = _own_state(cfg)
                name = f"torch-one-{arch}.npz"
            else:
                tag = _train_tag(arch, mode)
                params, opt, batch = _reference_state(out, cfg, tag)
                name = f"torch-one-2x2-{tag}.npz"
            params, opt, m = prog.fn(params, opt, batch, STEP)
            np.savez(out / name, **_gathered(prog, params, opt, m, mesh))
    finally:
        dist.destroy_process_group()


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
        stubs = {k: v[:b] for k, v in _stubs(flat, "stubs").items()}
        total = PROMPT + DEC

        def build(kind, s):
            return steps.build_serve_step(
                cfg, ShapeConfig(kind, seq_len=s, global_batch=b, kind=kind),
                mesh, q8=variant == "q8", flash=False, device="cpu")
        dec = build("decode", total)
        assert dec.meta["seq_sharded"] == seq
        params = api.shard_tree(full, dec.meta["param_specs"], mesh)
        if seq:
            logits, cache = api.prefill(full, cfg, {
                "tokens": toks[:, :PROMPT], **stubs})
            cache = steps.shard_cache(grow_cache(cache, cfg, b, total), dec)
        else:
            pf = build("prefill", PROMPT)
            logits, cache = pf.fn(params, {"tokens": toks[:, :PROMPT],
                                           **stubs})
            if arch in RECURRENT:
                np.savez(out / f"torch-{label}-{arch}-cache-{rank}.npz",
                         **{f"{k}/{key}": t.float().numpy() for k, e in
                            cache[0].items() for key, t in e.items()
                            if key in ("state", "conv")})
            cache = grow_cache(cache, cfg, b // dec.meta["n_dp"], total)
        every = [logits]
        for i in range(DEC):
            logits, cache = dec.fn(params, toks[:, PROMPT + i], PROMPT + i,
                                   cache)
            every.append(logits)
        got = torch.stack(every).float().numpy()
        np.save(out / f"torch-{label}-{_tag(arch, variant)}-{rank}.npy", got)


def _build_cases(mesh, rank, out) -> None:
    """Every config of ``configs/`` (reduced): its train, prefill and
    decode programs built at this mesh, or the error."""
    from repro_torch.configs.all import ALL_ARCHS
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import steps
    from repro_torch.models import blocks
    res = {}
    for arch in ALL_ARCHS:
        cfg = _reduced(arch)
        try:
            assert {bt for pat, _ in cfg.pattern_groups for bt in pat} \
                <= set(blocks.TP_BLOCKS)
            _train_build(cfg, None, mesh)
            for kind in ("prefill", "decode"):
                steps.build_serve_step(cfg, ShapeConfig(kind, 64, 2, kind),
                                       mesh, device="cpu")
            res[arch] = "built"
        except Exception as e:               # the test names the error
            res[arch] = f"{type(e).__name__}: {e}"
    if rank == 0:
        (out / "torch-build.json").write_text(json.dumps(res))


def _cut(tree: dict, mesh, prefix: str = "") -> dict:
    """This rank's cut of a one-layer dict of leaves (``rules.tp_dim`` by
    each leaf's name), the data axis left whole."""
    from repro_torch.sharding import rules
    axes = rules.MeshAxes(("data",))
    n_dp, n_model = axes.sizes(mesh)
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _cut(v, mesh, f"{prefix}{k}.")
        else:
            spec = rules.param_spec(prefix + k, v, axes, n_dp, n_model,
                                    "zero1")
            out[k] = rules.shard_of(v, spec, mesh)
    return out


def _seeded(tree: dict, seed: int, dtype=None) -> dict:
    """A one-layer dict of leaves drawn N(0, 1) / sqrt of their first dim
    (so the norm scales, biases, D and the gates are not their init
    values), in ``dtype`` or, None, each leaf's own."""
    g = torch.Generator().manual_seed(seed)
    return {k: _seeded(v, seed + i, dtype) if isinstance(v, dict) else
            (torch.randn(v.shape, generator=g) / max(v.shape[0], 1) ** 0.5
             ).to(dtype or v.dtype)
            for i, (k, v) in enumerate(sorted(tree.items()))}


def _grads(fn, leaves: dict, x: torch.Tensor, ct_seed: int):
    """(y, {name: grad}, dx) of ``fn(leaves, x)`` against a seeded
    cotangent."""
    flat = {}

    def walk(t, prefix=""):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
            else:
                flat[prefix + k] = v.requires_grad_(True)
    walk(leaves)
    x = x.clone().requires_grad_(True)
    y = fn(leaves, x)
    ct = torch.randn(y.shape, generator=torch.Generator().manual_seed(
        ct_seed)).to(y.dtype)
    names = sorted(flat)
    gs = torch.autograd.grad(y, [flat[n] for n in names] + [x], ct,
                             allow_unused=True, materialize_grads=True)
    return y.detach(), dict(zip(names, gs[:-1])), gs[-1]


def _unit_cases(label, mesh, rank, out):
    """The units at model 2 and 4: rank r's results, with the one-rank
    computation's, in ``torch-unit-{label}-r``."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import steps
    from repro_torch.launch.serve import grow_cache
    from repro_torch.models import api, blocks, ffn
    from repro_torch.models.blocks import Ctx
    from repro_torch.sharding import tp
    model = mesh.axes["model"]
    res = {}
    # tp.sum_model on this rank's input and cotangent
    x = torch.randn((3, 5), generator=torch.Generator().manual_seed(rank)
                    ).requires_grad_(True)
    y = tp.sum_model(x, model)
    y.backward(torch.randn((3, 5), generator=torch.Generator().manual_seed(
        100 + rank)))
    res["sum/y"], res["sum/grad"] = y.detach().numpy(), x.grad.numpy()

    def both(name, fn, full, x, seed=5):
        """fn's output and gradients on the rank's cut (under ``model``)
        and on the whole leaves (no axis), the whole gradients cut as
        the leaves are."""
        y_tp, g_tp, dx_tp = _grads(lambda p, h: fn(p, h, model),
                                   _cut(full, mesh), x, seed)
        y_one, g_one, dx_one = _grads(lambda p, h: fn(p, h, None),
                                      {k: v for k, v in full.items()}, x,
                                      seed)
        g_one = _cut_flat(g_one, mesh)
        res[f"{name}/y"], res[f"{name}/y_one"] = (y_tp.float().numpy(),
                                                  y_one.float().numpy())
        res[f"{name}/dx"], res[f"{name}/dx_one"] = (dx_tp.float().numpy(),
                                                    dx_one.float().numpy())
        for n in g_tp:
            res[f"{name}/g/{n}"] = g_tp[n].float().numpy()
            res[f"{name}/g_one/{n}"] = g_one[n].float().numpy()
    h = torch.randn((2, 8, 64), generator=torch.Generator().manual_seed(9))
    pos = torch.arange(8)
    # fp32: the GELU MLP with its biases drawn; the ssd block (n1 and the
    # Mamba-2 mixer)
    mlp = _seeded(ffn.init_gelu_mlp(None, 64, 128, device="meta"), 11,
                  torch.float32)
    both("gelu", lambda p, x, ax: ffn.gelu_mlp(p, x, ax), mlp, h)
    mcfg = _reduced(MAMBA)
    ssd = _seeded(blocks.init_block(None, "ssd", mcfg, device="meta"), 21,
                  torch.float32)
    both("ssd", lambda p, x, ax: blocks.block_train(
        p, "ssd", x, Ctx(cfg=mcfg, positions=pos, model=ax))[0], ssd, h)
    # bf16 (the compute dtype the two take): the memory, mproj's product
    # gathered (llama); whisper's encoder, its final norm scale drawn
    hb = h.bfloat16()
    lcfg = _reduced(LLAMA)
    both("mproj", lambda p, x, ax: api._memory(
        p, lcfg, {"patches": x}, model=ax),
        {"mproj": _seeded({"w": torch.empty(64, 64, dtype=torch.bfloat16,
                                            device="meta")}, 31)["w"]}, hb)
    wcfg = _reduced(WHISPER)
    enc = {"enc": {"blocks": _seeded(blocks.init_block(
        None, "bidir", wcfg, lead=(2,), device="meta"), 41),
        "norm": _seeded({"n": torch.empty(64, device="meta")}, 42)["n"]}}
    both("encode", lambda p, x, ax: api.encode(p, wcfg, x, model=ax), enc,
         hb)
    if label == "1x4":
        # the mixed case: the memory's K/V of a decode cache cut by
        # shard_cache hold the KV head the rank's query head reads
        full = api.init_params(2, lcfg, device="cpu")
        dec = steps.build_serve_step(lcfg, ShapeConfig("d", 24, 2, "decode"),
                                     mesh, flash=False, device="cpu")
        toks = torch.from_numpy(_tokens(lcfg.vocab, 2)[:, :16])
        from repro_torch.data import pipeline
        stubs = pipeline.add_modality_stubs({}, lcfg, 2)
        _, cache = api.prefill(full, lcfg, {"tokens": toks, **stubs})
        cache = grow_cache(cache, lcfg, 2, 24)
        mine = steps.shard_cache(cache, dec)
        slot = next(f"s{i}" for i, bt in enumerate(lcfg.pattern_groups[0][0])
                    if bt == "cross")
        for key in ("mk", "mv", "k", "v"):
            s = slot if key in ("mk", "mv") else "s0"
            res[f"shard/{key}"] = mine[0][s][key].float().numpy()
            res[f"shard/{key}/one"] = cache[0][s][key].float().numpy()
        res["kv_heads"] = np.array(dec.meta["kv_heads"])
    else:
        # grow_cache keeps a rank's cut state and conv tail as they are
        for arch in RECURRENT:
            cfg = _reduced(arch)
            full = api.init_params(2, cfg, device="cpu")
            pf = steps.build_serve_step(cfg, ShapeConfig("p", 16, 2,
                                                         "prefill"),
                                        mesh, flash=False, device="cpu")
            toks = torch.from_numpy(_tokens(cfg.vocab, 2)[:, :16])
            _, cache = pf.fn(api.shard_tree(full, pf.meta["param_specs"],
                                            mesh), {"tokens": toks})
            grown = grow_cache(cache, cfg, 2, 40)
            e, g = cache[0]["s0"], grown[0]["s0"]
            res[f"grow/{arch}/same"] = np.array(
                [g[k] is e[k] for k in ("state", "conv")])
            res[f"grow/{arch}/state"] = np.array(g["state"].shape)
            _, one = api.prefill(full, cfg, {"tokens": toks})
            res[f"grow/{arch}/state_one"] = np.array(
                one[0]["s0"]["state"].shape)
    np.savez(out / f"torch-unit-{label}-{rank}.npz", **res)


def _cut_flat(grads: dict, mesh) -> dict:
    """{dotted name: whole gradient} cut as ``_cut`` cuts the leaves."""
    nested: dict = {}
    for n, g in grads.items():
        d = nested
        *path, leaf = n.split(".")
        for k in path:
            d = d.setdefault(k, {})
        d[leaf] = g
    out = {}

    def walk(t, prefix=""):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
            else:
                out[prefix + k] = v
    walk(_cut(nested, mesh))
    return out


def _torch_rank(rank: int, out_dir: str) -> None:
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    torch.set_num_threads(1)
    out = Path(out_dir)
    deadline = time.monotonic() + TIMEOUT
    # the meshes of every rank first: ranks 2 and 3 then take the
    # one-rank steps while ranks 0 and 1 run (1, 2)
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
            if label != "2x2":
                _unit_cases(label, mesh, rank, out)
            if label == "1x2":
                _build_cases(mesh, rank, out)
            _serve_cases(label, mesh, rank, out, deadline)
            _train_cases(label, mesh, rank, out, deadline)
        finally:
            dist.destroy_process_group()
    if rank >= 2:
        jobs = [("own", a) for a in FAMILIES] + \
            [("ref", a, m) for a, m in TRAINS]
        _one_rank_steps(jobs[rank - 2::2], rank, out_dir)


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


# -- the JAX reference (subprocesses, forced host devices) --------------------

def _jax_params(cfg):
    """``init_params(key(0))`` with the cross gates at GATE."""
    import jax
    import jax.numpy as jnp

    from repro.models import api
    params = api.init_params(jax.random.key(0), cfg)
    return _jax_gates(params, cfg, lambda g: jnp.full_like(g, GATE))


def _jax_gates(tree, cfg, fn):
    groups = list(tree["groups"])
    for gi, (pat, _) in enumerate(cfg.pattern_groups):
        for i, bt in enumerate(pat):
            if bt == "cross":
                slot = dict(groups[gi][f"s{i}"])
                slot["gate"] = fn(slot["gate"])
                groups[gi] = {**groups[gi], f"s{i}": slot}
    return {**tree, "groups": tuple(groups)}


def _jax_mesh(label: str):
    import jax
    from jax.sharding import Mesh
    return Mesh(np.array(jax.devices()[:_world(label)]).reshape(
        MESHES[label]), ("data", "model"))


def jax_serve(out_dir: str, label: str) -> None:
    """At ``label``'s mesh, each serve case: the arch's weights and stubs
    (written first), the logits of the prefill and teacher-forced decode
    programs, and a recurrent arch's prefill cache."""
    import jax
    import jax.numpy as jnp

    from repro.configs.base import ShapeConfig, get_arch
    from repro.data import pipeline
    from repro.launch import steps
    from repro.models import api
    out = Path(out_dir)
    mesh = _jax_mesh(label)
    total = PROMPT + DEC
    for arch, variant in _serves(label):
        seq = variant == "seq"
        # the reference reads its q8 switch when it builds a program
        os.environ.pop("REPRO_QUANTIZED_GATHER", None)
        if variant == "q8":
            os.environ["REPRO_QUANTIZED_GATHER"] = "1"
        cfg = get_arch(arch).reduced()
        params = _jax_params(cfg)
        stubs = pipeline.add_modality_stubs({}, cfg, SB)
        if not variant:
            np.savez(out / "tmp-serve.npz", **_flat_jax(params, "params"),
                     **_flat_jax(stubs, "stubs"))
            os.replace(out / "tmp-serve.npz",
                       out / f"jax-{label}-{arch}-serve-params.npz")
        b = 1 if seq else SB
        toks = jnp.asarray(_tokens(cfg.vocab, b))
        batch = {"tokens": toks[:, :PROMPT],
                 **{k: v[:b] for k, v in stubs.items()}}
        dec = steps.build_serve_step(cfg, ShapeConfig("d", total, b,
                                                      "decode"), mesh)
        p = jax.device_put(params, dec.meta["param_shardings"])
        if seq:
            logits, cache = jax.jit(lambda q, x, _c=cfg: api.prefill(
                q, _c, x))(params, batch)
        else:
            pf = steps.build_serve_step(cfg, ShapeConfig("p", PROMPT, b,
                                                         "prefill"), mesh)
            logits, cache = pf.fn(p, batch)
            if arch in RECURRENT:
                np.savez(out / f"jax-{label}-{arch}-cache.npz", **{
                    f"{k}/{key}": np.asarray(t, np.float32)
                    for k, e in cache[0].items() for key, t in e.items()
                    if key in ("state", "conv")})
        like = api.cache_specs(cfg, b, total)
        cache = jax.tree.map(lambda c, lk: c if c.shape == lk.shape else
                             jnp.pad(c, [(0, x - y) for y, x in
                                         zip(c.shape, lk.shape)]),
                             cache, like)
        every = [logits]
        for i in range(DEC):
            # placed again each step: the decode program returns the
            # recurrent conv tails cut over "model" (GSPMD's choice) and
            # then refuses them as its input
            cache = jax.device_put(cache, dec.meta["cache_shardings"])
            logits, cache = dec.fn(p, toks[:, PROMPT + i],
                                   jnp.int32(PROMPT + i), cache)
            every.append(logits)
        np.save(out / f"jax-{label}-{_tag(arch, variant)}.npy",
                np.stack([np.asarray(x.astype(jnp.float32)) for x in every]))
    os.environ.pop("REPRO_QUANTIZED_GATHER", None)
    print("JAX_REFERENCE_DONE")


def jax_train(out_dir: str, part: str) -> None:
    """The (2, 2) train cases of ``JAX_TRAINS[part]``: each state before
    (``init_state``, the cross gates at GATE in the params and the
    masters) and its batch, then its one netrpc step."""
    import jax
    import jax.numpy as jnp

    from repro.configs.base import ShapeConfig, get_arch
    from repro.core.inc_agg import IncAggConfig
    from repro.data import pipeline
    from repro.launch import steps
    from repro.optim.adamw import AdamWConfig
    out = Path(out_dir)
    mesh = _jax_mesh("2x2")
    for arch, mode in JAX_TRAINS[part]:
        cfg = get_arch(arch).reduced()
        prog = steps.build_train_step(
            cfg, ShapeConfig("t", SEQ, BATCH, "train"), mesh,
            inc=IncAggConfig(mode="netrpc", precision=PRECISION),
            opt_cfg=AdamWConfig(**OPT), n_micro=N_MICRO, mode=mode,
            donate=False)
        batch = pipeline.add_modality_stubs(pipeline.make_batch(
            pipeline.DataConfig(vocab=cfg.vocab, batch=BATCH, seq_len=SEQ,
                                kind="bigram"), STEP), cfg, BATCH)
        params, opt = steps.init_state(prog, cfg)
        params = jax.device_put(_jax_gates(
            params, cfg, lambda g: jnp.full_like(g, GATE)),
            prog.meta["param_shardings"])
        o_shard = prog.meta["opt_shardings"]
        opt = jax.device_put({**opt, "master": _jax_gates(
            opt["master"], cfg, lambda g: jnp.full_like(g, GATE))},
            {"master": o_shard, "m": o_shard, "v": o_shard})
        tag = _train_tag(arch, mode)
        _save_init(out, f"jax-train-{tag}-init.npz", (params, opt), batch)
        p2, o2, m = prog.fn(params, opt, batch, jnp.int32(STEP))
        np.savez(out / f"jax-train-{tag}.npz", **_flat_jax(p2, "params"),
                 **_flat_jax(o2, "opt"),
                 **{k: np.float32(v) for k, v in m.items()})
    print("JAX_REFERENCE_DONE")


def _start_jax(out_dir: Path, fn: str, arg: str) -> subprocess.Popen:
    env = {k: v for k, v in os.environ.items()
           if k not in ("REPRO_QUANTIZED_GATHER", "REPRO_FLASH_ATTN")}
    env["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                        "--xla_cpu_multi_thread_eigen=false "
                        "intra_op_parallelism_threads=1")
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        [SRC, str(Path(__file__).parent), env.get("PYTHONPATH", "")])
    code = ("import test_torch_tp_families as t; "
            f"t.{fn}({json.dumps(str(out_dir))}, {arg!r})")
    return subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = tmp_path_factory.mktemp("tp_families")
    refs = {part: _start_jax(out, "jax_train", part) for part in JAX_TRAINS}
    refs.update({label: _start_jax(out, "jax_serve", label)
                 for label in MESHES})
    try:
        _run_torch_ranks(out)
        for name, ref in refs.items():
            stdout, stderr = ref.communicate(timeout=TIMEOUT)
            assert ref.returncode == 0 and "JAX_REFERENCE_DONE" in stdout, \
                f"JAX reference {name} failed:\n{stdout}\n{stderr}"
    finally:
        for ref in refs.values():
            if ref.poll() is None:
                ref.kill()
                ref.communicate()
    return out


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


# -- serve --------------------------------------------------------------------

SERVE_CASES = [(label, _tag(*case)) for label in MESHES
               for case in _serves(label)]


@pytest.mark.parametrize("mesh,case", SERVE_CASES)
def test_serve_matches_reference(results, mesh, case):
    """The prefill's logits and each decode step's, the same on every
    rank, within ``LOGIT_TOL`` of the reference's programs at the same
    mesh."""
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


@pytest.mark.parametrize("mesh,arch", [(m, a) for m in MESHES
                                       for a in RECURRENT])
def test_recurrent_cache_matches_reference(results, mesh, arch):
    """Each rank's prefill cache: the state is its cut of the reference's
    (dim 1, the SSD heads or the RG-LRU width, over "model" when it
    splits), the conv tail the reference's whole tail (gathered over the
    axis), within ``LOGIT_TOL``."""
    want = dict(np.load(results / f"jax-{mesh}-{arch}-cache.npz"))
    nd, nm = MESHES[mesh]
    for r in range(_world(mesh)):
        got = dict(np.load(results / f"torch-{mesh}-{arch}-cache-{r}.npz"))
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            w = np.split(w, nd, axis=1)[r // nm]           # the data rows
            if k.endswith("/state"):
                w = np.split(w, nm, axis=2)[r % nm]
            assert got[k].shape == w.shape, (r, k)
            assert _rel(got[k], w) < LOGIT_TOL, (mesh, r, k)


# -- the train step -----------------------------------------------------------

@pytest.mark.parametrize("arch,mode", TRAINS)
def test_step_matches_reference_at_2x2(results, arch, mode):
    """The (2, 2) step against the reference's at the same mesh with
    ``test_torch_multirank.py``'s bounds on the loss, the global norm, the
    learning rate and the masters' update. Its per-leaf bound on m and v
    (5% of the norm) the reference's own (2, 2) step does not meet against
    its one-device step from the same state (v of the reduced llama's
    cross gate and of recurrentgemma's RG-LRU ``wi``, on this JAX:
    ``scripts/tp_reference_drift.py``): m and v are held in
    ``test_step_at_2x2_matches_one_rank``."""
    tag = _train_tag(arch, mode)
    got = dict(np.load(results / f"torch-2x2-{tag}.npz"))
    want = dict(np.load(results / f"jax-train-{tag}.npz"))
    assert np.float32(got["lr"]).view(np.int32) == \
        np.float32(want["lr"]).view(np.int32), tag
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=2e-4,
                               err_msg=tag)
    np.testing.assert_allclose(got["gnorm"], want["gnorm"], rtol=1e-3,
                               err_msg=tag)
    lr = float(want["lr"])
    d = np.concatenate([np.abs(got[k].astype(np.float64) - want[k]).ravel()
                        for k in want if k.startswith("opt/master/")])
    assert d.max() <= 2.5 * lr, (tag, d.max() / lr)
    assert (d > lr / 100).mean() <= 0.01, tag


@pytest.mark.parametrize("arch,mode", TRAINS)
def test_step_at_2x2_matches_one_rank(results, arch, mode):
    """The (2, 2) step, gathered whole, against the port's one-rank step
    from the same state (the reference's), with every bound of
    ``test_torch_multirank.py`` (m and v per leaf, each param its own
    master rounded)."""
    tag = _train_tag(arch, mode)
    got = dict(np.load(results / f"torch-2x2-{tag}.npz"))
    want = dict(np.load(results / f"torch-one-2x2-{tag}.npz"))
    _hold_to_reference(got, want, f"{tag} at 2x2")


@pytest.mark.parametrize("mesh,arch", [(m, a) for m in ("1x2", "1x4")
                                       for a in FAMILIES])
def test_step_matches_one_rank(results, mesh, arch):
    """The tensor-parallel step from the port's own state, gathered whole,
    against the port's one-rank step from the same state, at
    ``test_torch_multirank.py``'s tolerances."""
    got = dict(np.load(results / f"torch-{mesh}-"
                       f"{_train_tag(arch, MODE[arch])}.npz"))
    want = dict(np.load(results / f"torch-one-{arch}.npz"))
    _hold_to_reference(got, want, f"{arch} at {mesh}")


# -- every config builds ------------------------------------------------------

@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_every_config_builds_over_a_model_axis(results, arch):
    """The train, prefill and decode programs of every config (reduced)
    build at (1, 2): ``steps._model_axis`` raises for none, and every
    block type of the config is in ``blocks.TP_BLOCKS``."""
    built = json.loads((results / "torch-build.json").read_text())
    assert sorted(built) == sorted(ALL_ARCHS)
    assert built[arch] == "built", built[arch]


# -- units --------------------------------------------------------------------

@pytest.fixture(scope="module")
def units(results):
    return {label: [dict(np.load(results / f"torch-unit-{label}-{r}.npz"))
                    for r in range(_world(label))]
            for label in ("1x2", "1x4")}


def test_sum_model_forward_and_backward(units):
    """At model 4, each rank's x_r and cotangent c_r: sum_model gives
    sum_r x_r and passes sum_r c_r back (``from_model`` alone would pass
    c_r)."""
    xs = [torch.randn((3, 5), generator=torch.Generator().manual_seed(r))
          .numpy() for r in range(4)]
    cts = [torch.randn((3, 5), generator=torch.Generator().manual_seed(
        100 + r)).numpy() for r in range(4)]
    for res in units["1x4"]:
        np.testing.assert_allclose(res["sum/y"], sum(xs), rtol=1e-5)
        np.testing.assert_allclose(res["sum/grad"], sum(cts), rtol=1e-5)


def _hold_unit(res: dict, name: str, where: str, tol: float) -> None:
    assert res[f"{name}/y"].shape == res[f"{name}/y_one"].shape
    assert _rel(res[f"{name}/y"], res[f"{name}/y_one"]) < tol, \
        (where, name, "y")
    assert _rel(res[f"{name}/dx"], res[f"{name}/dx_one"]) < tol, \
        (where, name, "dx")
    leaves = [k.split("/g/", 1)[1] for k in res if k.startswith(f"{name}/g/")]
    assert leaves
    for n in leaves:
        got, want = res[f"{name}/g/{n}"], res[f"{name}/g_one/{n}"]
        assert got.shape == want.shape, (where, name, n)
        assert _rel(got, want) < tol, (where, name, n)


# (unit, tolerance): fp32 ones at UNIT_TOL, bf16 ones (the compute dtype
# of the memory and the encoder) at LOGIT_TOL
UNIT_TOLS = {"gelu": UNIT_TOL, "ssd": UNIT_TOL, "mproj": LOGIT_TOL,
             "encode": LOGIT_TOL}
UNITS = [(label, name) for label in ("1x2", "1x4") for name in UNIT_TOLS]


@pytest.mark.parametrize("mesh,name", UNITS)
def test_unit_matches_one_rank(units, mesh, name):
    """Against the whole leaves with no axis, output, input gradient and
    each leaf's gradient (the rank's cut of the whole one), in fp32 or,
    for the memory and the encoder, bf16:

      gelu    the GELU MLP with drawn biases: b2 whole, added once after
              the sum over the axis;
      ssd     the ``ssd`` block with drawn norm scale, D, A_log, dt_bias
              and conv biases: the gated norm's sum of squares summed over
              the axis both ways, B and C through ``to_model`` (whole
              gradients of w_B, w_C and their convs; x's not counted
              twice);
      mproj   the VLM's memory: mproj's columns gathered after their
              product, its gradient the rank's columns;
      encode  whisper's encoder (2 ``bidir`` layers) with a drawn final
              norm scale, gathered whole before the norm, its gradient
              the rank's slice."""
    for r, res in enumerate(units[mesh]):
        _hold_unit(res, name, f"{mesh} rank {r}", UNIT_TOLS[name])


def test_shard_cache_narrows_the_memory_kv_in_the_mixed_case(units):
    """Reduced llama at model 4 (4 query heads, 2 KV heads): a decode
    cache cut by ``shard_cache`` holds, in the self K/V and in a cross
    layer's memory K/V, the one KV head rank r's query head reads
    (r // 2)."""
    for r, res in enumerate(units["1x4"]):
        assert tuple(res["kv_heads"]) == (r // 2, 1)
        for key in ("k", "v", "mk", "mv"):
            got, one = res[f"shard/{key}"], res[f"shard/{key}/one"]
            assert got.shape[3] == 1, key
            assert got.tobytes() == one[:, :, :, r // 2:r // 2 + 1] \
                .copy().tobytes(), (r, key)


@pytest.mark.parametrize("arch", RECURRENT)
def test_grow_cache_keeps_a_cut_state(units, arch):
    """At model 2 a rank's prefill cache holds half the state (the SSD
    heads, the RG-LRU width) and the whole conv tail: ``grow_cache``
    keeps both as they are (padding the state to the config's width
    would hand the decode a state of the wrong heads)."""
    for res in units["1x2"]:
        assert res[f"grow/{arch}/same"].all()
        cut, whole = res[f"grow/{arch}/state"], res[f"grow/{arch}/state_one"]
        assert cut[2] * 2 == whole[2] and np.delete(cut, 2).tolist() == \
            np.delete(whole, 2).tolist()


def test_ssd_gradient_is_finite_past_the_decay_overflow():
    """The reduced mamba2-780m at 128 positions (one SSD chunk of
    that length): above the diagonal the within-chunk decay's exponent
    passes 88 and ``exp`` overflows. The reference takes
    ``where(tril, exp(diff), 0)``, whose gradient there is NaN; the port
    masks before the ``exp``: the same loss (within ``LOGIT_TOL``'s
    relative bound) and a finite gradient."""
    import jax
    import jax.numpy as jnp

    from repro.configs.base import get_arch as jget
    from repro.models import api as japi
    from repro_torch.models import api
    cfg = _reduced(MAMBA)
    jparams = japi.init_params(jax.random.key(0), jget(MAMBA).reduced())
    params = _from_file(_flat_jax(jparams, "params"), "params",
                        api.param_shapes(cfg))
    toks = np.random.RandomState(1).randint(
        0, cfg.vocab, (2, 129)).astype(np.int32)
    jcfg = jget(MAMBA).reduced()
    jloss, jgrad = jax.jit(jax.value_and_grad(lambda p, x: japi.train_loss(
        p, jcfg, {"tokens": x})[0]))(jparams, jnp.asarray(toks))
    assert any(bool(jnp.isnan(g).any()) for g in jax.tree.leaves(jgrad))
    leaves = [t.requires_grad_(True) for _, t in api.named_leaves(params)]
    loss, _ = api.train_loss(params, cfg, {"tokens": torch.from_numpy(toks)})
    grads = torch.autograd.grad(loss, leaves)
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert abs(float(loss) / float(jloss) - 1) < LOGIT_TOL
