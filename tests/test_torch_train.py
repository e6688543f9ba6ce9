"""The train step of the port on one rank (``launch/steps.py``,
``launch/train.py``, ``models/api.py:train_loss``) against the JAX
package; mirrors ``test_train_integration.py`` on reduced qwen2.5-3b with
a ``(data=1, model=1)`` gloo mesh.

One step from the same params, optimizer state and tokens (the
reference's, carried across) in every ``inc_mode``. Tolerances, and why:
the model runs in bf16 (test_torch_model.py holds its logits within
LOGIT_TOL), and XLA and PyTorch round its products and sums at other
places, so the gradients differ in their last bf16 bits:

  lr          bitwise (the same fp32 schedule);
  loss        rtol 2e-4 (measured 5.7e-5);
  gnorm       rtol 1e-3 (measured 1.2e-4);
  m, v        per leaf, ||got - want|| <= 5e-2 ||want|| (measured 2.4e-2
              at worst, on the k bias);
  master      every element within 2.5 lr of the reference's (one AdamW
              step moves an element by about lr, so a gradient whose
              sign differs between the two packages moves it about 2 lr
              apart), and at most 1% of the elements more than lr/100
              apart (measured 0.27-0.40%);
  params      the bf16 rounding of each package's own master, and at
              most 1% of the elements differ (measured 0.3%).
"""
import os
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch import compat
from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.configs.base import ShapeConfig, get_arch
from repro_torch.core.inc_agg import MODES, IncAggConfig
from repro_torch.data import pipeline
from repro_torch.launch import steps
from repro_torch.launch.mesh import one_rank_group
from repro_torch.launch.train import drawn_ahead, train_loop
from repro_torch.models import api
from repro_torch.optim.adamw import AdamWConfig

ARCH, SEQ, BATCH, N_MICRO, PRECISION = "qwen2.5-3b", 64, 4, 2, 7


@pytest.fixture(scope="module")
def mesh():
    with one_rank_group(torch.device("cpu")):
        yield compat.make_mesh((1, 1), ("data", "model"), device="cpu")


def build(mesh, inc_mode="netrpc"):
    cfg = get_arch(ARCH).reduced()
    shape = ShapeConfig("t", seq_len=SEQ, global_batch=BATCH, kind="train")
    prog = steps.build_train_step(
        cfg, shape, mesh, inc=IncAggConfig(mode=inc_mode,
                                           precision=PRECISION),
        opt_cfg=AdamWConfig(warmup_steps=2, total_steps=100),
        n_micro=N_MICRO, device="cpu")
    return cfg, prog


def run_steps(cfg, prog, params, opt, start, n):
    dcfg = pipeline.DataConfig(vocab=cfg.vocab, batch=BATCH, seq_len=SEQ,
                               kind="bigram")
    losses = []
    for s in range(start, start + n):
        b = pipeline.add_modality_stubs(pipeline.make_batch(dcfg, s), cfg,
                                        BATCH)
        params, opt, m = prog.fn(params, opt, b, s)
        losses.append(float(m["loss"]))
    return params, opt, losses


def _np(tree) -> dict:
    """A port tree as {"groups/0/s0/attn/wq": fp32 numpy}."""
    return {n.replace(".", "/"): t.detach().float().numpy()
            for n, t in api.named_leaves(tree)}


def _jnp(tree) -> dict:
    import jax
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in p): np.asarray(x, np.float32)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _reference(mode: str, step: int, arch: str = ARCH, prepare=None):
    """The reference's state before and after one step, and its
    tokens (with its frames or patches for an arch that has them);
    ``prepare(params, opt)`` returns the state to step from."""
    import jax
    import jax.numpy as jnp

    from repro import compat as jcompat
    from repro.configs.base import ShapeConfig as JShape, get_arch as jget
    from repro.core.inc_agg import IncAggConfig as JInc
    from repro.data import pipeline as jpipeline
    from repro.launch import steps as jsteps
    from repro.optim.adamw import AdamWConfig as JOpt
    jmesh = jcompat.make_mesh((1, 1), ("data", "model"))
    cfg = jget(arch).reduced()
    prog = jsteps.build_train_step(
        cfg, JShape("t", SEQ, BATCH, "train"), jmesh,
        inc=JInc(mode=mode, precision=PRECISION),
        opt_cfg=JOpt(warmup_steps=2, total_steps=100), n_micro=N_MICRO,
        donate=False)
    params, opt = jsteps.init_state(prog, cfg)
    if prepare is not None:
        params, opt = prepare(params, opt)
    dcfg = jpipeline.DataConfig(vocab=cfg.vocab, batch=BATCH, seq_len=SEQ,
                                kind="bigram")
    batch = jpipeline.add_modality_stubs(jpipeline.make_batch(dcfg, step),
                                         cfg, BATCH)
    tokens = np.array(batch["tokens"])
    before = (jax.tree.map(np.asarray, params),
              jax.tree.map(np.asarray, opt))
    p2, o2, m = prog.fn(params, opt, batch, jnp.int32(step))
    if arch != ARCH:
        tokens = {k: np.array(v) for k, v in batch.items()}
    return before, tokens, (p2, o2, {k: float(v) for k, v in m.items()})


@pytest.mark.parametrize("mode", MODES)
def test_step_matches_reference(mesh, mode):
    step = 3
    (np_p, np_o), tokens, (jp, jo, jm) = _reference(mode, step)
    cfg, prog = build(mesh, mode)
    params = api.params_from_jax(np_p, "cpu")
    opt = api.opt_from_jax(np_o, "cpu")
    params, opt, m = prog.fn(params, opt,
                             {"tokens": torch.from_numpy(tokens)}, step)
    assert np.float32(m["lr"]).view(np.int32) == \
        np.float32(jm["lr"]).view(np.int32)
    np.testing.assert_allclose(float(m["loss"]), jm["loss"], rtol=2e-4)
    np.testing.assert_allclose(float(m["gnorm"]), jm["gnorm"], rtol=1e-3)
    lr = jm["lr"]
    for k in ("m", "v"):
        got, want = _np(opt[k]), _jnp(jo[k])
        assert got.keys() == want.keys()
        for name in want:
            err = np.linalg.norm(got[name] - want[name])
            assert err <= 5e-2 * np.linalg.norm(want[name]) + 1e-30, \
                (k, name)
    got, want = _np(opt["master"]), _jnp(jo["master"])
    d = np.concatenate([np.abs(got[n].astype(np.float64) - want[n]).ravel()
                        for n in want])
    assert d.max() <= 2.5 * lr, d.max() / lr
    assert (d > lr / 100).mean() <= 0.01
    gp, wp = _np(params), _jnp(jp)
    n_diff = 0
    for name in wp:
        key = name.replace("/", ".")
        mine = opt["master"].get_parameter(key).to(
            params.get_parameter(key).dtype)
        assert np.array_equal(gp[name], mine.float().numpy()), name
        n_diff += int((gp[name] != wp[name]).sum())
    assert n_diff <= 0.01 * sum(v.size for v in wp.values())


def test_loss_decreases_on_bigram(mesh):
    cfg, prog = build(mesh)
    params, opt = steps.init_state(prog, cfg)
    _, _, losses = run_steps(cfg, prog, params, opt, 0, 15)
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0], losses


def test_checkpoint_restart_is_bitwise_deterministic(mesh, tmp_path):
    cfg, prog = build(mesh)
    params, opt = steps.init_state(prog, cfg)

    # straight 8-step run
    p_a, _, straight = run_steps(cfg, prog, params, opt, 0, 8)

    # 4 steps -> checkpoint -> restore -> 4 more (same data cursor)
    params, opt = steps.init_state(prog, cfg)
    p4, o4, first = run_steps(cfg, prog, params, opt, 0, 4)
    store = CheckpointStore(tmp_path)
    store.save(3, {"params": p4, "opt": o4}, async_=False)
    rest = store.restore(3, {"params": p4, "opt": o4})
    p_b, _, second = run_steps(cfg, prog, rest["params"], rest["opt"], 4, 4)

    assert straight[:4] == first
    assert straight[4:] == second
    for (na, a), (nb, b) in zip(api.named_leaves(p_a), api.named_leaves(p_b)):
        assert na == nb and a.dtype == b.dtype and torch.equal(a, b), na


def test_exactly_once_skips_reapplied_step(mesh, tmp_path):
    store = CheckpointStore(tmp_path)
    store.save(5, {"x": np.zeros(1)}, async_=False)
    replayed = [s for s in range(8) if not store.already_applied(s)]
    assert replayed == [6, 7]     # steps <= 5 are retransmissions


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_model_checkpoint_crosses_packages(tmp_path, writer):
    """A params + optimizer checkpoint written by one package restores
    bit for bit in the other (bf16 stored as fp32, the same key paths)."""
    import jax

    from repro.checkpoint.store import CheckpointStore as JStore
    (np_p, np_o), _, _ = _reference("fp32-ring", 0)
    jtrees = {"params": jax.tree.map(np.asarray, np_p),
              "opt": jax.tree.map(np.asarray, np_o)}
    ttrees = {"params": api.params_from_jax(np_p, "cpu"),
              "opt": api.opt_from_jax(np_o, "cpu")}
    if writer == "port":
        CheckpointStore(tmp_path).save(7, ttrees, async_=False)
        out = JStore(tmp_path).restore(7, jtrees)
        got = {"params": _jnp(out["params"]), "opt": _jnp(out["opt"])}
    else:
        JStore(tmp_path).save(7, jtrees, async_=False)
        out = CheckpointStore(tmp_path).restore(7, ttrees)
        assert isinstance(out["params"], api.Tree)
        assert out["params"]["embed"].dtype == torch.bfloat16
        got = {"params": _np(out["params"]),
               "opt": {f"{k}/{n}": v for k in ("m", "master", "v")
                       for n, v in _np(out["opt"][k]).items()}}
    want = {"params": _jnp(jtrees["params"]), "opt": _jnp(jtrees["opt"])}
    for tree in want:
        assert got[tree].keys() == want[tree].keys()
        for name, w in want[tree].items():
            assert np.array_equal(got[tree][name], w), (tree, name)


def test_stage_clock_times_each_stage(mesh):
    """The step's clock marks its three stages (on the CPU with the host
    clock)."""
    cfg, prog = build(mesh)
    run_steps(cfg, prog, *steps.init_state(prog, cfg), 0, 1)
    ms = prog.meta["clock"].ms()
    assert tuple(ms) == steps.STAGES and all(v > 0 for v in ms.values())


def test_train_loop_resumes_exactly_once(tmp_path):
    """The loop on the CPU: every step votes and commits, the telemetry
    counts the steps; a second run over the same checkpoint directory
    restores the last step and runs nothing again."""
    kw = dict(arch=ARCH, inc_mode="netrpc", seq=16, batch=2, reduced=True,
              device="cpu", ckpt_dir=str(tmp_path), log_every=100)
    out = train_loop(steps_n=3, **kw)
    assert len(out["losses"]) == 3 and all(np.isfinite(out["losses"]))
    inc = out["inc_telemetry"]
    assert inc["commits"] == 3 and inc["metrics"]["steps"] == 3.0
    assert out["entropy_floor"] is not None and out["entropy_floor"] > 0
    again = train_loop(steps_n=3, **kw)
    assert again["losses"] == []
    for (_, a), (_, b) in zip(api.named_leaves(out["params"]),
                              api.named_leaves(again["params"])):
        assert torch.equal(a, b)


def test_train_loop_draws_batches_ahead(monkeypatch):
    """The loop takes each step's batch from ``drawn_ahead``: drawn once,
    on a host thread other than the loop's, ahead of its step (the
    reference draws on its device; a bigram batch at train_mini's vocab
    takes several train_mini steps on one thread of the card's host), and
    equal to ``make_batch`` of its own step."""
    dcfg = pipeline.DataConfig(vocab=64, batch=2, seq_len=8, seed=3)
    run = [0, 2] + list(range(5, 25))
    got = list(drawn_ahead(dcfg, run))
    assert [s for s, _ in got] == run
    for s, b in got:
        assert torch.equal(b["tokens"], pipeline.make_batch(dcfg, s)["tokens"])
    seen = []
    make = pipeline.make_batch

    def spy(dcfg, s):
        seen.append((s, threading.current_thread() is
                     threading.main_thread()))
        return make(dcfg, s)
    monkeypatch.setattr(pipeline, "make_batch", spy)
    out = train_loop(arch=ARCH, inc_mode="netrpc", steps_n=4, seq=16,
                     batch=2, reduced=True, device="cpu", log_every=100)
    assert len(out["losses"]) == 4
    assert sorted(s for s, _ in seen) == [0, 1, 2, 3]
    assert not any(main for _, main in seen)


@pytest.mark.parametrize("draw_s, step_s, most, deepest", [
    (0.0, 0.05, 4, 1),      # a draw far shorter than a step: one ahead
    (0.3, 0.005, 3, 3),     # far longer: as deep as allowed
])
def test_drawn_ahead_depth_follows_draw_and_step(monkeypatch, draw_s,
                                                 step_s, most, deepest):
    """``drawn_ahead`` draws as deep as ceil(draw / step), within
    ``most``, the host's cores less the loop's own. The depth after the first step follows the first draw,
    which may be dear (it builds the chain's table), and reaches at most
    step ``most + 1``; from there on, the draws in flight at once are one
    where a draw is cheap, and ``most`` where it is dear."""
    lock, live, peak = threading.Lock(), [0], [0]
    make = pipeline.make_batch

    def slow(dcfg, s):
        with lock:
            live[0] += 1
            if s > most + 1:
                peak[0] = max(peak[0], live[0])
        time.sleep(draw_s)
        with lock:
            live[0] -= 1
        return make(dcfg, s)
    monkeypatch.setattr(pipeline, "make_batch", slow)
    monkeypatch.setattr(os, "cpu_count", lambda: most + 1)
    dcfg = pipeline.DataConfig(vocab=16, batch=1, seq_len=4, seed=0)
    for _ in drawn_ahead(dcfg, list(range(12))):
        time.sleep(step_s)
    assert peak[0] == deepest
def test_train_defaults_to_the_card():
    """Without a card, the train loop raises unless given device='cpu';
    the fsdp mode builds (grok's by ``mode_for``)."""
    if torch.cuda.is_available():
        assert steps.Program is not None
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train_loop(arch=ARCH, inc_mode="netrpc", steps_n=1, seq=8,
                       batch=2, reduced=True)
    with one_rank_group(torch.device("cpu")):
        m = compat.make_mesh((1, 1), ("data", "model"), device="cpu")
        cfg = get_arch("grok-1-314b").reduced()
        kw = dict(inc=IncAggConfig(), opt_cfg=AdamWConfig(), device="cpu")
        prog = steps.build_train_step(cfg, ShapeConfig("t", 8, 2, "train"),
                                      m, **kw)
        assert prog.meta["mode"] == "fsdp"


def test_loss_and_remat_match_reference():
    """train_loss on the reference's params and tokens, with and without
    remat: remat changes nothing in the port (bitwise), and the loss is
    the reference's within bf16 rounding (rtol 2e-4)."""
    import jax
    import jax.numpy as jnp

    from repro.configs.base import get_arch as jget
    from repro.models import api as japi
    cfg = jget(ARCH).reduced()
    jp = japi.init_params(jax.random.key(1), cfg)
    rng = np.random.RandomState(1)
    toks = rng.randint(0, cfg.vocab, (2, 33)).astype(np.int32)
    want, _ = japi.train_loss(jp, cfg, {"tokens": jnp.asarray(toks)})
    params = api.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    tcfg = get_arch(ARCH).reduced()
    got, metrics = api.train_loss(params, tcfg,
                                  {"tokens": torch.from_numpy(toks)})
    plain, _ = api.train_loss(params, tcfg, {"tokens": torch.from_numpy(toks)},
                              remat=False)
    assert torch.equal(got, plain)
    assert float(metrics["aux"]) == 0.0
    np.testing.assert_allclose(float(got), float(want), rtol=2e-4)


def test_scatter_dims_match_reference():
    import jax
    from functools import partial

    from repro.configs.base import get_arch as jget
    from repro.launch import steps as jsteps
    from repro.models import api as japi
    for arch in ("qwen2.5-3b", "phi4-mini-3.8b"):
        jcfg = jget(arch)
        shapes = jax.eval_shape(partial(japi.init_params, cfg=jcfg),
                                jax.random.key(0))
        tshapes = api.param_shapes(get_arch(arch))
        for n_dp, n_model in ((1, 1), (2, 1), (4, 2), (16, 16)):
            want = jsteps.scatter_dims_tree(shapes, n_dp, n_model)
            got = steps.scatter_dims_tree(tshapes, n_dp, n_model)
            flat = {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                             for k in p): d for p, d in
                    jax.tree_util.tree_flatten_with_path(want)[0]}
            assert {k.replace(".", "/"): v for k, v in got.items()} == flat
        for b, s in ((256, 4096), (8, 128), (1, 32_768)):
            shape = ShapeConfig("t", s, b, "train")
            from repro.configs.base import ShapeConfig as JShape
            assert steps.default_n_micro(get_arch(arch), shape, 16) == \
                jsteps.default_n_micro(jcfg, JShape("t", s, b, "train"), 16)


def _spec_leaves(tree, prefix="") -> dict:
    """A nest of dicts and tuples (the port's meta tensors, the
    reference's ShapeDtypeStructs) as {"cache/0/s0/k": leaf}."""
    if not isinstance(tree, (dict, tuple, list)):
        return {prefix: tree}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_spec_leaves(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_input_specs_match_reference(kind):
    """input_specs: meta tensors with the reference's inputs' shapes and
    dtypes, leaf for leaf (decode: token, pos and the stacked cache), for
    a text model and for the two families with a memory (the patches of
    the VLM, whisper's frames)."""
    from repro.configs.base import ShapeConfig as JShape
    from repro.configs.base import get_arch as jget
    from repro.models import api as japi

    def spec(leaves):
        return {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
                for k, v in leaves.items()}
    for arch, b, s in ((ARCH, 4, 64), (ARCH, 2, 1024),
                       ("llama-3.2-vision-90b", 4, 64),
                       ("whisper-medium", 2, 448)):
        got = _spec_leaves(api.input_specs(get_arch(arch),
                                           ShapeConfig("t", s, b, kind)))
        want = _spec_leaves(japi.input_specs(jget(arch),
                                             JShape("t", s, b, kind)))
        assert spec(got) == spec(want)
        assert all(t.device.type == "meta" for t in got.values())


# -- repair: flash attention under autograd ------------------------------------

def test_flash_attention_raises_under_autograd():
    """Under autograd a CPU tensor takes the plain version and its
    autograd (the flash train lane; the card's lane is the backward
    kernels), so q gets the plain attention's gradient; what the kernels
    cannot take still raises on the kernels' lanes (meta here: an fp32
    tensor, a head dim they lack), under autograd as without it."""
    from repro_torch.kernels import flash_attn, ops
    q = torch.randn(1, 8, 2, 32, requires_grad=True)
    k = torch.randn(1, 8, 1, 32)
    v = torch.randn(1, 8, 1, 32)
    ops.flash_attention(q, k, v).sum().backward()
    q2 = q.detach().clone().requires_grad_(True)
    flash_attn.flash_attention_plain(q2, k, v).sum().backward()
    assert torch.equal(q.grad, q2.grad) and q.grad.abs().sum() > 0
    with torch.no_grad():
        assert ops.flash_attention(q, k, v).shape == (1, 8, 2, 32)
    assert ops.flash_attention(q.detach(), k, v).shape == (1, 8, 2, 32)
    m = torch.empty(1, 8, 2, 32, device="meta", requires_grad=True)
    with pytest.raises(TypeError, match="bf16"):
        ops.flash_attention(m, m, m)
    m = torch.empty(1, 8, 2, 96, dtype=torch.bfloat16, device="meta",
                    requires_grad=True)
    with pytest.raises(ValueError, match="D in"):
        ops.flash_attention(m, m, m)


def test_block_train_gradients_match_reference():
    """block_train on the plain attention lane (flash=False) under
    autograd: every attention weight gets a gradient, and the gradients
    of sum(out * w) are the reference's within bf16 rounding (each leaf
    within 3e-2 of its max|grad|, about 4 bf16 ulps; measured 1.6e-2 at
    worst)."""
    import jax
    import jax.numpy as jnp

    from repro.configs.base import get_arch as jget
    from repro.models import blocks as jblocks
    from repro_torch.models import blocks
    cfg = jget(ARCH).reduced()
    jp = jblocks.init_block(jax.random.key(3), "global", cfg)
    rng = np.random.RandomState(3)
    x = (rng.randn(2, 16, cfg.d_model)).astype(np.float32)
    w = rng.randn(2, 16, cfg.d_model).astype(np.float32)

    def jloss(p):
        out, _ = jblocks.block_train(
            p, "global", jnp.asarray(x, jnp.bfloat16),
            jblocks.Ctx(cfg=cfg, positions=jnp.arange(16)))
        return jnp.sum(out.astype(jnp.float32) * w)
    jg = _jnp(jax.grad(jloss)(jp))
    tp = api._from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    leaves = []

    def track(d):
        for k, v in d.items():
            if isinstance(v, dict):
                track(v)
            else:
                v.requires_grad_(True)
                leaves.append(v)
    track(tp)
    out, _ = blocks.block_train(
        tp, "global", torch.from_numpy(x).bfloat16(),
        blocks.Ctx(cfg=get_arch(ARCH).reduced(),
                   positions=torch.arange(16)))
    (out.float() * torch.from_numpy(w)).sum().backward()
    names = {"attn/" + k: v for k, v in tp["attn"].items()}
    names.update({"mlp/" + k: v for k, v in tp["mlp"].items()})
    names.update({k: tp[k] for k in ("n1", "n2")})
    assert set(names) == set(jg)
    for name, t in names.items():
        assert t.grad is not None and torch.isfinite(t.grad).all(), name
        got, want = t.grad.float().numpy(), jg[name]
        assert np.abs(got).max() > 0, name
        assert np.abs(got - want).max() <= 3e-2 * np.abs(want).max(), name


def test_new_modules_are_walked():
    """The import test walks the package, so it covers this slice's
    modules: none of them loads JAX or the JAX package."""
    import test_torch_imports
    assert {"repro_torch.optim.adamw", "repro_torch.checkpoint.store",
            "repro_torch.sharding.rules", "repro_torch.core.agreement",
            "repro_torch.launch.train", "repro_torch.kernels.pack_int8"} \
        <= set(test_torch_imports._modules())
