"""The port's ``cross`` block and the VLM memory (llama-3.2-vision-90b)
against the JAX package: the block with a seeded gate, the projected
patches (``mproj``), and the reduced llama-3.2-vision-90b (d_model 64, 4
heads and 2 KV heads of 32, d_ff 128, vocab 512, 16 stub patches, an
untied ``lm_head``) at one pattern unit, 4 ``global`` layers and 1
``cross``, through ``forward``, ``prefill``, ``decode_step`` and
``train_loss``.

Both packages compute from the same weights: the reference's
``init_params`` with the norm scales and the ``cross`` gate seeded (the
gate starts at zero, and tanh(0) = 0 adds nothing of the cross-attention,
so a wrong one would pass), carried across by ``params_from_jax``.
Inputs are seeded numpy. Tolerances are those of
tests/test_torch_model.py: a module within 1 bf16 ULP of the tensor's
largest magnitude, a block within 2, the model's logits and cache by
``max|d| / max|ref|`` below ``LOGIT_TOL`` (2e-2; forward's logits
measured 1.3e-2, two bf16 steps at their largest, 4.2).

Gradients, per leaf by ||d|| / ||ref|| (the largest over 40 weight
draws from scripts/cross_grad_drift.py; "here" is this file's draw):

  fp32       with every bf16 leaf, input and product in fp32 in both
             packages (``COMPUTE_DTYPE`` patched), the two backwards are
             the same math: every leaf, the gate included, within
             ``FP32_GRAD_TOL`` = 1e-4 (1.3e-6 here).
  bf16       the reference's own bf16 gradient lies up to 2.4e-2 from
             that fp32 one: rounding spread through the five layers (the
             cross layer alone drifts 9.0e-3 at most). The port's is as
             close: each leaf
             within ``GRAD_TOL`` = 3e-2 of the reference's (2.6e-2 here,
             2.8e-2 at most) and no farther from the fp32 gradient than
             ``WITNESS_RATIO`` = 2 times the reference's own distance
             (1.19 here, 1.48 at most).
  the gate   a scalar summed over every position and feature, whose
             terms can cancel to near zero, where a relative error says
             nothing: it is held absolutely, within ``GATE_ATOL`` = 1e-3
             of the fp32 gradient (1.1e-4 here, 5.3e-4 at most; the
             reference's 8.5e-4 here, 2.2e-3 at most).
  one layer  the cross layer alone, by its input, its memory and every
             leaf but the gate, within ``BLOCK_GRAD_TOL`` = 2e-2 (6.4e-3
             here, 9.0e-3 at most).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.launch import serve as tserve
from repro_torch.models import api, blocks
from test_torch_model import (LOGIT_TOL, ULP, _bf16, _close_ulp, _j, _jtree,
                              _np, _rel, _t)

ARCH = "llama-3.2-vision-90b"
UNIT = ("global", "global", "global", "global", "cross")
GATE = "groups.0.s4.gate"
GRAD_TOL = 3e-2               # bf16 leaf against the reference's
WITNESS_RATIO = 2.0           # its error against the reference's own
GATE_ATOL = 1e-3              # the gate's bf16 gradient, absolute
FP32_GRAD_TOL = 1e-4          # every leaf, both packages in fp32
BLOCK_GRAD_TOL = 2e-2         # the cross layer alone, in bf16
B, S, D, M = 2, 24, 64, 16     # batch, prompt, d_model, stub patches
KV, HD = 2, 32


def _cfgs():
    from repro.configs.base import get_arch as jget
    from repro_torch.configs.base import get_arch
    jcfg = jget(ARCH).reduced()
    assert jcfg.pattern_groups == ((UNIT, 1),)
    return jcfg, get_arch(ARCH).reduced()


def _np_params(seed=0):
    """The reference's random init as numpy, with every norm scale and
    the cross layer's gate seeded."""
    import jax
    from repro.models import api as japi
    jcfg, _ = _cfgs()
    params = jax.tree.map(np.asarray,
                          japi.init_params(jax.random.key(seed), jcfg))
    rng = np.random.RandomState(seed + 100)

    def seeded(a, scale, offset=0.0):
        return (rng.randn(*a.shape) * scale + offset).astype(np.float32)
    for slot in params["groups"][0].values():
        for name in ("n1", "n2"):
            slot[name] = seeded(slot[name], 0.2)
    cross = params["groups"][0]["s4"]
    cross["gate"] = seeded(cross["gate"], 0.2, 0.6)
    params["final_norm"] = seeded(params["final_norm"], 0.2)
    return params


@pytest.fixture(scope="module")
def weights():
    return _np_params()


def _cross_layer(np_params):
    import jax
    lp = jax.tree.map(lambda a: a[0], np_params["groups"][0]["s4"])
    tp = api._layer(api.params_from_jax(np_params, "cpu")["groups"][0]["s4"],
                    0)
    return lp, tp


def _patches(seed, b=B):
    return _bf16(np.random.RandomState(seed), b, M, D)


def _leaves(cache):
    return {f"{gi}/{s}/{k}": v for gi, g in enumerate(cache)
            for s, e in g.items() for k, v in e.items()}


# -- the cross block and the memory -------------------------------------------

def test_mproj_memory_matches_reference(weights):
    """The memory: the bf16 patches times ``mproj``, within 1 ULP."""
    from repro.models import api as japi
    jcfg, cfg = _cfgs()
    patches = _patches(1)
    want = japi._memory(_jtree(weights), jcfg, {"patches": _j(patches)})
    got = api._memory(api.params_from_jax(weights, "cpu"), cfg,
                      {"patches": _t(patches)})
    assert got.shape == (B, M, D) and got.dtype == torch.bfloat16
    _close_ulp(got, want)


def test_cross_block_matches_reference(weights):
    """The cross block with its seeded gate: train and prefill (no flash
    launch on the flash lane; the cache the memory's K/V), then a decode
    step against those K/V, which it does not write: within 2 ULP. At
    gate 0 the block adds only its MLP, so the gate matters."""
    from repro.models import blocks as jblocks
    jcfg, cfg = _cfgs()
    lp, tp = _cross_layer(weights)
    assert float(tp["gate"]) != 0.0
    assert set(tp) == {"n1", "n2", "xattn", "gate", "mlp"}
    rng = np.random.RandomState(2)
    x, mem = _bf16(rng, B, S, D), _bf16(rng, B, M, D)
    jctx = jblocks.Ctx(cfg=jcfg, positions=_j(np.arange(S), np.int32),
                       memory=_j(mem))
    ctx = blocks.Ctx(cfg=cfg, positions=torch.arange(S), memory=_t(mem),
                     flash=True)
    want, wc = jblocks.block_prefill(_jtree(lp), "cross", _j(x), jctx)
    ops.reset_counts()
    got, gc = blocks.block_prefill(tp, "cross", _t(x), ctx)
    assert ops.plain_counts()["flash_attention"] == 0
    assert _rel(got, want) < 2 * ULP
    assert set(gc) == {"mk", "mv"} and gc["mk"].shape == (B, M, KV, HD)
    _close_ulp(gc["mk"], wc["mk"])
    _close_ulp(gc["mv"], wc["mv"])
    ttrain, aux = blocks.block_train(tp, "cross", _t(x), ctx)
    assert torch.equal(ttrain, got) and float(aux) == 0.0
    shut = dict(tp, gate=torch.zeros(()))
    assert not torch.equal(blocks.block_train(shut, "cross", _t(x), ctx)[0],
                           got)
    x1 = _bf16(rng, B, 1, D)
    want1, _ = jblocks.block_decode(_jtree(lp), "cross", _j(x1),
                                    {"mk": wc["mk"], "mv": wc["mv"]},
                                    _j(S, np.int32), jblocks.Ctx(cfg=jcfg))
    tcache = {"mk": _t(wc["mk"]), "mv": _t(wc["mv"])}
    mk = tcache["mk"].clone()
    got1, gc1 = blocks.block_decode(tp, "cross", _t(x1), tcache, S,
                                    blocks.Ctx(cfg=cfg))
    assert gc1 is tcache and torch.equal(tcache["mk"], mk)
    assert _rel(got1, want1) < 2 * ULP


# -- the reduced llama-3.2-vision-90b -----------------------------------------

def _batch(tokens, patches):
    return {"tokens": torch.from_numpy(tokens), "patches": _t(patches)}


def _jbatch(tokens, patches):
    return {"tokens": _j(tokens, np.int32), "patches": _j(patches)}


def test_forward_matches_reference(weights):
    from repro.models import api as japi
    jcfg, cfg = _cfgs()
    tokens = np.random.RandomState(3).randint(0, 512, (B, S))
    patches = _patches(4)
    want, _ = japi.forward(_jtree(weights), jcfg, _jbatch(tokens, patches))
    got, aux = api.forward(api.params_from_jax(weights, "cpu"), cfg,
                           _batch(tokens, patches))
    assert got.shape == (B, S, 512) and float(aux) == 0.0
    assert _rel(got, want) < LOGIT_TOL


@pytest.mark.parametrize("flash", [False, True])
def test_prefill_matches_reference(weights, flash, monkeypatch):
    """Logits through the untied lm_head and every cache leaf (the global
    layers' roped K/V, the cross layer's memory K/V); the flash lane
    launches once a global layer."""
    from repro.models import api as japi
    if flash:
        monkeypatch.setenv("REPRO_FLASH_ATTN", "1")
    else:
        monkeypatch.delenv("REPRO_FLASH_ATTN", raising=False)
    jcfg, cfg = _cfgs()
    tokens = np.random.RandomState(5).randint(0, 512, (B, S))
    patches = _patches(6)
    want, wcache = japi.prefill(_jtree(weights), jcfg,
                                _jbatch(tokens, patches))
    ops.reset_counts()
    got, cache = api.prefill(api.params_from_jax(weights, "cpu"), cfg,
                             _batch(tokens, patches), flash=flash)
    assert ops.plain_counts()["flash_attention"] == (4 if flash else 0)
    assert got.shape == (B, 512)
    assert _rel(got, want) < LOGIT_TOL
    g, w = _leaves(api.cache_to_numpy(cache)), _leaves(wcache)
    assert g.keys() == w.keys()
    assert {"0/s4/mk", "0/s4/mv", "0/s0/k"} <= set(g)
    for key in w:
        assert g[key].shape == np.asarray(w[key]).shape, key
        assert _rel(g[key], w[key]) < LOGIT_TOL, key


def test_decode_steps_from_reference_cache(weights):
    """The reference's prefill cache, its global K/V grown by 4 zero
    positions, carried across; four decode steps in each package from its
    own cache: logits and every leaf against the reference's."""
    from repro.models import api as japi
    jcfg, cfg = _cfgs()
    tokens = np.random.RandomState(7).randint(0, 512, (B, S))
    _, wcache = japi.prefill(_jtree(weights), jcfg,
                             _jbatch(tokens, _patches(8)))
    pad = ((0, 0), (0, 0), (0, 4), (0, 0), (0, 0))
    np_cache = tuple({s: {k: np.pad(np.asarray(v), pad if k in "kv" else 0)
                          for k, v in e.items()}
                      for s, e in g.items()} for g in wcache)
    jp, params = _jtree(weights), api.params_from_jax(weights, "cpu")
    jc, tc = _jtree(np_cache), api.cache_from_jax(np_cache, "cpu")
    for i, token in enumerate(([3, 411], [7, 7], [500, 1], [2, 260])):
        tok = np.array(token)
        want, jc = japi.decode_step(jp, jcfg, _j(tok, np.int32),
                                    _j(S + i, np.int32), jc)
        got, tc = api.decode_step(params, cfg, torch.from_numpy(tok), S + i,
                                  tc)
        assert _rel(got, want) < LOGIT_TOL, i
        g, w = _leaves(api.cache_to_numpy(tc)), _leaves(jc)
        for key in w:
            assert _rel(g[key], w[key]) < LOGIT_TOL, (i, key)


def test_decode_consistent_with_forward(weights):
    """prefill(tokens[:-1]) + decode(tokens[-1]) gives forward(tokens)'s
    last logits: here the cache is roped as the prefill attends, so within
    LOGIT_TOL (and the reference's smoke-test bound)."""
    _, cfg = _cfgs()
    params = api.params_from_jax(weights, "cpu")
    toks = torch.from_numpy(np.random.RandomState(9).randint(0, 512, (B, 64)))
    patches = _t(_patches(10))
    full, _ = api.forward(params, cfg, {"tokens": toks, "patches": patches})
    _, cache = api.prefill(params, cfg, {"tokens": toks[:, :-1],
                                         "patches": patches})
    cache = tserve.grow_cache(cache, cfg, B, 64)
    dec, _ = api.decode_step(params, cfg, toks[:, -1], 63, cache)
    a, b = full[:, -1, :cfg.vocab].float(), dec[:, :cfg.vocab].float()
    assert torch.equal(a.argmax(-1), b.argmax(-1))
    torch.testing.assert_close(a, b, atol=0.5, rtol=0.15)
    assert _rel(b, a) < LOGIT_TOL


def _port_grads(params, toks, patches):
    """The port's train_loss and its gradient (numpy fp64, by leaf name)."""
    _, cfg = _cfgs()
    for t in params.parameters():
        t.requires_grad_(True)
    loss, _ = api.train_loss(params, cfg, _batch(toks, patches))
    loss.backward()
    return float(loss.detach()), {n: leaf.grad.double().numpy()
                                  for n, leaf in api.named_leaves(params)}


def _ref_grads(np_params, toks, patches):
    """The reference's train_loss and its jax.grad, named as the port's."""
    import jax
    import jax.numpy as jnp
    from repro.models import api as japi
    jcfg, _ = _cfgs()
    batch = {"tokens": _j(toks, np.int32),
             "patches": _j(patches, japi.COMPUTE_DTYPE)}
    (loss, _), grad = jax.value_and_grad(
        lambda p: japi.train_loss(p, jcfg, batch), has_aux=True)(
            jax.tree.map(jnp.asarray, np_params))
    leaves = api.named_leaves(api.params_from_jax(
        jax.tree.map(np.asarray, grad), "cpu"))
    return float(loss), {n: leaf.double().numpy() for n, leaf in leaves}


def _drift(got, want) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.fixture(scope="module")
def fp32_witness(weights):
    """The gradient of both packages with every bf16 leaf, input and
    product in fp32 (``COMPUTE_DTYPE`` of both ``api`` modules patched):
    the same math with the rounding taken out."""
    import jax
    import jax.numpy as jnp
    from repro.models import api as japi
    toks = np.random.RandomState(11).randint(0, 512, (B, S + 1))
    patches = _patches(12)
    w32 = jax.tree.map(lambda a: np.asarray(a, np.float32), weights)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(japi, "COMPUTE_DTYPE", jnp.float32)
        mp.setattr(api, "COMPUTE_DTYPE", torch.float32)
        ref = _ref_grads(w32, toks, patches)
        got = _port_grads(api.params_from_jax(w32, "cpu"), toks, patches)
    return toks, patches, ref, got


def test_grads_match_reference_in_fp32(fp32_witness):
    """With the rounding taken out, the backward of both packages is the
    same math: the loss within 1e-6 and every leaf, the gate, mproj and
    the lm_head among them, within ``FP32_GRAD_TOL``."""
    _, _, (want, ref), (got, grad) = fp32_witness
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert grad.keys() == ref.keys()
    assert {GATE, "mproj", "lm_head"} <= set(grad)
    for name in ref:
        assert grad[name].dtype == np.float64 and ref[name].any(), name
        assert _drift(grad[name], ref[name]) <= FP32_GRAD_TOL, name


def test_train_loss_and_grads_match_reference(weights, fp32_witness):
    """train_loss against the reference's, and its bf16 gradient against
    jax.grad's: every leaf but the gate within ``GRAD_TOL`` of the
    reference's and no farther from the fp32 gradient than
    ``WITNESS_RATIO`` times the reference's own distance; the gate within
    ``GATE_ATOL`` of the fp32 gradient."""
    from test_torch_local import LOSS_RTOL
    toks, patches, _, (_, exact) = fp32_witness
    want, ref = _ref_grads(weights, toks, patches)
    got, grad = _port_grads(api.params_from_jax(weights, "cpu"), toks,
                            patches)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert grad.keys() == ref.keys()
    for name in ref:
        if name == GATE:
            assert abs(grad[name] - exact[name]).max() <= GATE_ATOL
            continue
        assert _drift(grad[name], ref[name]) <= GRAD_TOL, name
        assert _drift(grad[name], exact[name]) <= \
            WITNESS_RATIO * _drift(ref[name], exact[name]), name


def test_cross_block_grads_match_reference(weights):
    """The cross layer alone, its gate seeded: the gradient of
    sum(out * w) by its input, its memory and every leaf but the gate
    within ``BLOCK_GRAD_TOL`` of jax.grad's, in bf16."""
    import jax
    import jax.numpy as jnp
    from repro.models import blocks as jblocks
    jcfg, cfg = _cfgs()
    lp, tp = _cross_layer(weights)
    rng = np.random.RandomState(13)
    x, mem = _bf16(rng, B, S, D), _bf16(rng, B, M, D)
    w = rng.randn(B, S, D).astype(np.float32)

    def jloss(p, x, mem):
        ctx = jblocks.Ctx(cfg=jcfg, positions=jnp.arange(S), memory=mem)
        y, _ = jblocks.block_train(p, "cross", x, ctx)
        return jnp.sum(y.astype(jnp.float32) * w)
    jp, jx, jm = jax.grad(jloss, argnums=(0, 1, 2))(_jtree(lp), _j(x),
                                                     _j(mem))
    def leaf(t):
        return t.detach().clone().requires_grad_(True)
    tp = {k: {n: leaf(t) for n, t in v.items()} if isinstance(v, dict)
          else leaf(v) for k, v in tp.items()}
    tx, tm = leaf(_t(x)), leaf(_t(mem))
    ctx = blocks.Ctx(cfg=cfg, positions=torch.arange(S), memory=tm)
    y, _ = blocks.block_train(tp, "cross", tx, ctx)
    (y.float() * torch.from_numpy(w)).sum().backward()
    pairs = [(tx.grad, jx), (tm.grad, jm), (tp["n1"].grad, jp["n1"]),
             (tp["n2"].grad, jp["n2"])]
    pairs += [(tp[g][n].grad, jp[g][n]) for g in ("xattn", "mlp")
              for n in tp[g]]
    assert len(pairs) == 11
    for got, want in pairs:
        got = got.double().numpy()
        want = np.asarray(want, np.float64).reshape(got.shape)
        assert _drift(got, want) <= BLOCK_GRAD_TOL


@pytest.mark.parametrize("reduced", [True, False])
def test_cache_specs_match_reference(reduced):
    """Leaf for leaf: the global layers' K/V of the sequence, the cross
    layer's mk/mv of the patches, whatever the sequence."""
    from repro.configs.base import get_arch as jget
    from repro.models import api as japi
    from repro_torch.configs.base import get_arch
    jcfg, cfg = jget(ARCH), get_arch(ARCH)
    if reduced:
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    want = _leaves(japi.cache_specs(jcfg, B, 2080))
    got = _leaves(api.cache_specs(cfg, B, 2080))
    assert got.keys() == want.keys()
    for key in want:
        assert tuple(got[key].shape) == want[key].shape, key
        assert got[key].dtype == torch.bfloat16
    assert got["0/s4/mk"].shape[2] == cfg.frontend_tokens
    assert set(got) == {f"0/s{i}/{k}" for i in range(4) for k in "kv"} | \
        {"0/s4/mk", "0/s4/mv"}


def test_params_carry_across(weights):
    """mproj, the gate (fp32, one a layer) and the lm_head cross bit for
    bit; the port's own init has the same leaves, shapes and dtypes, its
    gate at zero."""
    _, cfg = _cfgs()
    sd = api.params_from_jax(weights, "cpu").state_dict()
    for name, arr in (("mproj", weights["mproj"]),
                      ("lm_head", weights["lm_head"])):
        np.testing.assert_array_equal(sd[name].view(torch.int16).numpy(),
                                      arr.view(np.int16))
    gate = sd["groups.0.s4.gate"]
    assert gate.dtype == torch.float32 and gate.shape == (1,)
    np.testing.assert_array_equal(gate.numpy(),
                                  weights["groups"][0]["s4"]["gate"])
    port = api.init_params(0, cfg, device="cpu").state_dict()
    assert {k: (tuple(v.shape), v.dtype) for k, v in port.items()} == \
        {k: (tuple(v.shape), v.dtype) for k, v in sd.items()}
    assert not port["groups.0.s4.gate"].any()


# -- on the card ----------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_serve_matches_cpu(cuda):
    """The reduced llama-3.2-vision-90b with its gate at 0.5 on the card
    (four flash launches a prefill, the cross layer's dense attention to
    the patches, telemetry through sparse_addto) against the same weights,
    patches and tokens on the CPU, teacher forced: logits within
    LOGIT_TOL at every step."""
    import copy
    cfg = tserve.model_config(ARCH, reduced=True)
    p_cpu = api.init_params(5, cfg, device="cpu")
    p_cpu["groups"][0]["s4"]["gate"].fill_(0.5)
    kw = dict(arch=ARCH, prompt_len=64, decode_n=4, batch=B, reduced=True)
    ops.reset_counts()
    card = tserve.serve(device=None, params=copy.deepcopy(p_cpu).to(cuda),
                        **kw)
    counts = ops.launch_counts()
    assert counts["flash_attention"] == 4 and counts["sparse_addto"] > 0
    cpu = tserve.serve(device="cpu", params=p_cpu,
                       feed=card["tokens"][:, :-1].cpu(), **kw)
    for t in range(5):
        la, lb = card["logits"][t].float().cpu(), cpu["logits"][t].float()
        assert float((la - lb).abs().max() / lb.abs().max()) < LOGIT_TOL
