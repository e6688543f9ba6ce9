"""The port's RG-LRU mixer (``models/rglru.py``), its conv helpers
(``models/ssm.py``) and the ``rglru`` block against the JAX package, and
the reduced recurrentgemma-9b (5 layers: rglru, rglru, local, rglru,
rglru; d_model 64, rnn width 64 in 16 gate blocks, 2 MQA heads of 32,
window 32) through prefill on both lanes, decode and ``train_loss``.

Both packages compute from the same weights: the reference's
``init_params`` with seeded norm scales and seeded conv and gate biases
(zero at init), carried across by ``params_from_jax``. Inputs are seeded
numpy. bf16 tolerances are those of tests/test_torch_local.py (modules 1
ULP of the tensor's largest magnitude, blocks 2, the 5-layer model's
logits and cache ``DEEP_TOL``, the loss ``LOSS_RTOL``); fp32 ones, of
the tensor's largest magnitude:

  - ``F32_TOL`` = 1e-5 for fp32 functions of the same inputs (the conv
    and its step, the gates, the scan): the port's log-depth scan and the
    reference's ``associative_scan`` sum in other orders, and XLA may
    fuse a multiply-add. Largest measured 2.4e-7.
  - ``STATE_TOL`` = 1e-3 for the recurrent state after a bf16 projection
    and conv: where the two packages round one bf16 input of the gates a
    step apart (2**-8 relative), the state moves by up to that step's
    share of it. Largest measured over twelve draws, prefill and four
    decode steps: 2.9e-5 (most draws 1e-7 to 2e-7).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.models import api, blocks, rglru, ssm
from test_torch_local import DEEP_TOL, LOSS_RTOL
from test_torch_model import (ULP, _bf16, _close_ulp, _j, _jtree, _np, _rel,
                              _t)

ARCH = "recurrentgemma-9b"
F32_TOL = 1e-5
STATE_TOL = 1e-3
B, D, RNN = 2, 64, 64


def _cfgs():
    from repro.configs.base import get_arch as jget
    from repro_torch.configs.base import get_arch
    return jget(ARCH).reduced(), get_arch(ARCH).reduced()


def _np_params(seed=0):
    """The reference's random init of the reduced config as numpy, with
    seeded norm scales, conv and gate biases."""
    import jax
    from repro.models import api as japi
    jcfg, _ = _cfgs()
    params = jax.tree.map(np.asarray,
                          japi.init_params(jax.random.key(seed), jcfg))
    rng = np.random.RandomState(seed + 100)

    def seeded(a, scale):
        return (rng.randn(*a.shape) * scale).astype(np.float32)
    for g in params["groups"]:
        for slot in g.values():
            for name in ("n1", "n2"):
                slot[name] = seeded(slot[name], 0.2)
            if "mix" in slot:
                for name in ("conv_b", "br", "bi"):
                    slot["mix"][name] = seeded(slot["mix"][name], 0.5)
    params["final_norm"] = seeded(params["final_norm"], 0.2)
    return params


@pytest.fixture(scope="module")
def weights():
    return _np_params()


def _rglru_layer(np_params):
    """Layer 0 of the first rglru slot: numpy dict, and the port's."""
    import jax
    lp = jax.tree.map(lambda a: a[0], np_params["groups"][0]["s0"])
    tp = api._layer(api.params_from_jax(np_params, "cpu")["groups"][0]["s0"],
                    0)
    return lp, tp


def _close_f32(got, want, tol=F32_TOL):
    got, want = _np(got), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def _flash_env(monkeypatch, flash):
    if flash:
        monkeypatch.setenv("REPRO_FLASH_ATTN", "1")
    else:
        monkeypatch.delenv("REPRO_FLASH_ATTN", raising=False)


# -- parameters ---------------------------------------------------------------

def test_params_carry_across_with_their_dtypes(weights):
    """fp32 and bf16 leaves side by side, bit for bit, under the
    reference's paths; the port's own init has the same shapes and
    dtypes, and lam puts a = exp(-8 softplus(lam)) in [0.9, 0.999]."""
    _, cfg = _cfgs()
    sd = api.params_from_jax(weights, "cpu").state_dict()
    mix = weights["groups"][0]["s0"]["mix"]
    for name in ("w_in_a", "w_in_b", "wr", "wi", "w_out"):
        t = sd[f"groups.0.s0.mix.{name}"]
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      mix[name].view(np.int16))
    for name in ("conv_w", "conv_b", "br", "bi", "lam"):
        t = sd[f"groups.0.s0.mix.{name}"]
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), mix[name])
    port = api.init_params(0, cfg, device="cpu").state_dict()
    assert {k: (tuple(v.shape), v.dtype) for k, v in port.items()} == \
        {k: (tuple(v.shape), v.dtype) for k, v in sd.items()}
    lam = port["groups.0.s0.mix.lam"]
    a = torch.exp(-rglru._C * torch.nn.functional.softplus(lam))
    assert 0.9 - 1e-6 <= float(a.min()) and float(a.max()) <= 0.999 + 1e-6
    assert port["groups.0.s0.mix.wr"].shape == (1, 16, 4, 4)


# -- the conv and the scan ----------------------------------------------------

def test_causal_conv1d_and_step_match_reference():
    from repro.models import ssm as jssm
    rng = np.random.RandomState(1)
    x = _bf16(rng, B, 24, RNN)
    w = rng.randn(4, RNN).astype(np.float32) * 0.5
    b = rng.randn(RNN).astype(np.float32)
    got = ssm.causal_conv1d(_t(x), torch.from_numpy(w), torch.from_numpy(b))
    assert got.dtype == torch.float32
    _close_f32(got, jssm.causal_conv1d(_j(x), _j(w, np.float32),
                                       _j(b, np.float32)))
    win = _bf16(rng, B, 4, RNN)
    _close_f32(ssm.conv1d_step(_t(win), torch.from_numpy(w),
                               torch.from_numpy(b)),
               jssm.conv1d_step(_j(win), _j(w, np.float32),
                                _j(b, np.float32)))
    # the step at position t is the conv's row t
    full = ssm.causal_conv1d(_t(x), torch.from_numpy(w), torch.from_numpy(b))
    step = ssm.conv1d_step(_t(x)[:, 9:13], torch.from_numpy(w),
                           torch.from_numpy(b))
    _close_f32(step, full[:, 12])


@pytest.mark.parametrize("s", [1, 2, 7, 64, 100])
def test_linear_scan_is_the_recurrence(s):
    """The log-depth scan against the sequential recurrence in float64."""
    rng = np.random.RandomState(s)
    a = rng.uniform(0.5, 1.0, (B, s, 8)).astype(np.float32)
    b = rng.randn(B, s, 8).astype(np.float32)
    h, want = np.zeros((B, 8)), np.zeros((B, s, 8))
    for t in range(s):
        h = a[:, t] * h + b[:, t]
        want[:, t] = h
    got = rglru.linear_scan(torch.from_numpy(a), torch.from_numpy(b))
    _close_f32(got, want)


# -- the mixer ----------------------------------------------------------------

def test_rglru_train_matches_reference(weights):
    from repro.models import rglru as jrglru
    lp, tp = _rglru_layer(weights)
    x = _bf16(np.random.RandomState(2), B, 64, D)
    want_y, want_h, want_tail = jrglru.rglru_train(_jtree(lp["mix"]), _j(x))
    y, h, tail = rglru.rglru_train(tp["mix"], _t(x))
    _close_ulp(y, want_y)
    assert h.dtype == torch.float32 and h.shape == (B, RNN)
    _close_f32(h, want_h, STATE_TOL)
    assert tail.dtype == torch.bfloat16 and tail.shape == (B, 3, RNN)
    _close_ulp(tail, want_tail)
    xa = _bf16(np.random.RandomState(12), B, 64, RNN)
    a, gated = rglru._gates(tp["mix"], _t(xa))
    ja, jg = jrglru._gates(_jtree(lp["mix"]), _j(xa))
    _close_f32(a, ja)
    _close_f32(gated, jg)


def test_rglru_prefill_then_decode_matches_reference(weights):
    """rglru_train over 40 positions, then 4 rglru_decode steps, each
    package from its own state: output, state and conv window at every
    step."""
    from repro.models import rglru as jrglru
    lp, tp = _rglru_layer(weights)
    jp = _jtree(lp["mix"])
    rng = np.random.RandomState(3)
    x = _bf16(rng, B, 40, D)
    _, jh, jconv = jrglru.rglru_train(jp, _j(x))
    _, h, conv = rglru.rglru_train(tp["mix"], _t(x))
    for step in range(4):
        x1 = _bf16(rng, B, 1, D)
        want, jh, jconv = jrglru.rglru_decode(jp, _j(x1), jh, jconv)
        got, h, conv = rglru.rglru_decode(tp["mix"], _t(x1), h, conv)
        assert got.shape == (B, 1, D) and conv.shape == (B, 3, RNN)
        _close_ulp(got, want)
        _close_f32(h, jh, STATE_TOL)
        _close_ulp(conv, jconv)


# -- the rglru block ----------------------------------------------------------

def test_rglru_block_matches_reference(weights):
    """block_train and block_prefill over 48 positions, then block_decode
    from the reference's state and conv tail, written in place."""
    from repro.models import blocks as jblocks
    jcfg, cfg = _cfgs()
    lp, tp = _rglru_layer(weights)
    s = 48
    x = _bf16(np.random.RandomState(4), B, s, D)
    jctx = jblocks.Ctx(cfg=jcfg, positions=_j(np.arange(s), np.int32))
    ctx = blocks.Ctx(cfg=cfg, positions=torch.arange(s), flash=True)
    want, wc = jblocks.block_prefill(_jtree(lp), "rglru", _j(x), jctx)
    jtrain, _ = jblocks.block_train(_jtree(lp), "rglru", _j(x), jctx)
    ops.reset_counts()
    got, gc = blocks.block_prefill(tp, "rglru", _t(x), ctx)
    assert ops.plain_counts()["flash_attention"] == 0
    ttrain, aux = blocks.block_train(tp, "rglru", _t(x), ctx)
    assert torch.equal(ttrain, got) and float(aux) == 0.0
    assert _rel(got, want) < 2 * ULP and _rel(ttrain, jtrain) < 2 * ULP
    _close_f32(gc["state"], wc["state"], STATE_TOL)
    _close_ulp(gc["conv"], wc["conv"])
    x1 = _bf16(np.random.RandomState(5), B, 1, D)
    tcache = {"state": torch.from_numpy(np.asarray(wc["state"])),
              "conv": _t(wc["conv"])}
    state, conv = tcache["state"], tcache["conv"]
    want1, wc1 = jblocks.block_decode(_jtree(lp), "rglru", _j(x1),
                                      {"state": wc["state"],
                                       "conv": wc["conv"]},
                                      _j(s, np.int32), jblocks.Ctx(cfg=jcfg))
    got1, gc1 = blocks.block_decode(tp, "rglru", _t(x1), tcache, s,
                                    blocks.Ctx(cfg=cfg))
    assert gc1["state"] is state and gc1["conv"] is conv   # in place
    assert _rel(got1, want1) < 2 * ULP
    _close_f32(state, wc1["state"], STATE_TOL)
    _close_ulp(conv, wc1["conv"])


# -- the reduced recurrentgemma-9b --------------------------------------------

S = 64                         # the prompt: longer than the window (32)


def _jax_prefill(np_params, tokens, flash, monkeypatch):
    from repro.models import api as japi
    _flash_env(monkeypatch, flash)
    jcfg, _ = _cfgs()
    return japi.prefill(_jtree(np_params), jcfg,
                        {"tokens": _j(tokens, np.int32)})


def _leaves(cache):
    return {f"{gi}/{s}/{k}": v for gi, g in enumerate(cache)
            for s, e in g.items() for k, v in e.items()}


@pytest.mark.parametrize("flash", [False, True])
def test_prefill_matches_reference(weights, flash, monkeypatch):
    """The local layer takes the kernel's plain version on the flash
    lane (S > window), the four rglru layers no attention at all."""
    tokens = np.random.RandomState(6).randint(0, 512, (B, S))
    want, wcache = _jax_prefill(weights, tokens, flash, monkeypatch)
    _, cfg = _cfgs()
    ops.reset_counts()
    got, cache = api.prefill(api.params_from_jax(weights, "cpu"), cfg,
                             {"tokens": torch.from_numpy(tokens)},
                             flash=flash)
    assert ops.plain_counts()["flash_attention"] == int(flash)
    assert got.shape == (B, 512)
    assert _rel(got, want) < DEEP_TOL
    g, w = _leaves(api.cache_to_numpy(cache)), _leaves(wcache)
    assert g.keys() == w.keys()
    for key in w:
        assert g[key].shape == np.asarray(w[key]).shape, key
        assert _rel(g[key], w[key]) < DEEP_TOL, key


def test_decode_steps_from_reference_cache(weights, monkeypatch):
    """The reference's prefill cache grown to S + 4 by the reference's
    rule, carried across; four decode steps in each package, the later
    ones from each package's own cache (the recurrent state and conv tail
    updated in place)."""
    import jax
    from repro.models import api as japi
    jcfg, cfg = _cfgs()
    tokens = np.random.RandomState(7).randint(0, 512, (B, S))
    _, wcache = _jax_prefill(weights, tokens, False, monkeypatch)
    specs = japi.cache_specs(jcfg, B, S + 4)
    np_cache = jax.tree.map(
        lambda a, like: np.pad(np.asarray(a), [(0, l - n) for n, l in
                                               zip(a.shape, like.shape)]),
        wcache, specs)
    jp, params = _jtree(weights), api.params_from_jax(weights, "cpu")
    jc, tc = _jtree(np_cache), api.cache_from_jax(np_cache, "cpu")
    state = tc[0]["s0"]["state"]
    for i, token in enumerate(([3, 411], [7, 7], [500, 1], [2, 260])):
        tok = np.array(token)
        want, jc = japi.decode_step(jp, jcfg, _j(tok, np.int32),
                                    _j(S + i, np.int32), jc)
        got, tc = api.decode_step(params, cfg, torch.from_numpy(tok), S + i,
                                  tc)
        assert _rel(got, want) < DEEP_TOL, i
    assert tc[0]["s0"]["state"] is state
    g, w = _leaves(api.cache_to_numpy(tc)), _leaves(jc)
    for key in w:
        assert _rel(g[key], w[key]) < DEEP_TOL, key


def test_train_loss_and_grads_match_reference(weights):
    """train_loss against the reference's (``LOSS_RTOL``), and its gradient
    through the log-depth scan against jax.grad: each rglru leaf's within
    ``GRAD_TOL`` = 2e-2 of the reference's (||d|| / ||ref||; bf16
    products in other orders; largest measured 4.1e-3)."""
    import jax
    from repro.models import api as japi
    jcfg, cfg = _cfgs()
    toks = np.random.RandomState(8).randint(0, 512, (B, S + 1))
    batch = {"tokens": _j(toks, np.int32)}
    jp = _jtree(weights)
    (want, _), jgrad = jax.value_and_grad(
        lambda p: japi.train_loss(p, jcfg, batch), has_aux=True)(jp)
    params = api.params_from_jax(weights, "cpu")
    for t in params.parameters():
        t.requires_grad_(True)
    got, metrics = api.train_loss(params, cfg,
                                  {"tokens": torch.from_numpy(toks)})
    got.backward()
    assert float(metrics["aux"]) == 0.0
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)
    mix = params["groups"][0]["s0"]["mix"]
    jmix = jgrad["groups"][0]["s0"]["mix"]
    for name in ("w_in_a", "w_in_b", "wr", "lam", "conv_w", "w_out"):
        g = mix[name].grad.float().numpy()
        w = np.asarray(jmix[name], np.float32)
        assert np.linalg.norm(g - w) <= 2e-2 * np.linalg.norm(w), name


@pytest.mark.parametrize("reduced", [True, False])
@pytest.mark.parametrize("seq", [16, 40, 4096])
def test_cache_specs_match_reference(reduced, seq):
    """Leaf for leaf, shape and dtype: the state fp32 (B, rnn), the conv
    tail bf16 (B, 3, rnn), the local ring min(W, seq)."""
    from repro.configs.base import get_arch as jget
    from repro.models import api as japi
    from repro_torch.configs.base import get_arch
    jcfg, cfg = jget(ARCH), get_arch(ARCH)
    if reduced:
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    want = _leaves(japi.cache_specs(jcfg, B, seq))
    got = _leaves(api.cache_specs(cfg, B, seq))
    assert got.keys() == want.keys()
    for key in want:
        assert tuple(got[key].shape) == want[key].shape, key
        assert str(got[key].dtype).removeprefix("torch.") == \
            str(want[key].dtype), key
