"""The port's Mamba-2 mixer (``models/ssm.py``: ``ssd_chunked``,
``mamba2_train``, ``mamba2_decode``) and the ``ssd`` block against the JAX
package, and the reduced mamba2-780m (d_model 64, 4 SSM heads of 16,
state 16, conv 4, vocab 512) at two layers through prefill, decode and
``train_loss``.

Both packages compute from the same weights: the reference's
``init_params`` with seeded norm scales, ``A_log``, ``dt_bias``, ``D``,
mixer norm and conv biases (zeros and ones at init would hide them),
carried across by ``params_from_jax``. Inputs are seeded numpy. bf16
tolerances are those of tests/test_torch_model.py (modules 1 ULP of the
tensor's largest magnitude, blocks 2, the model's logits and cache
``LOGIT_TOL``); fp32 ones, of the tensor's largest magnitude:

  - ``F32_TOL`` = 1e-5 for fp32 functions of the same inputs
    (``ssd_chunked``, also against the recurrence in float64): the
    einsums contract in other orders. Largest measured 2.8e-6. The
    port's ``F.softplus`` returns x above 20 where the reference's
    ``logaddexp(x, 0)`` adds log1p(exp(-x)) < 2.1e-9, below fp32's
    rounding of x there.
  - ``STATE_TOL`` = 1e-3 for the SSM state after a bf16 projection and
    conv (as tests/test_torch_rglru.py's): where the packages round one
    bf16 input a step apart (2**-8 relative), the state moves by that
    input's share of it. Largest measured over prefill and four decode
    steps 2.1e-6.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.launch import serve as tserve
from repro_torch.models import api, blocks, ssm
from test_torch_model import (LOGIT_TOL, ULP, _bf16, _close_ulp, _j, _jtree,
                              _np, _rel, _t)

ARCH = "mamba2-780m"
F32_TOL = 1e-5
STATE_TOL = 1e-3
LAYERS = 2
B, D = 2, 64
H, P, N = 4, 16, 16            # the reduced config's heads, head dim, state
KW = dict(n_heads=H, head_dim=P, d_state=N, norm_eps=1e-6)


def _cfgs(layers=LAYERS):
    from repro.configs.base import get_arch as jget
    from repro_torch.configs.base import get_arch
    jcfg = jget(ARCH).reduced()
    jcfg = dataclasses.replace(jcfg, n_layers=layers,
                               pattern_groups=((("ssd",), layers),))
    return jcfg, tserve.with_layers(get_arch(ARCH).reduced(), layers)


def _np_params(seed=0):
    """The reference's random init as numpy, with every zero or one leaf
    of the mixer and the norms seeded."""
    import jax
    from repro.models import api as japi
    jcfg, _ = _cfgs()
    params = jax.tree.map(np.asarray,
                          japi.init_params(jax.random.key(seed), jcfg))
    rng = np.random.RandomState(seed + 100)

    def seeded(a, scale, offset=0.0):
        return (rng.randn(*a.shape) * scale + offset).astype(np.float32)
    slot = params["groups"][0]["s0"]
    slot["n1"] = seeded(slot["n1"], 0.2)
    mix = slot["mix"]
    for name in ("conv_bx", "conv_bB", "conv_bC", "norm"):
        mix[name] = seeded(mix[name], 0.3)
    mix["A_log"] = seeded(mix["A_log"], 0.5)
    mix["dt_bias"] = seeded(mix["dt_bias"], 0.5, -1.0)
    mix["D"] = seeded(mix["D"], 0.5, 1.0)
    params["final_norm"] = seeded(params["final_norm"], 0.2)
    return params


@pytest.fixture(scope="module")
def weights():
    return _np_params()


def _layer(np_params, i=0):
    import jax
    lp = jax.tree.map(lambda a: a[i], np_params["groups"][0]["s0"])
    tp = api._layer(api.params_from_jax(np_params, "cpu")["groups"][0]["s0"],
                    i)
    return lp, tp


def _close_f32(got, want, tol=F32_TOL):
    got, want = _np(got), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def _ssd_inputs(seed, s):
    """x (B,S,H,P), dt > 0 (B,S,H), a < 0 (H,), B and C (B,S,N): fp32."""
    rng = np.random.RandomState(seed)
    x = rng.randn(B, s, H, P).astype(np.float32)
    dt = np.log1p(np.exp(rng.randn(B, s, H) - 1.0)).astype(np.float32)
    a = -np.exp(rng.randn(H) * 0.5).astype(np.float32)
    bm = rng.randn(B, s, N).astype(np.float32)
    cm = rng.randn(B, s, N).astype(np.float32)
    return x, dt, a, bm, cm


def _ssd_sequential(x, dt, a, bm, cm):
    """The recurrence h_t = exp(dt_t a) h_{t-1} + dt_t x_t B_t^T, y_t =
    h_t C_t, position by position in float64."""
    x, dt, a, bm, cm = (np.asarray(v, np.float64) for v in (x, dt, a, bm, cm))
    h = np.zeros((B, H, P, N))
    y = np.zeros(x.shape)
    for t in range(x.shape[1]):
        da = np.exp(dt[:, t] * a)                              # (B,H)
        h = h * da[..., None, None] + np.einsum(
            "bh,bhp,bn->bhpn", dt[:, t], x[:, t], bm[:, t])
        y[:, t] = np.einsum("bhpn,bn->bhp", h, cm[:, t])
    return y, h


# -- ssd_chunked --------------------------------------------------------------

@pytest.mark.parametrize("chunk", [16, 64])
def test_ssd_chunked_matches_reference(chunk):
    """S = 64 in 4 chunks of 16 (the inter-chunk recurrence runs three
    times) and in one chunk of S, against the reference and against the
    sequential recurrence in float64."""
    from repro.models import ssm as jssm
    args = _ssd_inputs(1, 64)
    y, final = ssm.ssd_chunked(*(torch.from_numpy(v) for v in args), chunk)
    jy, jfinal = jssm.ssd_chunked(*(_j(v, np.float32) for v in args), chunk)
    assert y.dtype == final.dtype == torch.float32
    assert y.shape == (B, 64, H, P) and final.shape == (B, H, P, N)
    _close_f32(y, jy)
    _close_f32(final, jfinal)
    sy, sh = _ssd_sequential(*args)
    _close_f32(y, sy)
    _close_f32(final, sh)


def test_ssd_chunked_needs_whole_chunks():
    """The reference asserts S % chunk == 0; the port raises, and pads
    nothing."""
    args = [torch.from_numpy(v) for v in _ssd_inputs(2, 48)]
    with pytest.raises(ValueError, match="not a multiple"):
        ssm.ssd_chunked(*args, 32)
    y, _ = ssm.ssd_chunked(*args, 16)
    assert y.shape[1] == 48


# -- the mixer ----------------------------------------------------------------

def test_mamba2_train_matches_reference(weights):
    """Over 64 positions with chunk 16: output, final state and conv tail
    (the pre-conv x|B|C inputs of the last 3 positions)."""
    from repro.models import ssm as jssm
    lp, tp = _layer(weights)
    x = _bf16(np.random.RandomState(3), B, 64, D)
    want = jssm.mamba2_train(_jtree(lp["mix"]), _j(x), chunk=16, **KW)
    y, state, tail = ssm.mamba2_train(tp["mix"], _t(x), chunk=16, **KW)
    assert y.dtype == torch.bfloat16 and y.shape == (B, 64, D)
    _close_ulp(y, want[0])
    assert state.dtype == torch.float32 and state.shape == (B, H, P, N)
    _close_f32(state, want[1], STATE_TOL)
    assert tail.dtype == torch.bfloat16
    assert tail.shape == (B, 3, H * P + 2 * N)
    _close_ulp(tail, want[2])


def test_mamba2_prefill_then_decode_matches_reference(weights):
    """mamba2_train over 32 positions, then 4 mamba2_decode steps, each
    package from its own state: output, state and conv window at every
    step; the port's new conv window is a new tensor."""
    from repro.models import ssm as jssm
    lp, tp = _layer(weights)
    jp = _jtree(lp["mix"])
    rng = np.random.RandomState(4)
    x = _bf16(rng, B, 32, D)
    _, jh, jconv = jssm.mamba2_train(jp, _j(x), **KW)
    _, h, conv = ssm.mamba2_train(tp["mix"], _t(x), **KW)
    for step in range(4):
        x1 = _bf16(rng, B, 1, D)
        want, jh, jconv = jssm.mamba2_decode(jp, _j(x1), jh, jconv, **KW)
        got, h2, conv2 = ssm.mamba2_decode(tp["mix"], _t(x1), h, conv, **KW)
        assert conv2.data_ptr() != conv.data_ptr()
        h, conv = h2, conv2
        assert got.shape == (B, 1, D)
        _close_ulp(got, want)
        _close_f32(h, jh, STATE_TOL)
        _close_ulp(conv, jconv)


# -- the ssd block ------------------------------------------------------------

def test_ssd_block_matches_reference(weights):
    """block_train and block_prefill over 64 positions (aux 0, no flash
    launch on the flash lane), then block_decode from the reference's
    state and conv tail, written in place."""
    from repro.models import blocks as jblocks
    jcfg, cfg = _cfgs()
    lp, tp = _layer(weights)
    assert set(tp) == {"n1", "mix"}
    s = 64
    x = _bf16(np.random.RandomState(5), B, s, D)
    jctx = jblocks.Ctx(cfg=jcfg, positions=_j(np.arange(s), np.int32))
    ctx = blocks.Ctx(cfg=cfg, positions=torch.arange(s), flash=True)
    want, wc = jblocks.block_prefill(_jtree(lp), "ssd", _j(x), jctx)
    ops.reset_counts()
    got, gc = blocks.block_prefill(tp, "ssd", _t(x), ctx)
    assert ops.plain_counts()["flash_attention"] == 0
    ttrain, aux = blocks.block_train(tp, "ssd", _t(x), ctx)
    assert torch.equal(ttrain, got) and float(aux) == 0.0
    assert _rel(got, want) < 2 * ULP
    _close_f32(gc["state"], wc["state"], STATE_TOL)
    _close_ulp(gc["conv"], wc["conv"])
    x1 = _bf16(np.random.RandomState(6), B, 1, D)
    tcache = {"state": torch.from_numpy(np.array(wc["state"])),
              "conv": _t(wc["conv"])}
    state, conv = tcache["state"], tcache["conv"]
    want1, wc1 = jblocks.block_decode(_jtree(lp), "ssd", _j(x1),
                                      {"state": wc["state"],
                                       "conv": wc["conv"]},
                                      _j(s, np.int32), jblocks.Ctx(cfg=jcfg))
    got1, gc1 = blocks.block_decode(tp, "ssd", _t(x1), tcache, s,
                                    blocks.Ctx(cfg=cfg))
    assert gc1["state"] is state and gc1["conv"] is conv   # in place
    assert _rel(got1, want1) < 2 * ULP
    _close_f32(state, wc1["state"], STATE_TOL)
    _close_ulp(conv, wc1["conv"])


# -- the reduced mamba2-780m --------------------------------------------------

S = 512                        # two SSD chunks of 256


def _leaves(cache):
    return {f"{gi}/{s}/{k}": v for gi, g in enumerate(cache)
            for s, e in g.items() for k, v in e.items()}


def _jax_prefill(np_params, tokens):
    from repro.models import api as japi
    jcfg, _ = _cfgs()
    return japi.prefill(_jtree(np_params), jcfg,
                        {"tokens": _j(tokens, np.int32)})


@pytest.mark.parametrize("flash", [False, True])
def test_prefill_matches_reference(weights, flash):
    """Two chunks a layer; no attention, so no flash launch on either
    lane."""
    tokens = np.random.RandomState(7).randint(0, 512, (B, S))
    want, wcache = _jax_prefill(weights, tokens)
    _, cfg = _cfgs()
    ops.reset_counts()
    got, cache = api.prefill(api.params_from_jax(weights, "cpu"), cfg,
                             {"tokens": torch.from_numpy(tokens)},
                             flash=flash)
    assert ops.plain_counts()["flash_attention"] == 0
    assert got.shape == (B, 512)
    assert _rel(got, want) < LOGIT_TOL
    g, w = _leaves(api.cache_to_numpy(cache)), _leaves(wcache)
    assert g.keys() == w.keys()
    for key in w:
        assert g[key].shape == np.asarray(w[key]).shape, key
        assert _rel(g[key], w[key]) < LOGIT_TOL, key


def test_decode_steps_from_reference_cache(weights):
    """The reference's prefill cache carried across; four decode steps in
    each package, the later ones from each package's own cache, which
    the port writes in place: logits and the cache against the
    reference's returned one."""
    from repro.models import api as japi
    jcfg, cfg = _cfgs()
    tokens = np.random.RandomState(8).randint(0, 512, (B, 64))
    _, wcache = _jax_prefill(weights, tokens)
    np_cache = tuple({s: {k: np.asarray(v) for k, v in e.items()}
                      for s, e in g.items()} for g in wcache)
    jp, params = _jtree(weights), api.params_from_jax(weights, "cpu")
    jc, tc = _jtree(np_cache), api.cache_from_jax(np_cache, "cpu")
    state, conv = tc[0]["s0"]["state"], tc[0]["s0"]["conv"]
    for i, token in enumerate(([3, 411], [7, 7], [500, 1], [2, 260])):
        tok = np.array(token)
        want, jc = japi.decode_step(jp, jcfg, _j(tok, np.int32),
                                    _j(64 + i, np.int32), jc)
        got, tc = api.decode_step(params, cfg, torch.from_numpy(tok), 64 + i,
                                  tc)
        assert _rel(got, want) < LOGIT_TOL, i
        g, w = _leaves(api.cache_to_numpy(tc)), _leaves(jc)
        for key in w:
            assert _rel(g[key], w[key]) < LOGIT_TOL, (i, key)
    assert tc[0]["s0"]["state"] is state and tc[0]["s0"]["conv"] is conv


def test_decode_consistent_with_forward(weights):
    """prefill(tokens[:-1]) + decode(tokens[-1]) gives forward(tokens)'s
    last logits, as tests/test_models_smoke.py holds the reference: the
    same top-1 and close values."""
    _, cfg = _cfgs()
    params = api.params_from_jax(weights, "cpu")
    toks = torch.from_numpy(np.random.RandomState(9).randint(0, 512, (B, 64)))
    full, _ = api.forward(params, cfg, {"tokens": toks})
    _, cache = api.prefill(params, cfg, {"tokens": toks[:, :-1]})
    dec, _ = api.decode_step(params, cfg, toks[:, -1], 63, cache)
    a, b = full[:, -1, :cfg.vocab].float(), dec[:, :cfg.vocab].float()
    assert torch.equal(a.argmax(-1), b.argmax(-1))
    torch.testing.assert_close(a, b, atol=0.5, rtol=0.15)
    assert _rel(b, a) < LOGIT_TOL


def test_train_loss_and_grads_match_reference(weights):
    """train_loss against the reference's (aux 0: no MoE), and its
    gradient against jax.grad: each mixer leaf's within 2e-2 of the
    reference's (||d|| / ||ref||, as tests/test_torch_rglru.py)."""
    import jax
    from repro.models import api as japi
    from test_torch_local import LOSS_RTOL
    jcfg, cfg = _cfgs()
    toks = np.random.RandomState(10).randint(0, 512, (B, 65))
    (want, _), jgrad = jax.value_and_grad(
        lambda p: japi.train_loss(p, jcfg, {"tokens": _j(toks, np.int32)}),
        has_aux=True)(_jtree(weights))
    params = api.params_from_jax(weights, "cpu")
    for t in params.parameters():
        t.requires_grad_(True)
    got, metrics = api.train_loss(params, cfg,
                                  {"tokens": torch.from_numpy(toks)})
    got.backward()
    assert float(metrics["aux"]) == 0.0
    np.testing.assert_allclose(float(got.detach()), float(want),
                               rtol=LOSS_RTOL)
    mix = params["groups"][0]["s0"]["mix"]
    jmix = jgrad["groups"][0]["s0"]["mix"]
    for name in ("w_z", "w_x", "w_B", "w_C", "w_dt", "conv_x", "conv_bB",
                 "A_log", "dt_bias", "D", "norm", "w_out"):
        g = mix[name].grad.float().numpy()
        w = np.asarray(jmix[name], np.float32)
        assert np.linalg.norm(g - w) <= 2e-2 * np.linalg.norm(w), name


@pytest.mark.parametrize("reduced", [True, False])
@pytest.mark.parametrize("seq", [16, 4096])
def test_cache_specs_match_reference(reduced, seq):
    """Leaf for leaf, shape and dtype: the state fp32 (B, H, P, N), the
    conv tail bf16 (B, 3, d_inner + 2N), whatever the sequence."""
    from repro.configs.base import get_arch as jget
    from repro.models import api as japi
    from repro_torch.configs.base import get_arch
    jcfg, cfg = jget(ARCH), get_arch(ARCH)
    if reduced:
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    want = _leaves(japi.cache_specs(jcfg, B, seq))
    got = _leaves(api.cache_specs(cfg, B, seq))
    assert got.keys() == want.keys() == {"0/s0/state", "0/s0/conv"}
    for key in want:
        assert tuple(got[key].shape) == want[key].shape, key
        assert str(got[key].dtype).removeprefix("torch.") == \
            str(want[key].dtype), key


def test_params_carry_across_with_their_dtypes(weights):
    """The reference's paths and dtypes (bf16 projections, fp32 conv,
    decay and norm leaves), bit for bit; the port's own init has the same
    shapes and dtypes, with A = -1, D = 1 and zero biases."""
    _, cfg = _cfgs()
    sd = api.params_from_jax(weights, "cpu").state_dict()
    mix = weights["groups"][0]["s0"]["mix"]
    for name, arr in mix.items():
        t = sd[f"groups.0.s0.mix.{name}"]
        if name.startswith("w_"):
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          arr.view(np.int16))
        else:
            assert t.dtype == torch.float32
            np.testing.assert_array_equal(t.numpy(), arr)
    port = api.init_params(0, cfg, device="cpu").state_dict()
    assert {k: (tuple(v.shape), v.dtype) for k, v in port.items()} == \
        {k: (tuple(v.shape), v.dtype) for k, v in sd.items()}
    assert not any(k.startswith("groups.0.s0.n2") or ".mlp." in k
                   for k in port)
    assert (port["groups.0.s0.mix.A_log"] == 0).all()
    assert (port["groups.0.s0.mix.D"] == 1).all()
