"""The port's MoE layer (``models/ffn.py``: ``moe_capacity``, ``route``,
``moe_apply``) and the ``moe`` block against the JAX package, the reduced
moonshot-v1-16b-a3b (d_model 64, 2 heads of 32 on 2 KV heads, 4 experts
of d_ff 128 with top-2, vocab 512) at two layers through prefill on both
lanes, decode and ``train_loss`` with its aux loss, and ``dense_init``'s
sliced draw of a large leaf.

Both packages compute from the same weights: the reference's
``init_params`` (or ``init_moe``) with seeded norm scales, carried across
by ``params_from_jax``. Inputs are seeded numpy. bf16 tolerances are
those of tests/test_torch_model.py: ``moe_apply``'s output within 2 ULP
of its largest magnitude (``_close_ulp``), the bound of a block there:
it sums top_k gated SwiGLUs, and in each the reference's silu (XLA's
bf16 logistic, then a multiply) and PyTorch's (one rounding) differ by a
step in a third of the elements, while the products and the gated sum
(bf16, in the same expert order) round alike. Largest measured 1.10 ULP
(the decode case; top-6 1.02, top-2 0.85). A block within 2 ULP, the
model's logits and cache within ``LOGIT_TOL``. The
router runs in fp32 on the same bf16 input, so the expert ids are equal;
the aux loss (fp32) is held within ``AUX_TOL`` = 1e-6 relative on the
same input (largest measured 1.2e-7) and within ``LOSS_RTOL`` inside the
model, where its inputs differ by bf16 rounding. Gradients as
tests/test_torch_rglru.py: each leaf within 2e-2 of the reference's
(||d|| / ||ref||).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.launch import serve as tserve
from repro_torch.models import api, blocks, common, ffn
from test_torch_local import LOSS_RTOL
from test_torch_model import (LOGIT_TOL, ULP, _bf16, _close_ulp, _j, _jtree,
                              _np, _rel, _t)

ARCH = "moonshot-v1-16b-a3b"
AUX_TOL = 1e-6
GRAD_TOL = 2e-2
LAYERS = 2
B, D, FF = 2, 64, 128


def _cfgs(layers=LAYERS):
    from repro.configs.base import get_arch as jget
    from repro_torch.configs.base import get_arch
    jcfg = jget(ARCH).reduced()
    jcfg = dataclasses.replace(jcfg, n_layers=layers,
                               pattern_groups=((("moe",), layers),))
    return jcfg, tserve.with_layers(get_arch(ARCH).reduced(), layers)


def _np_params(seed=0):
    """The reference's random init as numpy, with seeded norm scales."""
    import jax
    from repro.models import api as japi
    jcfg, _ = _cfgs()
    params = jax.tree.map(np.asarray,
                          japi.init_params(jax.random.key(seed), jcfg))
    rng = np.random.RandomState(seed + 100)
    slot = params["groups"][0]["s0"]
    for name in ("n1", "n2"):
        slot[name] = (rng.randn(*slot[name].shape) * 0.2).astype(np.float32)
    params["final_norm"] = (rng.randn(*params["final_norm"].shape)
                            * 0.2).astype(np.float32)
    return params


@pytest.fixture(scope="module")
def weights():
    return _np_params()


def _moe_weights(n_experts, seed=0):
    """The reference's ``init_moe`` at d 64, d_ff 128, as numpy."""
    import jax
    from repro.models import ffn as jffn
    return jax.tree.map(np.asarray, jffn.init_moe(jax.random.key(seed), D,
                                                   FF, n_experts))


def _reference_ids(router, x, top_k):
    """The reference's routing of x, each token's experts ascending."""
    import jax
    import jax.numpy as jnp
    xf = _j(x).reshape(-1, D).astype(jnp.float32)
    probs = jax.nn.softmax(xf @ _j(router, np.float32), axis=-1)
    return np.sort(np.asarray(jax.lax.top_k(probs, top_k)[1]), axis=-1)


# -- capacity -----------------------------------------------------------------

@pytest.mark.parametrize("tokens", [1, 2, 4, 48, 1000, 8192])
def test_moe_capacity_matches_reference(tokens):
    """Over experts (4, 8, 64), top_k (1, 2, 6) and factors (1.0, 1.25,
    2.0): at least 8, a multiple of 8, the reference's value."""
    from repro.models import ffn as jffn
    for e in (4, 8, 64):
        for k in (1, 2, 6):
            for factor in (1.0, 1.25, 2.0):
                got = ffn.moe_capacity(tokens, e, k, factor)
                assert got == jffn.moe_capacity(tokens, e, k, factor)
                assert got >= 8 and got % 8 == 0
    assert ffn.moe_capacity(4, 64, 6, 1.25) == 8        # moonshot's decode
    assert ffn.moe_capacity(8192, 64, 6, 1.25) == 960   # and prefill


# -- moe_apply ----------------------------------------------------------------

# (name, experts, top_k, batch, seq): a prefill of 48 tokens at top-2 and
# at moonshot's top-6 (of 16), a router biased to expert 0 so that it
# overflows its capacity, and a decode step of 2 tokens (capacity 8)
MOE_CASES = [("top2", 4, 2, B, 24), ("top6", 16, 6, B, 24),
             ("overflow", 4, 2, B, 24), ("decode", 4, 2, B, 1)]


def _moe_case(name, e, s):
    """The weights as numpy and the port's, and x (B, s, D) bf16 values."""
    np_p = _moe_weights(e)
    rng = np.random.RandomState(len(name) + s)
    x = _bf16(rng, B, s, D)
    if name == "overflow":      # x near +-1 and router column 0 along it:
        v = np.sign(rng.randn(D)).astype(np.float32)   # expert 0 leads
        np_p["router"] = np_p["router"].copy()
        np_p["router"][:, 0] = 0.5 * v
        x = torch.from_numpy(0.1 * x + v).bfloat16().float().numpy()
    return np_p, api.params_from_jax(np_p, "cpu"), x


@pytest.mark.parametrize("name,e,k,b,s", MOE_CASES)
def test_moe_apply_matches_reference(name, e, k, b, s):
    from repro.models import ffn as jffn
    np_p, tp, x = _moe_case(name, e, s)
    want_y, want_aux = jffn.moe_apply(_jtree(np_p), _j(x), top_k=k,
                                      capacity_factor=1.25)
    probs, gates, ids = ffn.route(tp["router"], _t(x).reshape(-1, D), k)
    np.testing.assert_array_equal(ids.numpy(),
                                  _reference_ids(np_p["router"], x, k))
    assert torch.allclose(gates.sum(-1), torch.ones(b * s))
    y, aux = ffn.moe_apply(tp, _t(x), top_k=k, capacity_factor=1.25)
    assert y.shape == (b, s, D) and y.dtype == torch.bfloat16
    assert aux.dtype == torch.float32
    assert abs(float(aux) - float(want_aux)) <= AUX_TOL * float(want_aux)
    _close_ulp(y, want_y, ulps=2)
    cap = ffn.moe_capacity(b * s, e, k, 1.25)
    if name == "decode":
        assert cap == 8
    if name != "overflow":
        return
    # every token picked expert 0, which keeps its first `cap` tokens by
    # token order and drops the rest: those (and only those) differ from
    # the same call with room for all
    assert (ids[:, 0] == 0).all() and cap < b * s
    roomy, _ = ffn.moe_apply(tp, _t(x), top_k=k, capacity_factor=100.0)
    y, roomy = _np(y).reshape(-1, D), _np(roomy).reshape(-1, D)
    scale = np.abs(roomy).max()
    kept = np.abs(y - roomy).max(-1) <= ULP * scale
    assert kept[:cap].all() and not kept[cap:].any()


def test_moe_apply_grads_match_reference():
    """d(sum(y * w) + aux) against jax.grad: the input, the router (through
    the gates and the aux loss) and the experts."""
    import jax
    import jax.numpy as jnp
    from repro.models import ffn as jffn
    np_p, tp, x = _moe_case("top6", 16, 24)
    w = _bf16(np.random.RandomState(11), B, 24, D)

    def jloss(p, xx):
        y, aux = jffn.moe_apply(p, xx, top_k=6, capacity_factor=1.25)
        return jnp.sum(y.astype(jnp.float32) * w) + aux
    jg_p, jg_x = jax.grad(jloss, argnums=(0, 1))(_jtree(np_p), _j(x))
    for t in tp.parameters():
        t.requires_grad_(True)
    tx = _t(x).requires_grad_(True)
    y, aux = ffn.moe_apply(tp, tx, top_k=6, capacity_factor=1.25)
    ((y.float() * torch.from_numpy(w)).sum() + aux).backward()
    pairs = [(tx.grad, jg_x), (tp["router"].grad, jg_p["router"])]
    pairs += [(tp["experts"][n].grad, jg_p["experts"][n])
              for n in ("w1", "w2", "w3")]
    for got, want in pairs:
        got, want = _np(got), np.asarray(want, np.float32)
        assert np.linalg.norm(got - want) <= GRAD_TOL * np.linalg.norm(want)


# -- the moe block ------------------------------------------------------------

def _layer(np_params, i=0):
    import jax
    lp = jax.tree.map(lambda a: a[i], np_params["groups"][0]["s0"])
    tp = api._layer(api.params_from_jax(np_params, "cpu")["groups"][0]["s0"],
                    i)
    return lp, tp


@pytest.mark.parametrize("flash", [False, True])
def test_moe_block_matches_reference(weights, flash):
    """block_train (with its aux loss) and block_prefill over 24 positions
    (the attention the global kind's: one flash launch on the flash
    lane), then block_decode from the reference's K/V."""
    from repro.models import blocks as jblocks
    jcfg, cfg = _cfgs()
    lp, tp = _layer(weights)
    assert set(tp) == {"n1", "n2", "attn", "moe"}
    s = 24
    x = _bf16(np.random.RandomState(12), B, s, D)
    jctx = jblocks.Ctx(cfg=jcfg, positions=_j(np.arange(s), np.int32))
    ctx = blocks.Ctx(cfg=cfg, positions=torch.arange(s), flash=flash)
    want, wc = jblocks.block_prefill(_jtree(lp), "moe", _j(x), jctx)
    jtrain, jaux = jblocks.block_train(_jtree(lp), "moe", _j(x), jctx)
    ops.reset_counts()
    got, gc = blocks.block_prefill(tp, "moe", _t(x), ctx)
    assert ops.plain_counts()["flash_attention"] == int(flash)
    ttrain, aux = blocks.block_train(tp, "moe", _t(x), ctx)
    assert torch.equal(ttrain, got)
    assert _rel(got, want) < 2 * ULP and _rel(ttrain, jtrain) < 2 * ULP
    assert float(jaux) > 0
    np.testing.assert_allclose(float(aux), float(jaux), rtol=LOSS_RTOL)
    _close_ulp(gc["k"], wc["k"])
    _close_ulp(gc["v"], wc["v"])
    x1 = _bf16(np.random.RandomState(13), B, 1, D)
    pad = lambda a: np.pad(_np(a), ((0, 0), (0, 8), (0, 0), (0, 0)))
    jcache = {"k": _j(pad(wc["k"])), "v": _j(pad(wc["v"]))}
    tcache = {"k": _t(pad(wc["k"])), "v": _t(pad(wc["v"]))}
    kc = tcache["k"]
    want1, wc1 = jblocks.block_decode(_jtree(lp), "moe", _j(x1), jcache,
                                      _j(s, np.int32), jblocks.Ctx(cfg=jcfg))
    got1, gc1 = blocks.block_decode(tp, "moe", _t(x1), tcache, s,
                                    blocks.Ctx(cfg=cfg))
    assert gc1["k"] is kc                                   # in place
    assert _rel(got1, want1) < 2 * ULP
    _close_ulp(gc1["k"], wc1["k"])
    _close_ulp(gc1["v"], wc1["v"])


# -- the reduced moonshot-v1-16b-a3b ------------------------------------------

S = 48


def _leaves(cache):
    return {f"{gi}/{s}/{k}": v for gi, g in enumerate(cache)
            for s, e in g.items() for k, v in e.items()}


def _jax_prefill(np_params, tokens, flash, monkeypatch):
    from repro.models import api as japi
    if flash:
        monkeypatch.setenv("REPRO_FLASH_ATTN", "1")
    else:
        monkeypatch.delenv("REPRO_FLASH_ATTN", raising=False)
    jcfg, _ = _cfgs()
    return japi.prefill(_jtree(np_params), jcfg,
                        {"tokens": _j(tokens, np.int32)})


@pytest.mark.parametrize("flash", [False, True])
def test_prefill_matches_reference(weights, flash, monkeypatch):
    """Each moe layer's attention takes the flash kernel's plain version
    on the flash lane (the reference's flash_attention_chunked_ref)."""
    tokens = np.random.RandomState(14).randint(0, 512, (B, S))
    want, wcache = _jax_prefill(weights, tokens, flash, monkeypatch)
    _, cfg = _cfgs()
    ops.reset_counts()
    got, cache = api.prefill(api.params_from_jax(weights, "cpu"), cfg,
                             {"tokens": torch.from_numpy(tokens)},
                             flash=flash)
    assert ops.plain_counts()["flash_attention"] == (LAYERS if flash else 0)
    assert got.shape == (B, 512)
    assert _rel(got, want) < LOGIT_TOL
    g, w = _leaves(api.cache_to_numpy(cache)), _leaves(wcache)
    assert g.keys() == w.keys() == {"0/s0/k", "0/s0/v"}
    for key in w:
        assert g[key].shape == np.asarray(w[key]).shape, key
        assert _rel(g[key], w[key]) < LOGIT_TOL, key


def test_decode_steps_from_reference_cache(weights, monkeypatch):
    """The reference's prefill cache grown to S + 4 by the reference's
    rule, carried across; four decode steps in each package (at B = 2 a
    step routes 2 tokens into 4 experts of 8 slots), the later ones from
    each package's own cache, which the port writes in place: logits and
    the cache against the reference's returned one."""
    import jax
    from repro.models import api as japi
    jcfg, cfg = _cfgs()
    tokens = np.random.RandomState(15).randint(0, 512, (B, S))
    _, wcache = _jax_prefill(weights, tokens, False, monkeypatch)
    specs = japi.cache_specs(jcfg, B, S + 4)
    np_cache = jax.tree.map(
        lambda a, like: np.pad(np.asarray(a), [(0, l - n) for n, l in
                                               zip(a.shape, like.shape)]),
        wcache, specs)
    jp, params = _jtree(weights), api.params_from_jax(weights, "cpu")
    jc, tc = _jtree(np_cache), api.cache_from_jax(np_cache, "cpu")
    k = tc[0]["s0"]["k"]
    for i, token in enumerate(([3, 411], [7, 7], [500, 1], [2, 260])):
        tok = np.array(token)
        want, jc = japi.decode_step(jp, jcfg, _j(tok, np.int32),
                                    _j(S + i, np.int32), jc)
        got, tc = api.decode_step(params, cfg, torch.from_numpy(tok), S + i,
                                  tc)
        assert _rel(got, want) < LOGIT_TOL, i
    assert tc[0]["s0"]["k"] is k
    g, w = _leaves(api.cache_to_numpy(tc)), _leaves(jc)
    for key in w:
        assert _rel(g[key], w[key]) < LOGIT_TOL, key


def test_decode_consistent_with_forward(weights):
    """prefill(tokens[:-1]) + decode(tokens[-1]) gives forward(tokens)'s
    last logits, as tests/test_models_smoke.py holds the reference: the
    same top-1 and close values (the capacity differs between the two,
    64 tokens against 63 and 1)."""
    _, cfg = _cfgs()
    params = api.params_from_jax(weights, "cpu")
    toks = torch.from_numpy(np.random.RandomState(16).randint(0, 512,
                                                              (B, 64)))
    full, aux = api.forward(params, cfg, {"tokens": toks})
    assert float(aux) > 0
    _, cache = api.prefill(params, cfg, {"tokens": toks[:, :-1]})
    cache = tserve.grow_cache(cache, cfg, B, 64)
    dec, _ = api.decode_step(params, cfg, toks[:, -1], 63, cache)
    a, b = full[:, -1, :cfg.vocab].float(), dec[:, :cfg.vocab].float()
    assert torch.equal(a.argmax(-1), b.argmax(-1))
    torch.testing.assert_close(a, b, atol=0.5, rtol=0.15)


def test_train_loss_and_grads_match_reference(weights):
    """train_loss = ce + 0.01 aux against the reference's, the aux loss
    summed over the layers, and the gradient against jax.grad: the router
    (through the gates and the aux loss), the experts, the attention and
    the norms."""
    import jax
    from repro.models import api as japi
    jcfg, cfg = _cfgs()
    toks = np.random.RandomState(17).randint(0, 512, (B, S + 1))
    (want, jm), jgrad = jax.value_and_grad(
        lambda p: japi.train_loss(p, jcfg, {"tokens": _j(toks, np.int32)}),
        has_aux=True)(_jtree(weights))
    params = api.params_from_jax(weights, "cpu")
    for t in params.parameters():
        t.requires_grad_(True)
    got, metrics = api.train_loss(params, cfg,
                                  {"tokens": torch.from_numpy(toks)})
    got.backward()
    assert float(jm["aux"]) > LAYERS * 0.5      # E * sum f p >= 1 a layer
    np.testing.assert_allclose(float(metrics["aux"].detach()),
                               float(jm["aux"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(got.detach()), float(want),
                               rtol=LOSS_RTOL)
    slot, jslot = params["groups"][0]["s0"], jgrad["groups"][0]["s0"]
    pairs = [(slot["moe"]["router"], jslot["moe"]["router"]),
             (slot["attn"]["wq"], jslot["attn"]["wq"]),
             (slot["n2"], jslot["n2"])]
    pairs += [(slot["moe"]["experts"][n], jslot["moe"]["experts"][n])
              for n in ("w1", "w2", "w3")]
    for leaf, want_g in pairs:
        g = leaf.grad.float().numpy()
        w = np.asarray(want_g, np.float32)
        assert np.linalg.norm(g - w) <= GRAD_TOL * np.linalg.norm(w)


def test_params_carry_across(weights):
    """The reference's paths (``groups.0.s0.moe.experts.w1``) and dtypes
    (the router fp32, the experts bf16), bit for bit; the port's own init
    has the same shapes and dtypes, and no dense ``mlp``."""
    _, cfg = _cfgs()
    sd = api.params_from_jax(weights, "cpu").state_dict()
    moe = weights["groups"][0]["s0"]["moe"]
    assert sd["groups.0.s0.moe.router"].dtype == torch.float32
    np.testing.assert_array_equal(sd["groups.0.s0.moe.router"].numpy(),
                                  moe["router"])
    for name in ("w1", "w2", "w3"):
        t = sd[f"groups.0.s0.moe.experts.{name}"]
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      moe["experts"][name].view(np.int16))
    port = api.init_params(0, cfg, device="cpu").state_dict()
    assert {k: (tuple(v.shape), v.dtype) for k, v in port.items()} == \
        {k: (tuple(v.shape), v.dtype) for k, v in sd.items()}
    assert port["groups.0.s0.moe.experts.w2"].shape == (LAYERS, 4, FF, D)
    assert not any(".mlp." in k for k in port)
    # the router is drawn as bf16 and widened, as the reference's
    r = port["groups.0.s0.moe.router"]
    assert torch.equal(r, r.bfloat16().float())


# -- dense_init past the draw limit ------------------------------------------

def test_dense_init_draws_small_leaves_as_before():
    """Below the limit a leaf is one fp32 draw, scaled and cast: the values
    of every leaf qwen2.5-3b, gemma3-27b and recurrentgemma-9b draw stay
    what they were (their largest is under the limit); moonshot's expert
    leaves are past it."""
    from repro_torch.configs.base import get_arch
    g1 = torch.Generator().manual_seed(3)
    g2 = torch.Generator().manual_seed(3)
    got = common.dense_init(g1, (5, 7, 9), fan_in=7)
    want = (torch.randn((5, 7, 9), generator=g2, dtype=torch.float32)
            * 7 ** -0.5).to(torch.bfloat16)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))

    def past(arch):
        return {k for k, t in api.param_shapes(get_arch(arch)).state_dict()
                .items() if 4 * t.numel() > common.DRAW_LIMIT_BYTES}
    for arch in ("qwen2.5-3b", "gemma3-27b", "recurrentgemma-9b"):
        assert past(arch) == set(), arch
    assert past(ARCH) == {f"groups.0.s0.moe.experts.{n}"
                          for n in ("w1", "w2", "w3")}


def test_dense_init_slices_a_large_leaf(monkeypatch):
    """Past the limit the leaf is drawn one slice of its leading dim at a
    time (again if a slice is past it), each slice as a leaf of its own
    shape would be, into a leaf of the parameter dtype."""
    monkeypatch.setattr(common, "DRAW_LIMIT_BYTES", 4 * 7 * 9)
    g1 = torch.Generator().manual_seed(4)
    g2 = torch.Generator().manual_seed(4)
    got = common.dense_init(g1, (5, 7, 9), fan_in=7)
    want = torch.stack([(torch.randn((7, 9), generator=g2) * 7 ** -0.5)
                        .to(torch.bfloat16) for _ in range(5)])
    assert got.dtype == torch.bfloat16 and got.shape == (5, 7, 9)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    monkeypatch.setattr(common, "DRAW_LIMIT_BYTES", 4 * 8)
    got = common.dense_init(g1, (3, 4, 16), fan_in=4)
    want = torch.stack([torch.stack([
        (torch.randn((16,), generator=g2) * 4 ** -0.5).to(torch.bfloat16)
        for _ in range(4)]) for _ in range(3)])
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
