"""The port's encoder-decoder (whisper) against the JAX package: the
sinusoidal positions, the GELU MLP, the ``bidir`` and ``cross`` attention
kinds, the memory's K/V and the cross decode, the rope-free decode, the
encoder, the ``bidir`` and ``selfcross`` blocks, and the reduced
whisper-medium (d_model 64, 2 heads of 32, d_ff 128, vocab 512, 16 stub
frames) with its 2 encoder layers and 2 decoder layers through
``forward``, ``prefill``, ``decode_step`` and ``train_loss``.

Both packages compute from the same weights: the reference's
``init_params`` with every norm scale and GELU bias seeded (zeros at init
would hide them), carried across by ``params_from_jax``. Inputs are
seeded numpy; the reference runs on JAX's CPU with ``REPRO_FLASH_ATTN``
unset unless a test sets it. Tolerances are those of
tests/test_torch_model.py: a module within 1 bf16 ULP of the tensor's
largest magnitude (``_close_ulp``), a block within 2, the model's
logits and cache by ``max|d| / max|ref|`` below ``LOGIT_TOL`` (2e-2).
The fp32 sinusoid table is held within ``SIN_ATOL`` = 1e-6: XLA's and
PyTorch's fp32 sin and cos come from different code (measured 6.0e-8 at
whisper-medium's 1 500 x 1 024, one fp32 step, once the port rounds the
frequencies' power as XLA does: ``common.sinusoid_freqs``); an entry
one step apart may round to another bf16 value (``MAX_BF16_FLIPS``, a
share; measured 0 of 1 536 000). Largest measured elsewhere: the GELU MLP
0.54 ULP, the 2-layer encoder 1.22 ULP, prefill logits 6.1e-3.

The reference's ``selfcross`` prefill attends with roped q and k, but
caches the self K before rope and its decode ropes nothing; the port
mirrors it, so decode does not continue prefill exactly and decode
against ``forward`` holds only at the reference's own coarse tolerance
(tests/test_models_smoke.py: top-1 equal, atol 0.5, rtol 0.15).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.launch import serve as tserve
from repro_torch.models import api, attention, blocks, common, ffn
from test_torch_model import (LOGIT_TOL, ULP, _bf16, _close_ulp, _j, _jtree,
                              _np, _rel, _t)

ARCH = "whisper-medium"
LAYERS = 2                     # decoder layers; the encoder keeps its 2
SIN_ATOL = 1e-6
MAX_BF16_FLIPS = 1e-5          # share of bf16 table entries that may differ
GRAD_TOL = 2e-2                # ||d|| / ||ref|| per leaf, as test_torch_ssd
B, S, D, M = 2, 24, 64, 16     # batch, prompt, d_model, stub frames
H, KV, HD = 2, 2, 32


def _cfgs(layers=LAYERS):
    from repro.configs.base import get_arch as jget
    from repro_torch.configs.base import get_arch
    jcfg = dataclasses.replace(jget(ARCH).reduced(), n_layers=layers,
                               pattern_groups=((("selfcross",), layers),))
    return jcfg, tserve.with_layers(get_arch(ARCH).reduced(), layers)


def _np_params(seed=0):
    """The reference's random init as numpy, with the norm scales and the
    GELU biases of the encoder and the decoder seeded."""
    import jax
    from repro.models import api as japi
    jcfg, _ = _cfgs()
    params = jax.tree.map(np.asarray,
                          japi.init_params(jax.random.key(seed), jcfg))
    rng = np.random.RandomState(seed + 100)

    def seeded(a, scale):
        return (rng.randn(*a.shape) * scale).astype(np.float32)
    for slot in (params["groups"][0]["s0"], params["enc"]["blocks"]):
        for name in ("n1", "n2", "n3"):
            if name in slot:
                slot[name] = seeded(slot[name], 0.2)
        for name in ("b1", "b2"):
            slot["mlp"][name] = seeded(slot["mlp"][name], 0.5)
    params["enc"]["norm"] = seeded(params["enc"]["norm"], 0.2)
    params["final_norm"] = seeded(params["final_norm"], 0.2)
    return params


@pytest.fixture(scope="module")
def weights():
    return _np_params()


def _layer(np_params, i=0, enc=False):
    """Layer ``i`` of the decoder (or the encoder): numpy dict, and the
    port's dict."""
    import jax
    tree = api.params_from_jax(np_params, "cpu")
    if enc:
        return (jax.tree.map(lambda a: a[i], np_params["enc"]["blocks"]),
                api._layer(tree["enc"]["blocks"], i))
    return (jax.tree.map(lambda a: a[i], np_params["groups"][0]["s0"]),
            api._layer(tree["groups"][0]["s0"], i))


def _frames(seed, b=B):
    return _bf16(np.random.RandomState(seed), b, M, D)


def _flash_env(monkeypatch, flash):
    if flash:
        monkeypatch.setenv("REPRO_FLASH_ATTN", "1")
    else:
        monkeypatch.delenv("REPRO_FLASH_ATTN", raising=False)


def _bf16_bits(x):
    return torch.from_numpy(np.array(x, np.float32)).bfloat16().float()


# -- positions ----------------------------------------------------------------

def test_sinusoidal_positions_match_reference():
    """whisper-medium's encoder table (1 500 x 1 024): fp32 within
    SIN_ATOL; rounded to bf16, as both packages add it, a rare entry one
    bf16 step apart."""
    from repro.models import common as jcommon
    got = common.sinusoidal_positions(1500, 1024)
    want = np.asarray(jcommon.sinusoidal_positions(1500, 1024))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert float(np.abs(got.numpy() - want).max()) <= SIN_ATOL
    gb, wb = got.bfloat16().float(), _bf16_bits(want)
    flips = gb != wb
    assert float(flips.float().mean()) <= MAX_BF16_FLIPS
    assert float((gb - wb).abs().max()) <= 2 ** -8     # one step below 1


def test_embeddings_match_reference(weights):
    """The decoder's prompt embedding (the table) and its decode row at a
    few positions (computed alone, in both packages): within 1 ULP."""
    from repro.models import api as japi
    jcfg, cfg = _cfgs()
    params = api.params_from_jax(weights, "cpu")
    tokens = np.random.RandomState(1).randint(0, 512, (B, S))
    _close_ulp(api._embed(params, cfg, torch.from_numpy(tokens)),
               japi._embed(_jtree(weights), jcfg, _j(tokens, np.int32),
                           _j(np.arange(S), np.int32)))
    token = np.array([5, 300])
    for pos in (0, 37, 447):
        _close_ulp(api._decode_embed(params, cfg, torch.from_numpy(token),
                                     pos),
                   japi._decode_embed(_jtree(weights), jcfg,
                                      _j(token, np.int32),
                                      _j(pos, np.int32)))


# -- modules ------------------------------------------------------------------

def test_gelu_mlp_matches_reference(weights):
    """The tanh GELU between two biased products, the biases fp32: within
    1 ULP (a module)."""
    from repro.models import ffn as jffn
    lp, tp = _layer(weights)
    x = _bf16(np.random.RandomState(2), B, S, D)
    assert tp["mlp"]["b1"].dtype == torch.float32
    _close_ulp(ffn.gelu_mlp(tp["mlp"], _t(x)),
               jffn.gelu_mlp(_jtree(lp["mlp"]), _j(x)))


@pytest.mark.parametrize("flash", [False, True])
def test_bidir_attention_matches_reference(weights, flash, monkeypatch):
    """Non-causal, rope-free attention of the encoder (``attn_full``) on
    both lanes; neither launches the flash kernel: within 1 ULP."""
    from repro.models import attention as jattn
    _flash_env(monkeypatch, flash)
    lp, tp = _layer(weights, enc=True)
    x = _bf16(np.random.RandomState(3), B, M, D)
    kw = dict(n_kv=KV, kind="bidir", theta=1e4)
    want = jattn.attn_train(_jtree(lp["attn"]), _j(x), window=32,
                            positions=_j(np.arange(M), np.int32), **kw)
    ops.reset_counts()
    got = attention.attn_train(tp["attn"], _t(x), positions=torch.arange(M),
                               flash=flash, **kw)
    assert ops.plain_counts()["flash_attention"] == 0
    _close_ulp(got, want)


@pytest.mark.parametrize("flash", [False, True])
def test_cross_attention_matches_reference(weights, flash, monkeypatch):
    """S = 24 queries against M = 16 memory keys, no rope, no flash
    launch on either lane; the K/V it returns are ``memory_kv``'s: within
    1 ULP."""
    from repro.models import attention as jattn
    _flash_env(monkeypatch, flash)
    lp, tp = _layer(weights)
    rng = np.random.RandomState(4)
    x, mem = _bf16(rng, B, S, D), _bf16(rng, B, M, D)
    kw = dict(n_kv=KV, kind="cross", theta=1e4)
    want = jattn.attn_train(_jtree(lp["xattn"]), _j(x), window=32,
                            positions=_j(np.arange(S), np.int32),
                            memory=_j(mem), **kw)
    ops.reset_counts()
    got, k, v = attention.attn_prefill(tp["xattn"], _t(x),
                                       positions=torch.arange(S),
                                       flash=flash, memory=_t(mem), **kw)
    assert ops.plain_counts()["flash_attention"] == 0
    assert got.shape == (B, S, D) and k.shape == (B, M, KV, HD)
    _close_ulp(got, want)
    mk, mv = attention.memory_kv(tp["xattn"], _t(mem))
    assert torch.equal(k, mk) and torch.equal(v, mv)
    with pytest.raises(ValueError, match="needs a memory"):
        attention.attn_train(tp["xattn"], _t(x), positions=torch.arange(S),
                             **kw)


def test_memory_kv_and_decode_cross_attn_match(weights):
    """The memory's K/V, then one token's cross-attention against them
    (every position valid): within 1 ULP."""
    from repro.models import attention as jattn
    lp, tp = _layer(weights)
    rng = np.random.RandomState(5)
    mem, x1 = _bf16(rng, B, M, D), _bf16(rng, B, 1, D)
    jk, jv = jattn.memory_kv(_jtree(lp["xattn"]), _j(mem))
    k, v = attention.memory_kv(tp["xattn"], _t(mem))
    _close_ulp(k, jk)
    _close_ulp(v, jv)
    want = jattn.decode_cross_attn(_jtree(lp["xattn"]), _j(x1), jk, jv,
                                   n_kv=KV)
    got = attention.decode_cross_attn(tp["xattn"], _t(x1), _t(jk), _t(jv),
                                      KV)
    assert got.shape == (B, 1, D)
    _close_ulp(got, want)


def test_rope_free_decode_attn_matches(weights):
    """``decode_attn(rope=False)``: the new K/V written un-roped at
    ``pos``, in place; within 1 ULP; the roped lane differs."""
    from repro.models import attention as jattn
    lp, tp = _layer(weights)
    rng = np.random.RandomState(6)
    x1 = _bf16(rng, B, 1, D)
    kc, vc = _bf16(rng, B, 40, KV, HD), _bf16(rng, B, 40, KV, HD)
    pos = 29
    want, wk, wv = jattn.decode_attn(
        _jtree(lp["attn"]), _j(x1), _j(kc), _j(vc), _j(pos, np.int32),
        n_kv=KV, theta=1e4, layout=jattn.KVLayout(40), rope=False)
    tk, tv = _t(kc), _t(vc)
    got, gk, gv = attention.decode_attn(
        tp["attn"], _t(x1), tk, tv, pos, n_kv=KV, theta=1e4,
        layout=attention.KVLayout(40), rope=False)
    assert gk is tk and gv is tv
    _close_ulp(got, want)
    _close_ulp(gk, wk)
    _close_ulp(gv, wv)
    k_new, _ = attention.memory_kv(tp["attn"], _t(x1))
    assert torch.equal(gk[:, pos], k_new[:, 0])
    roped, _, _ = attention.decode_attn(
        tp["attn"], _t(x1), _t(kc), _t(vc), pos, n_kv=KV, theta=1e4,
        layout=attention.KVLayout(40))
    assert not torch.equal(roped, got)


def test_encode_matches_reference(weights):
    """The encoder over 16 stub frames: sinusoidal positions, two
    ``bidir`` blocks and the encoder's norm: within 2 ULP (a block's
    bound; the two measured 1.22)."""
    from repro.models import api as japi
    jcfg, cfg = _cfgs()
    frames = _frames(7)
    want = japi.encode(_jtree(weights), jcfg, _j(frames))
    got = api.encode(api.params_from_jax(weights, "cpu"), cfg, _t(frames))
    assert got.shape == (B, M, D) and got.dtype == torch.bfloat16
    _close_ulp(got, want, ulps=2)


# -- blocks -------------------------------------------------------------------

def test_bidir_block_matches_reference(weights):
    """One encoder block (train): attention, then the GELU MLP: within 2
    ULP; aux 0."""
    from repro.models import blocks as jblocks
    jcfg, cfg = _cfgs()
    lp, tp = _layer(weights, 1, enc=True)
    x = _bf16(np.random.RandomState(8), B, M, D)
    want, _ = jblocks.block_train(
        _jtree(lp), "bidir", _j(x),
        jblocks.Ctx(cfg=jcfg, positions=_j(np.arange(M), np.int32)))
    got, aux = blocks.block_train(
        tp, "bidir", _t(x), blocks.Ctx(cfg=cfg, positions=torch.arange(M)))
    assert float(aux) == 0.0 and set(tp) == {"n1", "n2", "attn", "mlp"}
    assert _rel(got, want) < 2 * ULP


@pytest.mark.parametrize("flash", [False, True])
def test_selfcross_block_matches_reference(weights, flash, monkeypatch):
    """One decoder block: prefill (the flash lane launches once, for the
    self-attention) against the reference's, its cache (the self K
    un-roped, the memory's K/V), then one decode step from the
    reference's cache: within 2 ULP."""
    from repro.models import blocks as jblocks
    _flash_env(monkeypatch, flash)
    jcfg, cfg = _cfgs()
    lp, tp = _layer(weights)
    rng = np.random.RandomState(9)
    x, mem = _bf16(rng, B, S, D), _bf16(rng, B, M, D)
    jctx = jblocks.Ctx(cfg=jcfg, positions=_j(np.arange(S), np.int32),
                       memory=_j(mem))
    ctx = blocks.Ctx(cfg=cfg, positions=torch.arange(S), memory=_t(mem),
                     flash=flash)
    want, wc = jblocks.block_prefill(_jtree(lp), "selfcross", _j(x), jctx)
    ops.reset_counts()
    got, gc = blocks.block_prefill(tp, "selfcross", _t(x), ctx)
    assert ops.plain_counts()["flash_attention"] == int(flash)
    assert _rel(got, want) < 2 * ULP
    assert set(gc) == {"k", "v", "mk", "mv"}
    for key in gc:
        _close_ulp(gc[key], wc[key])
    xn = common.rms_norm(_t(x), tp["n1"], cfg.norm_eps)
    assert torch.equal(gc["k"], attention.memory_kv(tp["attn"], xn)[0])
    jtrain, _ = jblocks.block_train(_jtree(lp), "selfcross", _j(x), jctx)
    ttrain, _ = blocks.block_train(tp, "selfcross", _t(x), ctx)
    assert torch.equal(ttrain, got)
    assert _rel(ttrain, jtrain) < 2 * ULP
    x1 = _bf16(rng, B, 1, D)
    pad = lambda a: np.pad(_np(a), ((0, 0), (0, 8), (0, 0), (0, 0)))
    jcache = {"k": _j(pad(wc["k"])), "v": _j(pad(wc["v"])),
              "mk": wc["mk"], "mv": wc["mv"]}
    tcache = {"k": _t(pad(wc["k"])), "v": _t(pad(wc["v"])),
              "mk": _t(wc["mk"]), "mv": _t(wc["mv"])}
    want1, wc1 = jblocks.block_decode(_jtree(lp), "selfcross", _j(x1),
                                      jcache, _j(S, np.int32),
                                      jblocks.Ctx(cfg=jcfg))
    got1, gc1 = blocks.block_decode(tp, "selfcross", _t(x1), tcache, S,
                                    blocks.Ctx(cfg=cfg))
    assert gc1 is tcache
    assert _rel(got1, want1) < 2 * ULP
    for key in ("k", "v"):
        _close_ulp(gc1[key], wc1[key])


# -- the reduced whisper-medium -----------------------------------------------

def _leaves(cache):
    return {f"{gi}/{s}/{k}": v for gi, g in enumerate(cache)
            for s, e in g.items() for k, v in e.items()}


def _jax_prefill(np_params, tokens, frames):
    from repro.models import api as japi
    jcfg, _ = _cfgs()
    return japi.prefill(_jtree(np_params), jcfg,
                        {"tokens": _j(tokens, np.int32),
                         "frames": _j(frames)})


def _batch(tokens, frames):
    return {"tokens": torch.from_numpy(tokens), "frames": _t(frames)}


def test_forward_matches_reference(weights):
    from repro.models import api as japi
    jcfg, cfg = _cfgs()
    tokens = np.random.RandomState(10).randint(0, 512, (B, S))
    frames = _frames(11)
    want, _ = japi.forward(_jtree(weights), jcfg,
                           {"tokens": _j(tokens, np.int32),
                            "frames": _j(frames)})
    got, aux = api.forward(api.params_from_jax(weights, "cpu"), cfg,
                           _batch(tokens, frames))
    assert got.shape == (B, S, 512) and float(aux) == 0.0
    assert _rel(got, want) < LOGIT_TOL


@pytest.mark.parametrize("flash", [False, True])
def test_prefill_matches_reference(weights, flash, monkeypatch):
    """Logits and every cache leaf (the decoder's un-roped K/V, the
    memory's K/V of each layer); the flash lane launches once a decoder
    layer and never in the encoder."""
    _flash_env(monkeypatch, flash)
    _, cfg = _cfgs()
    tokens = np.random.RandomState(12).randint(0, 512, (B, S))
    frames = _frames(13)
    want, wcache = _jax_prefill(weights, tokens, frames)
    ops.reset_counts()
    got, cache = api.prefill(api.params_from_jax(weights, "cpu"), cfg,
                             _batch(tokens, frames), flash=flash)
    assert ops.plain_counts()["flash_attention"] == (LAYERS if flash else 0)
    assert got.shape == (B, 512) and got.dtype == torch.bfloat16
    assert _rel(got, want) < LOGIT_TOL
    g, w = _leaves(api.cache_to_numpy(cache)), _leaves(wcache)
    assert g.keys() == w.keys() == {"0/s0/k", "0/s0/v", "0/s0/mk", "0/s0/mv"}
    for key in w:
        assert g[key].shape == np.asarray(w[key]).shape, key
        assert _rel(g[key], w[key]) < LOGIT_TOL, key


def test_decode_steps_from_reference_cache(weights):
    """The reference's prefill cache, grown by 4 zero positions, carried
    across; four decode steps in each package from its own cache (the
    port's written in place): logits and every leaf against the
    reference's returned cache; the memory's K/V are not written."""
    from repro.models import api as japi
    jcfg, cfg = _cfgs()
    tokens = np.random.RandomState(14).randint(0, 512, (B, S))
    _, wcache = _jax_prefill(weights, tokens, _frames(15))
    grow = {"k": ((0, 0), (0, 0), (0, 4), (0, 0), (0, 0)),
            "v": ((0, 0), (0, 0), (0, 4), (0, 0), (0, 0))}
    np_cache = tuple({s: {k: np.pad(np.asarray(v), grow.get(k, 0))
                          for k, v in e.items()}
                      for s, e in g.items()} for g in wcache)
    jp, params = _jtree(weights), api.params_from_jax(weights, "cpu")
    jc, tc = _jtree(np_cache), api.cache_from_jax(np_cache, "cpu")
    k, mk = tc[0]["s0"]["k"], tc[0]["s0"]["mk"].clone()
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
    assert tc[0]["s0"]["k"] is k and torch.equal(tc[0]["s0"]["mk"], mk)


def test_decode_consistent_with_forward(weights):
    """prefill(tokens[:-1]) + decode(tokens[-1]) against forward(tokens)'s
    last logits, at the reference's own coarse tolerance: its prefill
    attends with roped K but caches and decodes without rope."""
    _, cfg = _cfgs()
    params = api.params_from_jax(weights, "cpu")
    toks = torch.from_numpy(np.random.RandomState(16).randint(0, 512,
                                                              (B, 64)))
    frames = _t(_frames(17))
    full, _ = api.forward(params, cfg, {"tokens": toks, "frames": frames})
    _, cache = api.prefill(params, cfg, {"tokens": toks[:, :-1],
                                         "frames": frames})
    cache = tserve.grow_cache(cache, cfg, B, 64)
    dec, _ = api.decode_step(params, cfg, toks[:, -1], 63, cache)
    a, b = full[:, -1, :cfg.vocab].float(), dec[:, :cfg.vocab].float()
    assert torch.equal(a.argmax(-1), b.argmax(-1))
    torch.testing.assert_close(a, b, atol=0.5, rtol=0.15)


def test_train_loss_and_grads_match_reference(weights):
    """train_loss against the reference's (no aux), and its gradient
    against jax.grad, every leaf of the encoder and the decoder within
    GRAD_TOL."""
    import jax
    from repro.models import api as japi
    from test_torch_local import LOSS_RTOL
    jcfg, cfg = _cfgs()
    toks = np.random.RandomState(18).randint(0, 512, (B, S + 1))
    frames = _frames(19)
    (want, _), jgrad = jax.value_and_grad(
        lambda p: japi.train_loss(p, jcfg, {"tokens": _j(toks, np.int32),
                                            "frames": _j(frames)}),
        has_aux=True)(_jtree(weights))
    params = api.params_from_jax(weights, "cpu")
    for t in params.parameters():
        t.requires_grad_(True)
    got, metrics = api.train_loss(params, cfg, _batch(toks, frames))
    got.backward()
    assert float(metrics["aux"]) == 0.0
    np.testing.assert_allclose(float(got.detach()), float(want),
                               rtol=LOSS_RTOL)
    jleaves = dict(api.named_leaves(api.params_from_jax(
        jax.tree.map(np.asarray, jgrad), "cpu")))
    checked = 0
    for name, leaf in api.named_leaves(params):
        g, w = leaf.grad.float().numpy(), jleaves[name].float().numpy()
        assert np.linalg.norm(g - w) <= GRAD_TOL * np.linalg.norm(w), name
        checked += name.startswith("enc.")
    assert checked == 11       # 10 leaves of the encoder blocks, its norm


def test_specs_match_reference():
    """cache_specs (the selfcross entry: k, v of the sequence, mk, mv of
    the frames) and input_specs (the frames), full and reduced."""
    from repro.configs.base import ShapeConfig as JShape
    from repro.configs.base import get_arch as jget
    from repro.models import api as japi
    from repro_torch.configs.base import ShapeConfig, get_arch
    for jcfg, cfg in ((jget(ARCH), get_arch(ARCH)),
                      (jget(ARCH).reduced(), get_arch(ARCH).reduced())):
        want = _leaves(japi.cache_specs(jcfg, B, 448))
        got = _leaves(api.cache_specs(cfg, B, 448))
        assert got.keys() == want.keys()
        for key in want:
            assert tuple(got[key].shape) == want[key].shape, key
            assert got[key].dtype == torch.bfloat16
        assert got["0/s0/mk"].shape[2] == cfg.frontend_tokens
        for kind in ("train", "prefill"):
            ins = api.input_specs(cfg, ShapeConfig("t", 448, B, kind))
            jins = japi.input_specs(jcfg, JShape("t", 448, B, kind))
            assert ins.keys() == jins.keys() == {"tokens", "frames"}
            assert tuple(ins["frames"].shape) == jins["frames"].shape
            assert ins["frames"].dtype == torch.bfloat16


def test_params_carry_across_bit_for_bit(weights):
    """The encoder's blocks and norm cross by path, bit for bit; the port's
    own init has the same leaves, shapes and dtypes (fp32 norms and GELU
    biases)."""
    _, cfg = _cfgs()
    sd = api.params_from_jax(weights, "cpu").state_dict()
    enc = weights["enc"]["blocks"]
    for name, arr in (("enc.blocks.attn.wq", enc["attn"]["wq"]),
                      ("enc.blocks.mlp.b1", enc["mlp"]["b1"]),
                      ("enc.norm", weights["enc"]["norm"])):
        t = sd[name]
        if arr.dtype.name == "bfloat16":
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          arr.view(np.int16))
        else:
            assert t.dtype == torch.float32
            np.testing.assert_array_equal(t.numpy(), arr)
    port = api.init_params(0, cfg, device="cpu").state_dict()
    assert {k: (tuple(v.shape), v.dtype) for k, v in port.items()} == \
        {k: (tuple(v.shape), v.dtype) for k, v in sd.items()}
    assert tuple(port["enc.blocks.n1"].shape) == (cfg.enc_layers, D)
    assert "groups.0.s0.n3" in port and "groups.0.s0.xattn.wq" in port


# -- on the card ----------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_serve_matches_cpu(cuda):
    """The reduced whisper at 2 decoder layers on the card (two flash
    launches a prefill, the encoder's dense attention, telemetry through
    sparse_addto) against the same weights, frames and tokens on the CPU,
    teacher forced: logits within LOGIT_TOL at every step."""
    import copy
    cfg = tserve.model_config(ARCH, reduced=True, layers=LAYERS)
    p_cpu = api.init_params(5, cfg, device="cpu")
    kw = dict(arch=ARCH, prompt_len=64, decode_n=4, batch=B, reduced=True,
              layers=LAYERS)
    ops.reset_counts()
    card = tserve.serve(device=None, params=copy.deepcopy(p_cpu).to(cuda),
                        **kw)
    counts = ops.launch_counts()
    assert counts["flash_attention"] == LAYERS and counts["sparse_addto"] > 0
    cpu = tserve.serve(device="cpu", params=p_cpu,
                       feed=card["tokens"][:, :-1].cpu(), **kw)
    for t in range(5):
        la, lb = card["logits"][t].float().cpu(), cpu["logits"][t].float()
        assert float((la - lb).abs().max() / lb.abs().max()) < LOGIT_TOL
