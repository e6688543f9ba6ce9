"""The port's model stack (``repro_torch.models``) against the JAX package.

Both packages run the reduced qwen2.5-3b config (d_model 64, 4 heads, 2
KV heads, head_dim 32, vocab 512, QKV bias) at one and two layers, on the
same weights: the reference's ``init_params`` from a JAX key, with the
zero-initialised biases and norm scales replaced by seeded numpy values
so that they matter, carried across by ``params_from_jax``. Inputs are
seeded numpy.

Tolerances. Both packages run bf16 einsums that accumulate in fp32 and
round to bf16, in different summation orders, so an output may differ by
a unit in the last place (``ULP``, 2**-7 of the largest magnitude of the
tensor), and differences grow through the residual stream. Modules are
held within 1 ULP, blocks within 2, and the whole-model logits and cache
by ``max|d| / max|ref|`` below ``LOGIT_TOL`` (2.56 ULP); the largest
measured were 0.75 ULP (swiglu), 0.71 (a decode block's cache) and 0.96
(two-layer prefill logits, flash lane). The JAX package's flash lane on the CPU runs
``flash_attention_chunked_ref``, the same fp32 math as the port's plain
``ref.flash_attention``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.launch.serve import with_layers
from repro_torch.models import api, attention, blocks, common, ffn

ULP = 2 ** -7                  # one bf16 unit in the last place, relative
LOGIT_TOL = 2e-2               # whole model: max|d| / max|ref|
B, S = 2, 24


def _jax_cfg(layers):
    from repro.configs.base import get_arch
    cfg = get_arch("qwen2.5-3b").reduced()
    return dataclasses.replace(cfg, n_layers=layers,
                               pattern_groups=((("global",), layers),))


def _port_cfg(layers):
    from repro_torch.configs.base import get_arch
    return with_layers(get_arch("qwen2.5-3b").reduced(), layers)


def _np_params(layers, seed=0):
    """The reference's random init at ``layers`` layers as numpy, with
    seeded biases and norm scales."""
    import jax
    from repro.models import api as japi
    params = jax.tree.map(np.asarray,
                          japi.init_params(jax.random.key(seed),
                                           _jax_cfg(layers)))
    rng = np.random.RandomState(seed + 100)
    g = params["groups"][0]["s0"]
    for name in ("bq", "bk", "bv"):
        a = g["attn"][name]
        g["attn"][name] = (rng.randn(*a.shape) * 0.5).astype(a.dtype)
    for name in ("n1", "n2"):
        g[name] = (rng.randn(*g[name].shape) * 0.2).astype(np.float32)
    params["final_norm"] = (rng.randn(*params["final_norm"].shape)
                            * 0.2).astype(np.float32)
    return params


@pytest.fixture(scope="module")
def weights():
    return {n: _np_params(n) for n in (1, 2)}


def _bf16(rng, *shape, scale=1.0):
    """Seeded values exactly representable in bf16, as fp32 numpy."""
    x = torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32))
    return x.bfloat16().float().numpy()


def _j(x, dtype=None):
    import jax.numpy as jnp
    return jnp.asarray(x, dtype or jnp.bfloat16)


def _t(x, dtype=torch.bfloat16):
    return torch.from_numpy(np.asarray(x, np.float32)).to(dtype)


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


def _close_ulp(got, want, ulps=1):
    """Every element within ``ulps`` bf16 steps of the tensor's largest
    magnitude. (Per element, a rounding before a cancellation, as in the
    bias add or silu(x1) * x3, leaves a difference of one step of the
    operands, not of the small result.)"""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= ulps * ULP * np.abs(want).max()


def _rel(got, want) -> float:
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _layer0(np_params):
    """Layer 0 of the block stack: numpy dict, and the port's dict."""
    import jax
    lp = jax.tree.map(lambda a: a[0], np_params["groups"][0]["s0"])
    tp = api._layer(api.params_from_jax(np_params, "cpu")["groups"][0]["s0"],
                    0)
    return lp, tp


def _jtree(tree):
    import jax
    return jax.tree.map(lambda a: _j(a, a.dtype), tree)


# -- configs and parameters ---------------------------------------------------

def test_configs_are_the_reference_configs():
    from repro.configs.base import get_arch as jget, list_archs as jlist
    from repro_torch.configs.base import get_arch, list_archs
    assert list_archs() == jlist()
    for name in list_archs():
        assert dataclasses.asdict(get_arch(name)) == \
            dataclasses.asdict(jget(name))
        assert dataclasses.asdict(get_arch(name).reduced()) == \
            dataclasses.asdict(jget(name).reduced())


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "phi4-mini-3.8b",
                                  "stablelm-1.6b", "gemma3-27b",
                                  "recurrentgemma-9b", "mamba2-780m",
                                  "moonshot-v1-16b-a3b", "grok-1-314b",
                                  "whisper-medium", "llama-3.2-vision-90b"])
def test_count_params_matches_reference(arch):
    from repro.configs.base import get_arch as jget
    from repro_torch.configs.base import get_arch
    from repro.models import api as japi
    want = japi.count_params(jget(arch))
    assert api.count_params(get_arch(arch)) == want
    assert get_arch(arch).n_params() == want
    active = japi.count_params(jget(arch), active_only=True)
    assert api.count_params(get_arch(arch), active_only=True) == active
    assert get_arch(arch).n_active_params() == active
    assert (active < want) == (get_arch(arch).n_experts > 0)
    if arch == "moonshot-v1-16b-a3b":
        assert (want, active) == (27_722_450_944, 3_638_757_376)
    if arch == "qwen2.5-3b":
        assert 3.08e9 < want < 3.10e9
    if arch == "gemma3-27b":
        assert want == 27_008_319_744
    if arch == "recurrentgemma-9b":
        assert want == 8_578_519_040
    if arch == "whisper-medium":        # encoder and decoder
        assert want == 758_228_992
    if arch == "llama-3.2-vision-90b":  # mproj and the untied lm_head
        assert want == 87_733_903_380


def test_params_carry_across_bit_for_bit(weights):
    np_params = weights[2]
    params = api.params_from_jax(np_params, "cpu")
    sd = params.state_dict()
    assert "groups.0.s0.attn.wq" in sd and "embed" in sd
    wq = np_params["groups"][0]["s0"]["attn"]["wq"]
    assert sd["groups.0.s0.attn.wq"].dtype == torch.bfloat16
    assert sd["groups.0.s0.attn.wq"].shape == wq.shape
    np.testing.assert_array_equal(
        sd["groups.0.s0.attn.wq"].view(torch.int16).numpy(),
        wq.view(np.int16))
    assert sd["groups.0.s0.n1"].dtype == torch.float32
    total = sum(np.asarray(a).size for a in _leaves(np_params))
    assert sum(t.numel() for t in params.parameters()) == total
    port = api.init_params(0, _port_cfg(2), device="cpu")
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in sd.items()}


def _leaves(tree):
    import jax
    return jax.tree.leaves(tree)


# -- modules ------------------------------------------------------------------

def test_rms_norm_and_rope_match():
    from repro.models import common as jcommon
    rng = np.random.RandomState(0)
    x = _bf16(rng, B, S, 64, scale=3.0)
    scale = (rng.randn(64) * 0.3).astype(np.float32)
    _close_ulp(common.rms_norm(_t(x), torch.from_numpy(scale), 1e-6),
               jcommon.rms_norm(_j(x), _j(scale, np.float32), 1e-6))
    q = _bf16(rng, B, S, 4, 32)
    pos = np.arange(S)
    _close_ulp(common.apply_rope(_t(q), torch.from_numpy(pos), 1e4),
               jcommon.apply_rope(_j(q), _j(pos, np.int32), 1e4))
    # decode: one position per row, (B, 1)
    posb = np.full((B, 1), 37)
    _close_ulp(common.apply_rope(_t(q[:, :1]), torch.from_numpy(posb), 1e4),
               jcommon.apply_rope(_j(q[:, :1]), _j(posb, np.int32), 1e4))


def test_qkv_with_bias_and_swiglu_match(weights):
    from repro.models import attention as jattn
    from repro.models import ffn as jffn
    lp, tp = _layer0(weights[1])
    x = _bf16(np.random.RandomState(1), B, S, 64)
    for got, want in zip(attention.qkv(tp["attn"], _t(x)),
                         jattn.qkv(_jtree(lp["attn"]), _j(x))):
        _close_ulp(got, want)
    h = _bf16(np.random.RandomState(2), B, S, 64)
    _close_ulp(ffn.swiglu(tp["mlp"], _t(h)),
               jffn.swiglu(_jtree(lp["mlp"]), _j(h)))


@pytest.mark.parametrize("flash", [False, True])
def test_attn_train_matches_both_lanes(weights, flash, monkeypatch):
    from repro.models import attention as jattn
    if flash:
        monkeypatch.setenv("REPRO_FLASH_ATTN", "1")
    else:
        monkeypatch.delenv("REPRO_FLASH_ATTN", raising=False)
    lp, tp = _layer0(weights[1])
    x = _bf16(np.random.RandomState(3), B, S, 64)
    kw = dict(n_kv=2, kind="global", theta=1e4)
    want = jattn.attn_train(_jtree(lp["attn"]), _j(x), window=32,
                            positions=_j(np.arange(S), np.int32), **kw)
    ops.reset_counts()
    got = attention.attn_train(tp["attn"], _t(x),
                               positions=torch.arange(S), flash=flash, **kw)
    assert ops.plain_counts()["flash_attention"] == int(flash)
    _close_ulp(got, want)


def test_chunked_attention_matches_full():
    """Above CHUNKED_THRESHOLD the dense lane loops over query chunks;
    the same masked softmax per row, so equal to the single shot."""
    rng = np.random.RandomState(4)
    q, k, v = (_t(_bf16(rng, 1, 64, h, 32)) for h in (4, 2, 2))
    torch.testing.assert_close(
        attention.attn_causal_chunked(q, k, v, 2, q_chunk=16),
        attention.attn_full(q, k, v, 2, causal=True), atol=0, rtol=0)


def test_decode_attn_matches(weights):
    from repro.models import attention as jattn
    lp, tp = _layer0(weights[1])
    rng = np.random.RandomState(5)
    x1 = _bf16(rng, B, 1, 64)
    kc, vc = _bf16(rng, B, 40, 2, 32), _bf16(rng, B, 40, 2, 32)
    pos = 29
    want, wk, wv = jattn.decode_attn(
        _jtree(lp["attn"]), _j(x1), _j(kc), _j(vc), _j(pos, np.int32),
        n_kv=2, theta=1e4, layout=jattn.KVLayout(40))
    tk, tv = _t(kc), _t(vc)
    got, gk, gv = attention.decode_attn(
        tp["attn"], _t(x1), tk, tv, pos, n_kv=2, theta=1e4,
        layout=attention.KVLayout(40))
    assert gk is tk and gv is tv                    # updated in place
    _close_ulp(got, want)
    _close_ulp(gk, wk)
    _close_ulp(gv, wv)
    np.testing.assert_array_equal(_np(gk[:, :pos]), kc[:, :pos])


def test_block_prefill_and_decode_match(weights):
    from repro.models import blocks as jblocks
    from repro.configs.base import get_arch as jget
    lp, tp = _layer0(weights[1])
    jcfg, cfg = _jax_cfg(1), _port_cfg(1)
    x = _bf16(np.random.RandomState(6), B, S, 64)
    want, wc = jblocks.block_prefill(
        _jtree(lp), "global", _j(x),
        jblocks.Ctx(cfg=jcfg, positions=_j(np.arange(S), np.int32)))
    got, gc = blocks.block_prefill(
        tp, "global", _t(x), blocks.Ctx(cfg=cfg, positions=torch.arange(S)))
    assert _rel(got, want) < 2 * ULP
    jtrain, _ = jblocks.block_train(
        _jtree(lp), "global", _j(x),
        jblocks.Ctx(cfg=jcfg, positions=_j(np.arange(S), np.int32)))
    ttrain, aux = blocks.block_train(
        tp, "global", _t(x), blocks.Ctx(cfg=cfg, positions=torch.arange(S)))
    assert torch.equal(ttrain, got) and float(aux) == 0.0
    assert _rel(ttrain, jtrain) < 2 * ULP
    _close_ulp(gc["k"], wc["k"])
    _close_ulp(gc["v"], wc["v"])
    x1 = _bf16(np.random.RandomState(7), B, 1, 64)
    pad = lambda a: np.pad(_np(a), ((0, 0), (0, 8), (0, 0), (0, 0)))
    jcache = {"k": _j(pad(wc["k"])), "v": _j(pad(wc["v"]))}
    tcache = {"k": _t(pad(wc["k"])), "v": _t(pad(wc["v"]))}
    want1, wc1 = jblocks.block_decode(_jtree(lp), "global", _j(x1), jcache,
                                      _j(S, np.int32), jblocks.Ctx(cfg=jcfg))
    got1, gc1 = blocks.block_decode(tp, "global", _t(x1), tcache, S,
                                    blocks.Ctx(cfg=cfg))
    assert _rel(got1, want1) < 2 * ULP
    _close_ulp(gc1["k"], wc1["k"])
    assert jget("qwen2.5-3b").qkv_bias


# -- the whole model ----------------------------------------------------------

def _jax_prefill(np_params, layers, tokens, flash, monkeypatch):
    from repro.models import api as japi
    if flash:
        monkeypatch.setenv("REPRO_FLASH_ATTN", "1")
    else:
        monkeypatch.delenv("REPRO_FLASH_ATTN", raising=False)
    return japi.prefill(_jtree(np_params), _jax_cfg(layers),
                        {"tokens": _j(tokens, np.int32)})


@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("flash", [False, True])
def test_prefill_matches_reference(weights, layers, flash, monkeypatch):
    tokens = np.random.RandomState(8).randint(0, 512, (B, S))
    want, wcache = _jax_prefill(weights[layers], layers, tokens, flash,
                                monkeypatch)
    params = api.params_from_jax(weights[layers], "cpu")
    ops.reset_counts()
    got, cache = api.prefill(params, _port_cfg(layers),
                             {"tokens": torch.from_numpy(tokens)},
                             flash=flash)
    assert ops.plain_counts()["flash_attention"] == (layers if flash else 0)
    assert got.shape == (B, 512) and got.dtype == torch.bfloat16
    assert _rel(got, want) < LOGIT_TOL
    for g, w in zip(api.cache_to_numpy(cache), wcache):
        for key in ("k", "v"):
            assert g["s0"][key].shape == np.asarray(w["s0"][key]).shape
            assert _rel(g["s0"][key], w["s0"][key]) < LOGIT_TOL


@pytest.mark.parametrize("layers", [1, 2])
def test_decode_step_from_reference_cache(weights, layers, monkeypatch):
    """The reference's own prefill cache, grown by 4 zero positions,
    carried across; one decode step in each package."""
    from repro.models import api as japi
    tokens = np.random.RandomState(9).randint(0, 512, (B, S))
    _, wcache = _jax_prefill(weights[layers], layers, tokens, False,
                             monkeypatch)
    np_cache = tuple({"s0": {k: np.pad(np.asarray(v),
                                       ((0, 0), (0, 0), (0, 4), (0, 0),
                                        (0, 0)))
                             for k, v in g["s0"].items()}} for g in wcache)
    token = np.array([3, 411])
    want, wnext = japi.decode_step(_jtree(weights[layers]), _jax_cfg(layers),
                                   _j(token, np.int32), _j(S, np.int32),
                                   _jtree(np_cache))
    params = api.params_from_jax(weights[layers], "cpu")
    cache = api.cache_from_jax(np_cache, "cpu")
    got, nxt = api.decode_step(params, _port_cfg(layers),
                               torch.from_numpy(token), S, cache)
    assert _rel(got, want) < LOGIT_TOL
    for g, w, c in zip(api.cache_to_numpy(nxt), wnext, np_cache):
        for key in ("k", "v"):
            _close_ulp(g["s0"][key][:, :, S],
                       np.asarray(w["s0"][key])[:, :, S])
            np.testing.assert_array_equal(g["s0"][key][:, :, :S],
                                          _np(c["s0"][key])[:, :, :S])


def test_padded_vocab_columns_are_never_chosen(monkeypatch):
    """vocab 500 pads to 512: the 12 padded logits are -1e30 in bf16 in
    both packages, and argmax never lands on one."""
    import jax
    from repro.models import api as japi
    jcfg = dataclasses.replace(_jax_cfg(1), vocab=500)
    cfg = dataclasses.replace(_port_cfg(1), vocab=500)
    assert jcfg.vocab_padded == cfg.vocab_padded == 512
    np_params = jax.tree.map(np.asarray,
                             japi.init_params(jax.random.key(1), jcfg))
    tokens = np.random.RandomState(10).randint(0, 500, (B, S))
    monkeypatch.delenv("REPRO_FLASH_ATTN", raising=False)
    want, _ = japi.prefill(_jtree(np_params), jcfg,
                           {"tokens": _j(tokens, np.int32)})
    got, _ = api.prefill(api.params_from_jax(np_params, "cpu"), cfg,
                         {"tokens": torch.from_numpy(tokens)})
    neg = np.float32(torch.tensor(-1e30, dtype=torch.bfloat16).float())
    assert (_np(got)[:, 500:] == neg).all()
    assert (_np(want)[:, 500:] == neg).all()
    assert int(got.argmax(-1).max()) < 500


def test_cache_specs_match_reference():
    from repro.models import api as japi
    want = japi.cache_specs(_jax_cfg(2), B, 40)
    got = api.cache_specs(_port_cfg(2), B, 40)
    for g, w in zip(got, want):
        for key in ("k", "v"):
            assert tuple(g["s0"][key].shape) == w["s0"][key].shape
            assert g["s0"][key].dtype == torch.bfloat16
