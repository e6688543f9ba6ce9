"""The port's ``local`` attention kind and block against the JAX package:
sliding-window prefill (``attn_local``), the ring cache (``_ring_pack``
and the windowed ``decode_attn``), the block, and the reduced gemma3-27b
(8 layers: five local, one global, two local; window 32, 4 heads, 2 KV
heads, head_dim 32, d_model 64) through prefill on both lanes, decode and
``train_loss``.

Both packages compute from the same weights: the reference's
``init_params`` with seeded norm scales, carried across by
``params_from_jax``. Inputs are seeded numpy. The reference's flash lane
runs ``flash_attention_chunked_ref`` on the CPU (``REPRO_FLASH_ATTN=1``).

Tolerances. Modules within 1 bf16 ULP of the tensor's largest magnitude
and blocks within 2, as in tests/test_torch_model.py. The whole model is
deeper than that file's (8 and 5 layers here, 2 there), and bf16 rounding
in other summation orders drifts through the residual stream by about
0.3 ULP a layer (0 at layer 1's K, 2.7 at layer 8's, measured layer by
layer): its logits and cache are held by ``max|d| / max|ref|`` below
``DEEP_TOL`` = 4 ULP (3.1e-2), where ``LOGIT_TOL`` (2.56 ULP) was set at
2 layers; the largest measured over three weight draws, both lanes,
prefill and four decode steps, was 3.02 ULP (gemma3's cache) and 2.46
(recurrentgemma's logits). The loss is held within ``LOSS_RTOL`` = 1e-3,
where tests/test_torch_train.py holds the 1-layer qwen2.5-3b to 2e-4: the
difference changes sign from draw to draw and reached 3.0e-4 over twelve
draws of each model.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.launch import serve as tserve
from repro_torch.models import api, attention, blocks
from test_torch_model import (ULP, _bf16, _close_ulp, _j, _jtree, _np, _rel,
                              _t)

ARCH = "gemma3-27b"
W = 32                         # the reduced config's window
B = 2
DEEP_TOL = 4 * ULP             # the 5- and 8-layer models: max|d| / max|ref|
LOSS_RTOL = 1e-3


def _cfgs():
    from repro.configs.base import get_arch as jget
    from repro_torch.configs.base import get_arch
    return jget(ARCH).reduced(), get_arch(ARCH).reduced()


def _np_params(seed=0):
    """The reference's random init of the reduced config as numpy, with
    seeded norm scales (zero, the identity, at init)."""
    import jax
    from repro.models import api as japi
    jcfg, _ = _cfgs()
    params = jax.tree.map(np.asarray,
                          japi.init_params(jax.random.key(seed), jcfg))
    rng = np.random.RandomState(seed + 100)
    for g in params["groups"]:
        for slot in g.values():
            for name in ("n1", "n2"):
                slot[name] = (rng.randn(*slot[name].shape)
                              * 0.2).astype(np.float32)
    params["final_norm"] = (rng.randn(*params["final_norm"].shape)
                            * 0.2).astype(np.float32)
    return params


@pytest.fixture(scope="module")
def weights():
    return _np_params()


def _local_layer(np_params):
    """Layer 0 of the first local slot: numpy dict, and the port's."""
    import jax
    lp = jax.tree.map(lambda a: a[0], np_params["groups"][0]["s0"])
    tp = api._layer(api.params_from_jax(np_params, "cpu")["groups"][0]["s0"],
                    0)
    return lp, tp


def _flash_env(monkeypatch, flash):
    if flash:
        monkeypatch.setenv("REPRO_FLASH_ATTN", "1")
    else:
        monkeypatch.delenv("REPRO_FLASH_ATTN", raising=False)


# -- attention ----------------------------------------------------------------

@pytest.mark.parametrize("s", [16, W, 2 * W, 2 * W + 13])
def test_attn_local_matches_reference(s):
    """S < W (the full causal fallback), S = W, S = 2W and a ragged S
    (padded to 3W and cut)."""
    from repro.models import attention as jattn
    rng = np.random.RandomState(s)
    q, k, v = (_bf16(rng, B, s, h, 32) for h in (4, 2, 2))
    want = jattn.attn_local(_j(q), _j(k), _j(v), 2, W)
    got = attention.attn_local(_t(q), _t(k), _t(v), 2, W)
    _close_ulp(got, want)
    if s > W:        # the band: position 2W-1 does not see position W-1
        k2 = k.copy()
        k2[:, W - 1] += 3.0
        got2 = attention.attn_local(_t(q), _t(k2), _t(v), 2, W)
        assert torch.equal(got2[:, 2 * W - 1], got[:, 2 * W - 1])
        assert not torch.equal(got2[:, 2 * W - 2], got[:, 2 * W - 2])


@pytest.mark.parametrize("s", [20, 2 * W, 2 * W + 13])
def test_ring_pack_matches_reference_bitwise(s):
    """S <= W pads, S % W == 0 keeps the last W, else slots
    (S-W..S-1) % W."""
    from repro.models import blocks as jblocks
    k = _bf16(np.random.RandomState(s), B, s, 2, 32)
    want = np.asarray(jblocks._ring_pack(_j(k), W), np.float32)
    got = blocks._ring_pack(_t(k), W)
    assert got.shape == (B, W, 2, 32) and got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got), want)


def test_windowed_decode_across_the_ring_wrap(weights):
    """The reference's ring of a 30-token prefill, then decode at
    positions W-2 .. W+3 (slots 30, 31, 0, 1, 2, 3): each step from the
    reference's cache, the output within 1 ULP, the new slot within 1 ULP
    and every other slot untouched; the port writes the ring in place."""
    from repro.models import attention as jattn
    from repro.models import blocks as jblocks
    lp, tp = _local_layer(weights)
    rng = np.random.RandomState(5)
    kc = np.asarray(jblocks._ring_pack(_j(_bf16(rng, B, W - 2, 2, 32)), W),
                    np.float32)
    vc = np.asarray(jblocks._ring_pack(_j(_bf16(rng, B, W - 2, 2, 32)), W),
                    np.float32)
    for pos in range(W - 2, W + 4):
        x1 = _bf16(rng, B, 1, 64)
        want, wk, wv = jattn.decode_attn(
            _jtree(lp["attn"]), _j(x1), _j(kc), _j(vc), _j(pos, np.int32),
            n_kv=2, theta=1e4, layout=jattn.KVLayout(W), window=W)
        tk, tv = _t(kc), _t(vc)
        got, gk, gv = attention.decode_attn(
            tp["attn"], _t(x1), tk, tv, pos, n_kv=2, theta=1e4,
            layout=attention.KVLayout(W), window=W)
        assert gk is tk and gv is tv
        _close_ulp(got, want)
        slot = pos % W
        for g, w, old in ((gk, wk, kc), (gv, wv, vc)):
            _close_ulp(g[:, slot], w[:, slot])
            keep = [j for j in range(W) if j != slot]
            np.testing.assert_array_equal(_np(g)[:, keep], old[:, keep])
        kc, vc = np.asarray(wk, np.float32), np.asarray(wv, np.float32)


def test_ring_cache_of_another_length_raises(weights):
    _, tp = _local_layer(weights)
    kc = torch.zeros(B, W - 4, 2, 32, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="ring cache"):
        attention.decode_attn(tp["attn"], torch.zeros(B, 1, 64,
                                                      dtype=torch.bfloat16),
                              kc, kc.clone(), 3, n_kv=2, theta=1e4,
                              layout=attention.KVLayout(W - 4), window=W)


# -- the local block ----------------------------------------------------------

@pytest.mark.parametrize("flash", [False, True])
def test_local_block_matches_reference(weights, flash, monkeypatch):
    """block_train and block_prefill at a ragged S > W on both lanes
    (the flash lane takes the kernel's plain version, once), then
    block_decode at pos S from the reference's ring."""
    from repro.models import blocks as jblocks
    _flash_env(monkeypatch, flash)
    jcfg, cfg = _cfgs()
    lp, tp = _local_layer(weights)
    s = 2 * W + 13
    x = _bf16(np.random.RandomState(6), B, s, 64)
    jctx = jblocks.Ctx(cfg=jcfg, positions=_j(np.arange(s), np.int32))
    ctx = blocks.Ctx(cfg=cfg, positions=torch.arange(s), flash=flash)
    want, wc = jblocks.block_prefill(_jtree(lp), "local", _j(x), jctx)
    jtrain, _ = jblocks.block_train(_jtree(lp), "local", _j(x), jctx)
    ops.reset_counts()
    got, gc = blocks.block_prefill(tp, "local", _t(x), ctx)
    assert ops.plain_counts()["flash_attention"] == int(flash)
    ttrain, aux = blocks.block_train(tp, "local", _t(x), ctx)
    assert torch.equal(ttrain, got) and float(aux) == 0.0
    assert _rel(got, want) < 2 * ULP and _rel(ttrain, jtrain) < 2 * ULP
    for key in ("k", "v"):
        assert gc[key].shape == (B, W, 2, 32)
        _close_ulp(gc[key], wc[key])
    x1 = _bf16(np.random.RandomState(7), B, 1, 64)
    jcache = {key: _j(np.asarray(wc[key], np.float32)) for key in wc}
    tcache = {key: _t(np.asarray(wc[key], np.float32)) for key in wc}
    want1, wc1 = jblocks.block_decode(_jtree(lp), "local", _j(x1), jcache,
                                      _j(s, np.int32), jblocks.Ctx(cfg=jcfg))
    got1, gc1 = blocks.block_decode(tp, "local", _t(x1), tcache, s,
                                    blocks.Ctx(cfg=cfg))
    assert gc1["k"] is tcache["k"]
    assert _rel(got1, want1) < 2 * ULP
    for key in ("k", "v"):
        _close_ulp(gc1[key], wc1[key])


def test_local_flash_needs_s_above_the_window(weights):
    """The reference's routing: at S <= W the flash lane runs attn_local,
    not the kernel."""
    _, cfg = _cfgs()
    _, tp = _local_layer(weights)
    x = _t(_bf16(np.random.RandomState(8), B, W, 64))
    ops.reset_counts()
    blocks.block_prefill(tp, "local", x, blocks.Ctx(
        cfg=cfg, positions=torch.arange(W), flash=True))
    assert ops.plain_counts()["flash_attention"] == 0


# -- the reduced gemma3-27b ---------------------------------------------------

S = 2 * W                      # the prompt: longer than the window


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
    tokens = np.random.RandomState(9).randint(0, 512, (B, S))
    want, wcache = _jax_prefill(weights, tokens, flash, monkeypatch)
    _, cfg = _cfgs()
    ops.reset_counts()
    got, cache = api.prefill(api.params_from_jax(weights, "cpu"), cfg,
                             {"tokens": torch.from_numpy(tokens)},
                             flash=flash)
    assert ops.plain_counts()["flash_attention"] == (8 if flash else 0)
    assert got.shape == (B, 512)
    assert _rel(got, want) < DEEP_TOL
    g, w = _leaves(api.cache_to_numpy(cache)), _leaves(wcache)
    assert g.keys() == w.keys()
    for key in w:
        assert g[key].shape == np.asarray(w[key]).shape, key
        assert _rel(g[key], w[key]) < DEEP_TOL, key


def test_decode_steps_from_reference_cache(weights, monkeypatch):
    """The reference's prefill cache grown to S + 4 positions by the
    reference's rule (pad what differs from cache_specs), carried across;
    four decode steps in each package, the second and later from each
    package's own cache."""
    import jax
    from repro.models import api as japi
    jcfg, cfg = _cfgs()
    tokens = np.random.RandomState(10).randint(0, 512, (B, S))
    _, wcache = _jax_prefill(weights, tokens, False, monkeypatch)
    specs = japi.cache_specs(jcfg, B, S + 4)
    np_cache = jax.tree.map(
        lambda a, like: np.pad(np.asarray(a), [(0, l - n) for n, l in
                                               zip(a.shape, like.shape)]),
        wcache, specs)
    jp, params = _jtree(weights), api.params_from_jax(weights, "cpu")
    jc, tc = _jtree(np_cache), api.cache_from_jax(np_cache, "cpu")
    for i, token in enumerate(([3, 411], [7, 7], [500, 1], [2, 260])):
        tok = np.array(token)
        want, jc = japi.decode_step(jp, jcfg, _j(tok, np.int32),
                                    _j(S + i, np.int32), jc)
        got, tc = api.decode_step(params, cfg, torch.from_numpy(tok), S + i,
                                  tc)
        assert _rel(got, want) < DEEP_TOL, i
    g, w = _leaves(api.cache_to_numpy(tc)), _leaves(jc)
    for key in w:
        assert _rel(g[key], w[key]) < DEEP_TOL, key


def test_train_loss_matches_reference(weights):
    from repro.models import api as japi
    jcfg, cfg = _cfgs()
    toks = np.random.RandomState(11).randint(0, 512, (B, S + 1))
    want, _ = japi.train_loss(_jtree(weights), jcfg,
                              {"tokens": _j(toks, np.int32)})
    got, metrics = api.train_loss(api.params_from_jax(weights, "cpu"), cfg,
                                  {"tokens": torch.from_numpy(toks)})
    assert float(metrics["aux"]) == 0.0
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)


@pytest.mark.parametrize("reduced", [True, False])
@pytest.mark.parametrize("seq", [16, 40, 4096])
def test_cache_specs_match_reference(reduced, seq):
    """Leaf for leaf, shape and dtype; a local ring is min(W, seq) long."""
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


def test_with_layers_keeps_the_first_layers_in_stack_order():
    from repro_torch.configs.base import get_arch
    full = get_arch(ARCH)
    six = tserve.with_layers(full, 6)
    assert six.pattern_groups == ((("local",) * 5 + ("global",), 1),)
    nine = tserve.with_layers(full, 9)
    assert nine.pattern_groups == ((("local",) * 5 + ("global",), 1),
                                   (("local",) * 3, 1))
    assert tserve.with_layers(full, 62) == full
    assert tserve.with_layers(full, 61).pattern_groups[-1] == (("local",), 1)
    assert tserve.with_layers(get_arch("recurrentgemma-9b"), 3) \
        .pattern_groups == ((("rglru", "rglru", "local"), 1),)
    assert tserve.with_layers(full, 64).pattern_groups == \
        full.pattern_groups[:1] + ((("local", "local"), 2),)
    for bad in (0, -1):
        with pytest.raises(ValueError):
            tserve.with_layers(full, bad)
    assert six.n_layers == 6 and nine.n_layers == 9
