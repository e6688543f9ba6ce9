"""One netrpc train step (``launch/steps.py:build_train_step``, one rank,
in the arch's own mode: fsdp for llama-3.2-vision-90b, zero1 for the
rest) of every family's reduced config beside qwen2.5-3b's against the
JAX package, from the reference's params, optimizer state and batch
(``test_torch_train._reference``: 4 x 64 bigram tokens in 2
microbatches, with whisper-medium's stub frames or llama's patches):
mamba2-780m (``ssd``), gemma3-27b (``local`` and ``global``, window 32 <
S), recurrentgemma-9b (``rglru`` and ``local``), moonshot-v1-16b-a3b
(``moe``: the sort dispatch's backward and the aux loss),
llama-3.2-vision-90b (``global`` and ``cross``, each cross layer's gate
set to 0.5 in both packages: at 0, as drawn, the layer passes no
gradient to its attention) and whisper-medium (``bidir`` encoder,
``selfcross`` decoder).

Tolerances, as ``test_torch_train.test_step_matches_reference``:

  lr        bitwise;
  loss      rtol 2e-4;
  gnorm     rtol 1e-3, but 3e-3 for gemma3-27b and mamba2-780m: over 8
            draws the norms of the two packages' bf16 gradients of
            ``train_loss`` at this config differ by up to 1.5e-3 and
            1.2e-3, gemma3's reference lies as far (1.5e-3) from its own
            fp32 norm, and with the rounding taken out (``COMPUTE_DTYPE``
            fp32 in both) every leaf agrees within 2.5e-5
            (``scripts/family_gnorm_drift.py``); twice the largest;
  master    every element within 2.5 lr of the reference's, at most 1%
            more than lr/100 apart.

moonshot's routing is taken from the reference: its ``moe_apply`` records
each call's expert ids (``jax.debug.callback``, inside the jitted step),
and the port's ``ffn.route`` hands them back, layer by layer (its router)
and microbatch by microbatch, each checkpoint's recompute the ids of its
forward: a bf16 near tie between two experts would flip one otherwise.

The ``cuda`` twins take the same reduced step on the card and on the CPU
from the same params, optimizer state and batch, held within phase j's
card-vs-CPU tolerances of ``chip_smoke.py`` (the CPU's routing forced to
the card's).
"""
import contextlib
import copy

import numpy as np
import pytest
import torch

from repro_torch import compat
from repro_torch.configs.base import ShapeConfig, get_arch
from repro_torch.core.inc_agg import IncAggConfig
from repro_torch.data import pipeline
from repro_torch.launch import steps
from repro_torch.launch.mesh import one_rank_group
from repro_torch.models import api, ffn
from repro_torch.optim.adamw import AdamWConfig
from test_torch_train import BATCH, N_MICRO, PRECISION, SEQ, _jnp, _np, \
    _reference

FAMILIES = ("mamba2-780m", "gemma3-27b", "recurrentgemma-9b",
            "moonshot-v1-16b-a3b", "llama-3.2-vision-90b", "whisper-medium")
STUBS = {"llama-3.2-vision-90b": {"patches"}, "whisper-medium": {"frames"}}
GNORM_RTOL = {"gemma3-27b": 3e-3, "mamba2-780m": 3e-3}
GATE = 0.5
STEP = 3
# phase j's card-vs-CPU tolerances (chip_smoke.py)
CARD_LOSS_RTOL, CARD_GNORM_RTOL, CARD_FLIP_FRAC, CARD_MV_RTOL = \
    1e-3, 1e-2, 0.02, 3e-2


@pytest.fixture(scope="module")
def mesh():
    with one_rank_group(torch.device("cpu")):
        yield compat.make_mesh((1, 1), ("data", "model"), device="cpu")


def _build(arch, mesh, device="cpu"):
    cfg = get_arch(arch).reduced()
    return cfg, steps.build_train_step(
        cfg, ShapeConfig("t", seq_len=SEQ, global_batch=BATCH, kind="train"),
        mesh, inc=IncAggConfig(mode="netrpc", precision=PRECISION),
        opt_cfg=AdamWConfig(warmup_steps=2, total_steps=100),
        n_micro=N_MICRO, device=device)


def _cross_slots(cfg):
    return [(gi, f"s{i}") for gi, (pat, _) in enumerate(cfg.pattern_groups)
            for i, bt in enumerate(pat) if bt == "cross"]


def _reference_gates(arch):
    """The reference's state with every cross layer's gate (param and
    fp32 master) at GATE, or None where the arch has no cross layer."""
    slots = _cross_slots(get_arch(arch).reduced())
    if not slots:
        return None

    def prepare(params, opt):
        import jax.numpy as jnp
        for tree in (params, opt["master"]):
            for gi, s in slots:
                slot = tree["groups"][gi][s]
                slot["gate"] = jnp.full_like(slot["gate"], GATE)
        return params, opt
    return prepare


@contextlib.contextmanager
def _reference_routes(routes: dict):
    """While open, the reference's ``moe_apply`` appends each call's
    expert ids (T, k), each token's ascending, to ``routes[router key]``
    (its first router row's bytes), a recompute's only where they differ
    from the last: one entry a microbatch, in order."""
    import jax
    import jax.numpy as jnp
    from repro.models import ffn as jffn
    moe_apply = jffn.moe_apply

    def record(key, ids):
        ids = np.sort(np.asarray(ids), axis=-1)
        got = routes.setdefault(np.asarray(key).tobytes(), [])
        if not got or not np.array_equal(got[-1], ids):
            got.append(ids)

    def recorded(p, x, *, top_k, capacity_factor):
        xf = x.reshape(-1, x.shape[-1]).astype(jnp.float32)
        _, ids = jax.lax.top_k(jax.nn.softmax(xf @ p["router"], axis=-1),
                               top_k)
        jax.debug.callback(record, p["router"][0], ids)
        return moe_apply(p, x, top_k=top_k, capacity_factor=capacity_factor)
    jffn.moe_apply = recorded
    try:
        yield routes
    finally:
        jffn.moe_apply = moe_apply


@contextlib.contextmanager
def _routes_from(routes: dict, overridden: list):
    """While open, the port's ``ffn.route`` returns the ids ``routes``
    holds for its router, the next microbatch's at each new input (a
    checkpoint's recompute sees its forward's input again), with its own
    probabilities and gates for them; appends to ``overridden`` the
    tokens whose own top-k differed."""
    route = ffn.route
    seen = {}

    def replay(router, xf, top_k):
        probs, _, own = route(router, xf, top_k)
        key = router[0].detach().float().numpy().tobytes()
        i, last = seen.get(key, (-1, None))
        if last is None or not torch.equal(last, xf):
            i, last = i + 1, xf.detach().clone()
        seen[key] = (i, last)
        ids = torch.from_numpy(routes[key][i]).long()
        overridden.append(int((own != ids).any(-1).sum()))
        gates = probs.gather(-1, ids)
        return probs, gates / gates.sum(-1, keepdim=True), ids
    ffn.route = replay
    try:
        yield
    finally:
        ffn.route = route
    assert {k: i + 1 for k, (i, _) in seen.items()} == \
        {k: len(v) for k, v in routes.items()}


def _masters_close(got: dict, want: dict, lr: float, frac: float) -> None:
    assert got.keys() == want.keys()
    d = np.concatenate([np.abs(got[n].astype(np.float64) - want[n]).ravel()
                        for n in want])
    assert d.max() <= 2.5 * lr, d.max() / lr
    assert (d > lr / 100).mean() <= frac


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_step_matches_reference(mesh, arch):
    """One netrpc step from the reference's state and batch: lr, loss,
    gnorm and the updated fp32 masters; moonshot's routing the
    reference's, and every microbatch of every moe layer replayed."""
    routes, overridden = {}, []
    moe = get_arch(arch).n_experts > 0
    with _reference_routes(routes) if moe else contextlib.nullcontext():
        (np_p, np_o), batch, (_, jo, jm) = _reference(
            "netrpc", STEP, arch, prepare=_reference_gates(arch))
    assert set(batch) == {"tokens"} | STUBS.get(arch, set())
    cfg, prog = _build(arch, mesh)
    params = api.params_from_jax(np_p, "cpu")
    opt = api.opt_from_jax(np_o, "cpu")
    tb = {k: api._tensor(v, torch.device("cpu")) for k, v in batch.items()}
    with _routes_from(routes, overridden) if moe \
            else contextlib.nullcontext():
        params, opt, m = prog.fn(params, opt, tb, STEP)
    if moe:
        assert len(routes) == cfg.n_layers
        assert all(len(v) == N_MICRO for v in routes.values())
    assert np.float32(m["lr"]).view(np.int32) == \
        np.float32(jm["lr"]).view(np.int32)
    np.testing.assert_allclose(float(m["loss"]), jm["loss"], rtol=2e-4)
    np.testing.assert_allclose(float(m["gnorm"]), jm["gnorm"],
                               rtol=GNORM_RTOL.get(arch, 1e-3))
    _masters_close(_np(opt["master"]), _jnp(jo["master"]), jm["lr"], 0.01)


# -- on the card ----------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


@contextlib.contextmanager
def _port_routes(calls: list, replay: bool, overridden: list):
    """While open, ``ffn.route`` appends each call's expert ids to
    ``calls`` or, with ``replay``, hands them back call by call (the CPU
    run makes the card run's calls, in order)."""
    route = ffn.route
    forced = iter(list(calls))

    def hooked(router, xf, top_k):
        probs, gates, own = route(router, xf, top_k)
        if not replay:
            calls.append(own)
            return probs, gates, own
        ids = next(forced).to(own.device)
        overridden.append(int((own != ids).any(-1).sum()))
        g = probs.gather(-1, ids)
        return probs, g / g.sum(-1, keepdim=True), ids
    ffn.route = hooked
    try:
        yield
    finally:
        ffn.route = route


def _reduce_scatters(cfg) -> int:
    """Quantize, sat_add and dequantize launches of one netrpc step at one
    rank: one a scattered leaf (zero1); in fsdp one a gather's backward,
    a stacked leaf's once a layer, each microbatch."""
    from repro_torch.sharding import rules
    shapes = dict(api.named_leaves(api.param_shapes(cfg)))
    dims = steps.scatter_dims_tree(api.param_shapes(cfg), 1, 1)
    if rules.mode_for(cfg.name) == "zero1":
        return sum(d >= 0 for d in dims.values())
    return N_MICRO * sum(shapes[n].shape[0] if rules._is_stacked(n) else 1
                         for n, d in dims.items() if d >= 0)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", FAMILIES)
def test_cuda_family_step_matches_cpu(cuda, arch):
    """The reduced step on the card (kernels 7/6/8 once a scattered leaf)
    against the same params, optimizer state and batch on the CPU:
    phase j's tolerances on loss, gnorm, the masters and m and v."""
    from repro_torch.kernels import ops
    cpu_dev = torch.device("cpu")
    with one_rank_group(cuda):
        card_mesh = compat.make_mesh((1, 1), ("data", "model"))
        cpu_mesh = compat.make_mesh((1, 1), ("data", "model"), device="cpu")
        cfg, card = _build(arch, card_mesh, cuda)
        _, cpu = _build(arch, cpu_mesh, "cpu")
        p_cpu = api.init_params(7, cfg, device=cpu_dev)
        for gi, s in _cross_slots(cfg):
            p_cpu["groups"][gi][s]["gate"].fill_(GATE)
        o_cpu = steps.init_opt(p_cpu)
        p_card = copy.deepcopy(p_cpu).to(cuda)
        o_card = {k: copy.deepcopy(v).to(cuda) for k, v in o_cpu.items()}
        batch = pipeline.add_modality_stubs(pipeline.make_batch(
            pipeline.DataConfig(vocab=cfg.vocab, batch=BATCH, seq_len=SEQ,
                                kind="uniform"), STEP), cfg, BATCH)
        calls, overridden = [], []
        ops.reset_counts()
        with _port_routes(calls, False, overridden):
            _, o_card, m_card = card.fn(p_card, o_card, batch, STEP)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        with _port_routes(calls, True, overridden):
            _, o_cpu, m_cpu = cpu.fn(p_cpu, o_cpu, batch, STEP)
    assert counts["quantize"] == counts["sat_add"] == \
        counts["dequantize"] == _reduce_scatters(cfg)
    assert counts["flash_attention"] == 0
    assert len(overridden) == (len(calls) if cfg.n_experts else 0)
    lr = float(m_cpu["lr"])
    assert float(m_card["lr"]) == lr
    np.testing.assert_allclose(float(m_card["loss"]), float(m_cpu["loss"]),
                               rtol=CARD_LOSS_RTOL)
    np.testing.assert_allclose(float(m_card["gnorm"]), float(m_cpu["gnorm"]),
                               rtol=CARD_GNORM_RTOL)
    _masters_close(_np(api.map_tree(lambda t: t.cpu(), o_card["master"])),
                   _np(o_cpu["master"]), lr, CARD_FLIP_FRAC)
    for k in ("m", "v"):
        got = _np(api.map_tree(lambda t: t.cpu(), o_card[k]))
        for name, want in _np(o_cpu[k]).items():
            assert np.linalg.norm(got[name] - want) <= \
                CARD_MV_RTOL * np.linalg.norm(want) + 1e-30, (k, name)
