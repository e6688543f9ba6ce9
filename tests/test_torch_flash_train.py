"""The train lane of flash attention: the port's gradient of
``flash_attention`` and its train step with ``flash=True`` against the
JAX package's train path under ``REPRO_FLASH_ATTN=1``.

The reference's ``ops.flash_attention`` takes its chunked oracle
(``flash_attention_chunked_ref``) off a TPU with
``REPRO_PALLAS_INTERPRET`` unset, and JAX differentiates it: that is the
gradient its train step takes under ``REPRO_FLASH_ATTN=1``. The port's
CPU lane is the plain version and its autograd; ``FlashAttention`` (the
card's lane: kernel 11 with its lse, then the three backward kernels)
takes only card and meta tensors, and its backward kernels are held on
the CPU through each wrapper's plain version (``ref.flash_bwd``).

Tolerances, and why:

  fp32 inputs     atol 1e-5 (the same math in fp32, summed in another
                  order: measured under 2e-6);
  bf16 inputs     max|d| <= GRAD_BF16_TOL max|ref| for each of dq, dk and
                  dv, 2e-3 (measured up to 3.9e-4): both compute in fp32
                  and round each gradient once to bf16, at sums of
                  another order;
  the card        ``BWD_TOL``: max|kernel - plain| <= 1.5e-2 max|plain| for
                  each of dq, dk and dv, the plain version in fp32 on the
                  kernels' inputs (their lse and delta too). The kernels round P and dS to bf16
                  before the products that take them and round their
                  outputs to bf16; ``ref.flash_bwd(round_to=bf16)``
                  emulates that on the CPU, and at the card's check shapes
                  it lies 2.6e-3 to 4.3e-3 from the fp32 gradient
                  (``test_kernel_rounding_sets_the_card_tolerance`` holds
                  it under half of BWD_TOL). Through autograd against
                  the plain version's own autograd (fp32, no rounded O)
                  AUTOGRAD_TOL, 3e-2: the backward also takes delta =
                  sum dO * O from the forward's output rounded to bf16,
                  where autodiff carries no rounded output (at a row
                  whose softmax is one key, exactly dP = delta, so dS is
                  the rounding of O alone);
  train steps     those of ``test_torch_train.test_step_matches_reference``
                  (gnorm rtol 1e-3, 3e-3 for gemma3-27b as in
                  ``test_torch_train_families``, the masters within 2.5 lr
                  with at most 1% more than lr/100 apart), but loss rtol
                  5e-4 (TRAIN_LOSS_RTOL), not 2e-4: the two packages' bf16
                  ``train_loss`` of the reduced qwen2.5-3b and gemma3-27b
                  at 6 draws of params and tokens differ by up to 2.2e-4
                  on either lane (flash 2.0e-5 to 2.2e-4, plain 1.8e-5 to
                  2.2e-4), and this step's flash lane by 2.2e-4 for
                  qwen2.5-3b; about twice the largest.

Each reference build runs once in this module. The ``cuda`` lane (skipped
without a card; it imports no JAX) holds the three kernels against
``ref.flash_attention_bwd`` at the chip check's shapes, cut in batch and
heads, and two calls bitwise equal, as the checkpoint's recompute needs.
"""
import numpy as np
import pytest
import torch

from repro_torch import compat
from repro_torch.configs.all import ALL_ARCHS
from repro_torch.configs.base import SHAPES, ShapeConfig, get_arch
from repro_torch.core.inc_agg import IncAggConfig
from repro_torch.kernels import flash_attn as tflash
from repro_torch.kernels import ops, ref
from repro_torch.launch import steps
from repro_torch.launch.mesh import one_rank_group
from repro_torch.models import api
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.roofline import flash_model
from repro_torch.sharding import tp

# (B, H, KV, S, D, window): causal with KV = H/2 at D = 32 (the reduced
# configs' head dim); a window at D = 64; MQA (KV = 1) with a window and
# two rows; a longer S at D = 64. No S is a multiple of 512, the
# reference's query block, and each is below it: past 512 such an S fails
# in the reference's oracle (it pads q to whole blocks and then masks the
# padded queries against the unpadded keys: a broadcast error)
GRAD_CASES = ((1, 4, 2, 96, 32, None), (1, 4, 2, 80, 64, 24),
              (2, 4, 1, 64, 32, 40), (1, 2, 1, 300, 64, None))
GRAD_ATOL, GRAD_BF16_TOL = 1e-5, 2e-3
BWD_TOL, AUTOGRAD_TOL = 1.5e-2, 3e-2
# the chip check's shapes (chip_smoke.FLASH_BWD_CHECKS) cut to one row and
# at most 4 query heads, keeping each KV grouping and window
EMUL_CASES = ((1, 4, 1, 1024, 128, None), (1, 2, 1, 2048, 128, 1024),
              (1, 4, 4, 448, 64, None), (1, 2, 1, 4096, 256, 2048),
              (1, 4, 2, 256, 32, None), (1, 3, 1, 2048, 128, None))
SEQ_TRAIN, STEP, TRAIN_LOSS_RTOL = 64, 3, 5e-4


def _inputs(case, dtype, seed):
    """q, k, v, dO as numpy (B, S, heads, D) from a seed."""
    b, h, kv, s, d, _ = case
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, n, d)).astype(np.float32)
            for n in (h, kv, kv, h)]


def _as(x: np.ndarray, dtype) -> torch.Tensor:
    return torch.from_numpy(x).to(dtype)


@pytest.fixture(scope="module")
def reference_grads():
    """jax.grad of the reference's ``ops.flash_attention`` (its chunked
    oracle) for every GRAD_CASES case in fp32 and bf16, as numpy fp32."""
    import os
    if os.environ.get("REPRO_PALLAS_INTERPRET") == "1":
        pytest.fail("REPRO_PALLAS_INTERPRET=1 sends the reference to its "
                    "Pallas kernel, which has no VJP")
    import jax
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    out = {}
    for i, case in enumerate(GRAD_CASES):
        window = case[5]
        q, k, v, do = _inputs(case, None, i)
        for name, dt in (("fp32", jnp.float32), ("bf16", jnp.bfloat16)):
            def loss(q, k, v, do=jnp.asarray(do, dt)):
                o = jops.flash_attention(q, k, v, causal=True, window=window)
                return jnp.sum(o.astype(jnp.float32) * do.astype(jnp.float32))
            grads = jax.grad(loss, argnums=(0, 1, 2))(
                *(jnp.asarray(x, dt) for x in (q, k, v)))
            out[(i, name)] = [np.asarray(g.astype(jnp.float32))
                              for g in grads]
    return out


def _port_grads(case, dtype, seed, fn):
    q, k, v, do = (_as(x, dtype) for x in _inputs(case, dtype, seed))
    for t in (q, k, v):
        t.requires_grad_(True)
    o = fn(q, k, v)
    o.backward(do)
    return [t.grad.float().numpy() for t in (q, k, v)]


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("i", range(len(GRAD_CASES)))
def test_gradient_matches_reference(reference_grads, i, dtype):
    """dq, dk and dv of the port's flash attention on the CPU (the plain
    version's autograd, the lane a CPU train step takes) against jax.grad
    of the reference's, from the same numpy inputs and cotangent."""
    case = GRAD_CASES[i]
    tdt = torch.float32 if dtype == "fp32" else torch.bfloat16
    got = _port_grads(case, tdt, i, lambda q, k, v: ops.flash_attention(
        q, k, v, causal=True, window=case[5]))
    for g, w, name in zip(got, reference_grads[(i, dtype)], "qkv"):
        assert g.shape == w.shape
        if dtype == "fp32":
            np.testing.assert_allclose(g, w, rtol=0, atol=GRAD_ATOL,
                                       err_msg=f"d{name}")
        else:
            err = np.abs(g - w).max() / np.abs(w).max()
            assert err <= GRAD_BF16_TOL, (f"d{name}", err)


def test_function_takes_no_cpu_tensor():
    """``FlashAttention`` (the card's lane) refuses a CPU tensor: the CPU
    takes the plain version's autograd, and only there."""
    q, k, v, _ = (_as(x, torch.float32) for x in _inputs(GRAD_CASES[0],
                                                         None, 0))
    with pytest.raises(ValueError, match="card or meta"):
        tflash.FlashAttention.apply(q, k, v, True, None)


@pytest.mark.parametrize("i", range(len(GRAD_CASES)))
def test_plain_backward_is_the_autograd_of_the_plain_forward(i):
    """``ref.flash_attention_bwd`` (the three kernels' plain version, from
    the lse of ``ref.flash_attention_lse``) against the autograd of
    ``ref.flash_attention``, fp32, (B, H, S, D) layout; the lse is the
    row's log2-sum-exp2."""
    case = GRAD_CASES[i]
    window = case[5]
    q, k, v, do = (_as(x, torch.float32).transpose(1, 2)
                   for x in _inputs(case, None, i))
    qa, ka, va = (t.clone().requires_grad_(True) for t in (q, k, v))
    o = ref.flash_attention(qa, ka, va, causal=True, window=window)
    o.backward(do)
    o2, lse = ref.flash_attention_lse(q, k, v, causal=True, window=window)
    assert torch.equal(o2, o.detach())
    d = q.shape[-1]
    s = torch.einsum("bhqd,bhsd->bhqs", q, k.repeat_interleave(
        q.shape[1] // k.shape[1], 1)) * d ** -0.5
    keep = ref._flash_mask(q.shape[2], True, window, q.device)
    want_lse = torch.logsumexp(s.masked_fill(~keep, -torch.inf), -1) \
        / np.log(2)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-5)
    got = ref.flash_attention_bwd(q, k, v, o2, do, lse, causal=True,
                                  window=window)
    for g, w in zip(got, (qa.grad, ka.grad, va.grad)):
        torch.testing.assert_close(g, w, rtol=0, atol=GRAD_ATOL)


@pytest.mark.parametrize("case", EMUL_CASES)
def test_kernel_rounding_sets_the_card_tolerance(case):
    """The kernels' roundings (P and dS to bf16 before the products that
    take them, dq, dk and dv stored in bf16), emulated on the CPU, stay
    within half of BWD_TOL of the fp32 gradient on bf16 inputs: the card's
    check (``test_cuda_backward_kernels_match_plain``, chip_smoke.py's
    FLASH_BWD_TOL) holds the kernels at BWD_TOL."""
    b, h, kv, s, d, window = case
    q, k, v, do = (_as(x, torch.bfloat16).transpose(1, 2)
                   for x in _inputs(case, None, 7))
    o, lse = ref.flash_attention_lse(q, k, v, causal=True, window=window)
    want = ref.flash_attention_bwd(q.float(), k.float(), v.float(),
                                   o.float(), do.float(), lse, True, window)
    got = ref.flash_attention_bwd(q, k, v, o, do, lse, True, window,
                                  round_to=torch.bfloat16)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        err = float((g.float() - w).abs().max() / w.abs().max())
        assert err <= BWD_TOL / 2, (case, err)


def test_wrappers_keep_the_kernels_layout_and_counts():
    """On the CPU the three backward wrappers take their plain versions
    (and count them), in the (B, S, heads, D) layout, and an expanded dO
    (what autograd hands over for a sum) is read as it is."""
    case = (1, 4, 2, 40, 32, 16)
    q, k, v, _ = (_as(x, torch.float32) for x in _inputs(case, None, 3))
    do = torch.ones(()).expand(q.shape)
    o, lse = ref.flash_attention_lse(*tflash._bhsd(q, k, v), True, 16)
    o = o.transpose(1, 2)
    before = {n: getattr(tflash, n).plain_calls
              for n in ("flash_bwd_delta", "flash_bwd_dkdv", "flash_bwd_dq")}
    delta = tflash.flash_bwd_delta(o, do)
    assert delta.shape == (1, 4, 40) and delta.dtype == torch.float32
    dk, dv = tflash.flash_bwd_dkdv(q, k, v, do, lse, delta, True, 16)
    dq = tflash.flash_bwd_dq(q, k, v, do, lse, delta, True, 16)
    want = ref.flash_attention_bwd(*tflash._bhsd(q, k, v, o,
                                                 do.contiguous()),
                                   lse, True, 16)
    for g, w in zip((dq, dk, dv), want):
        assert g.shape == w.transpose(1, 2).shape
        torch.testing.assert_close(g, w.transpose(1, 2), rtol=0, atol=1e-6)
    assert {n: getattr(tflash, n).plain_calls - c
            for n, c in before.items()} == dict.fromkeys(before, 1)
    with pytest.raises(TypeError, match="fp32"):
        tflash.flash_bwd_dq(q, k, v, do, lse.double(), delta)


# -- the backward kernels' grids -----------------------------------------------

ATTN_ARCHS = tuple(a for a in ALL_ARCHS if get_arch(a).n_heads)
MODEL_AXES = (1, 2, 4)
TILE, MAX_BLOCKS = 64, 2 ** 31 - 1   # rows a tile; a 1-D grid's limit


def _chunks(d: int) -> int:
    """Column chunks of dK/dV or dQ: one of min(D, 128) columns each."""
    return d // min(d, 128)


def _dkdv_grid(b, h, kv, s, d) -> int:
    """CTAs of kernel (b): key tiles x batch x column chunks x KV heads x
    the cluster (``launch_dkdv``)."""
    return -(-s // TILE) * b * _chunks(d) * kv * flash_model.dkdv_split(
        h, kv)[0]


def _dq_grid(b, h, s, d) -> int:
    """CTAs of kernel (c): query tiles x batch x column chunks x query
    heads (``launch_dq``)."""
    return -(-s // TILE) * b * _chunks(d) * h


def _dkdv_blocks(b, h, kv, s, d) -> list[tuple]:
    """A model of kernel (b)'s CTAs in ``blockIdx.x`` order, written from
    the decoding in ``flash_k_bwd_dkdv``: (key tile, batch, column chunk,
    KV head, cluster rank, its query heads in walk order). ``blockIdx.x =
    ((tile * B * chunks + batch * chunks + chunk) * KV + kv head) * cluster
    + rank``. A change to the C++ decoding does not change this copy: the
    kernel itself is held by the ``cuda`` cases against the plain
    version."""
    cluster, per = flash_model.dkdv_split(h, kv)
    group, nch = h // kv, _chunks(d)
    out = []
    for x in range(_dkdv_grid(b, h, kv, s, d)):
        rank, rest = x % cluster, x // cluster
        kvh, rest = rest % kv, rest // kv
        bz, tile = rest % (b * nch), rest // (b * nch)
        h0 = kvh * group + rank * per
        out.append((tile, bz // nch, bz % nch, kvh, rank,
                    tuple(range(h0, h0 + per))))
    return out


def _dq_blocks(b, h, s, d) -> list[tuple]:
    """A model of kernel (c)'s CTAs in ``blockIdx.x`` order, written from
    the decoding in ``flash_k_bwd_dq``: (query tile, batch, column chunk,
    query head);
    ``blockIdx.x = (reversed tile * B * chunks + batch * chunks + chunk) *
    H + head``."""
    nch, nqt = _chunks(d), -(-s // TILE)
    out = []
    for x in range(_dq_grid(b, h, s, d)):
        head, rest = x % h, x // h
        bz, rev = rest % (b * nch), rest // (b * nch)
        out.append((nqt - 1 - rev, bz // nch, bz % nch, head))
    return out


def _rank_heads(cfg, n_model: int):
    """(query heads, KV heads) a rank of a model axis of ``n_model`` runs
    the attention with (``flash_model.flash_traffic_bytes``' count), or
    None where tensor parallelism refuses the cut."""
    h = cfg.n_heads if cfg.n_heads % n_model else cfg.n_heads // n_model
    try:
        kv = tp.kv_heads(cfg.n_heads, cfg.n_kv_heads, n_model, 0)[1]
    except NotImplementedError:
        return None
    return h, kv


@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_dkdv_split_covers_every_head_and_tile_once(arch):
    """For each config with attention, at one rank and at a rank of a
    model axis of 2 and 4: dK/dV's cluster is at most 8 and divides the
    group, both backward grids fit a one-dimensional launch at the
    catalog's longest train and prefill shapes, and, in the model of the
    grids (``_dkdv_blocks``, ``_dq_blocks``), the CTAs of dK/dV (and of
    dQ) cover every (batch, column chunk, key tile, query head) exactly
    once, each cluster as consecutive CTAs of ranks 0..c-1, each CTA's
    heads ascending, the longest causal walks first. The model is Python:
    the kernels' own decoding is held by the ``cuda`` cases (a group of 3
    among them) against the plain version."""
    cfg = get_arch(arch)
    seen = 0
    for n_model in MODEL_AXES:
        heads = _rank_heads(cfg, n_model)
        if heads is None:
            continue
        h, kv = heads
        seen += 1
        group = h // kv
        cluster, per = flash_model.dkdv_split(h, kv)
        assert cluster <= flash_model.MAX_CLUSTER and group % cluster == 0
        assert cluster * per == group, (arch, n_model, cluster, per)
        assert cluster == max(c for c in range(1, 9) if group % c == 0)
        for shape in ("train_4k", "prefill_32k"):
            sh = SHAPES[shape]
            assert _dkdv_grid(sh.global_batch, h, kv, sh.seq_len,
                              cfg.hd) <= MAX_BLOCKS
            assert _dq_grid(sh.global_batch, h, sh.seq_len,
                            cfg.hd) <= MAX_BLOCKS
        b, s = 2, 3 * TILE + 5
        blocks = _dkdv_blocks(b, h, kv, s, cfg.hd)
        pairs = [(bb, ch, kt, hh) for kt, bb, ch, _, _, hs in blocks
                 for hh in hs]
        nch = _chunks(cfg.hd)
        assert sorted(pairs) == [(bb, ch, kt, hh) for bb in range(b)
                                 for ch in range(nch) for kt in range(4)
                                 for hh in range(h)]
        for x in range(0, len(blocks), cluster):
            members = blocks[x:x + cluster]
            assert {m[:4] for m in members} == {members[0][:4]}
            assert [m[4] for m in members] == list(range(cluster))
            kvh = members[0][3]
            for m in members:
                assert list(m[5]) == sorted(m[5])
                assert all(hh // group == kvh for hh in m[5])
        assert [m[0] for m in blocks] == sorted(m[0] for m in blocks)
        dq = _dq_blocks(b, h, s, cfg.hd)
        assert sorted((bb, ch, qt, hh) for qt, bb, ch, hh in dq) == [
            (bb, ch, qt, hh) for bb in range(b) for ch in range(nch)
            for qt in range(4) for hh in range(h)]
        assert [m[0] for m in dq] == sorted((m[0] for m in dq),
                                            reverse=True)
    assert seen >= 2, (arch, seen)


# -- the train step --------------------------------------------------------------

@pytest.fixture(scope="module")
def mesh():
    with one_rank_group(torch.device("cpu")):
        yield compat.make_mesh((1, 1), ("data", "model"), device="cpu")


@pytest.fixture(scope="module")
def flash_env():
    """The reference's train path under REPRO_FLASH_ATTN=1 (and off its
    Pallas interpreter), for this module's reference builds only."""
    mp = pytest.MonkeyPatch()
    mp.setenv("REPRO_FLASH_ATTN", "1")
    mp.delenv("REPRO_PALLAS_INTERPRET", raising=False)
    yield
    mp.undo()


TRAIN_ARCHS = {"qwen2.5-3b": 1e-3, "gemma3-27b": 3e-3}   # gnorm rtol


@pytest.mark.parametrize("arch", sorted(TRAIN_ARCHS))
def test_flash_train_step_matches_reference(mesh, flash_env, arch):
    """One netrpc step of the reduced config with ``flash=True`` from the
    reference's params, optimizer state and batch against the reference's
    step under REPRO_FLASH_ATTN=1 (gemma3-27b: S = 64 past its window of
    32, so its local layers take the kernel too). Every layer calls the
    flash attention twice a microbatch: the forward and the checkpoint's
    recompute."""
    from test_torch_train import BATCH, N_MICRO, PRECISION, _jnp, _np, \
        _reference
    from test_torch_train_families import _masters_close, _reference_gates
    (np_p, np_o), batch, (_, jo, jm) = _reference(
        "netrpc", STEP, arch, prepare=_reference_gates(arch))
    cfg = get_arch(arch).reduced()
    assert SEQ_TRAIN > cfg.window
    prog = steps.build_train_step(
        cfg, ShapeConfig("t", seq_len=SEQ_TRAIN, global_batch=BATCH,
                         kind="train"), mesh,
        inc=IncAggConfig(mode="netrpc", precision=PRECISION),
        opt_cfg=AdamWConfig(warmup_steps=2, total_steps=100),
        n_micro=N_MICRO, flash=True, device="cpu")
    assert prog.meta["flash"] is True
    params = api.params_from_jax(np_p, "cpu")
    opt = api.opt_from_jax(np_o, "cpu")
    tokens = batch if isinstance(batch, np.ndarray) else batch["tokens"]
    before = ops.plain_counts()["flash_attention"]
    params, opt, m = prog.fn(params, opt, {"tokens": torch.from_numpy(
        np.asarray(tokens))}, STEP)
    assert ops.plain_counts()["flash_attention"] - before \
        == 2 * cfg.n_layers * N_MICRO
    assert np.float32(m["lr"]).view(np.int32) == \
        np.float32(jm["lr"]).view(np.int32)
    np.testing.assert_allclose(float(m["loss"]), jm["loss"],
                               rtol=TRAIN_LOSS_RTOL)
    np.testing.assert_allclose(float(m["gnorm"]), jm["gnorm"],
                               rtol=TRAIN_ARCHS[arch])
    _masters_close(_np(opt["master"]), _jnp(jo["master"]), jm["lr"], 0.01)


# -- phase z's windows ---------------------------------------------------------

# chip_smoke.py's phase z (qwen2.5-3b at full width, 36 layers, B=2 x
# S=1 024, seed 0, 3 netrpc steps, ``flash=True``) holds its step-0 gnorm
# within Z_GNORM_RTOL (relative) of phase j's (the plain attention, the
# same state and tokens) and the Adam first moment m of every attention
# leaf after the run within Z_M_RTOL (||z - j|| / ||j||) of j's. Here the
# same runs at the reduced width, j's depth, batch and seed, S cut to 256,
# the flash lane's backward being the kernels' emulation
# (``ref.flash_attention_bwd(round_to=bf16)``, delta from the bf16
# output): it must lie inside both windows with room (measured: gnorm
# 6.1e-4, m 4.5e-2), and each fault of the backward outside both
# (measured: gnorm 1.6e-2 to 0.34, m 1.0 to 1.9)
Z_GNORM_RTOL, Z_M_RTOL = 3e-3, 0.2
Z_LAYERS, Z_SEQ, Z_STEPS = 36, 256, 3
Z_FAULTS = ("zero_dk", "negate_dk", "zero_dq", "zero_dv")


class _EmulatedKernels(torch.autograd.Function):
    """The plain forward and the kernels' emulated backward ((B, H, S, D)
    layout), with one fault of the backward injected by name."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, fault):
        o, lse = ref.flash_attention_lse(q, k, v, causal, window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = causal, window, fault
        return o

    @staticmethod
    def backward(ctx, do):
        causal, window, fault = ctx.args
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = ref.flash_attention_bwd(q, k, v, o, do, lse, causal,
                                             window, round_to=torch.bfloat16)
        dq, dk, dv = {"zero_dk": (dq, 0 * dk, dv),
                      "negate_dk": (dq, -dk, dv),
                      "zero_dq": (0 * dq, dk, dv),
                      "zero_dv": (dq, dk, 0 * dv)}.get(fault, (dq, dk, dv))
        return dq, dk, dv, None, None, None


def _z_run(monkeypatch, lane: str) -> dict:
    """The reduced phase z (or, for lane "plain", j): step-0 gnorm and the
    attention leaves' m after Z_STEPS steps."""
    from repro_torch.launch.train import train_loop

    def emulated(q, k, v, causal=True, window=None):
        o = _EmulatedKernels.apply(*tflash._bhsd(q, k, v), causal, window,
                                   lane)
        return o.transpose(1, 2).contiguous()
    with monkeypatch.context() as mp:
        if lane != "plain":
            mp.setattr(tflash, "flash_attention_plain", emulated)
        run = train_loop(arch="qwen2.5-3b", inc_mode="netrpc",
                         steps_n=Z_STEPS, seq=Z_SEQ, batch=2, reduced=True,
                         precision=8, data_kind="uniform", log_every=Z_STEPS,
                         device="cpu", layers=Z_LAYERS, mode="zero1",
                         flash=lane != "plain")
    return {"gnorm": run["gnorms"][0], "m": {
        n: t.detach().float() for n, t in api.named_leaves(run["opt"]["m"])
        if ".attn." in n}}


@pytest.fixture(scope="module")
def z_plain():
    with pytest.MonkeyPatch.context() as mp:
        return _z_run(mp, "plain")


def _z_gaps(run: dict, plain: dict) -> tuple[float, float]:
    """(step-0 gnorm relative gap, largest attention leaf's relative m
    gap), as phase z reads them."""
    m = max(float((run["m"][n] - w).norm() / w.norm())
            for n, w in plain["m"].items())
    return abs(run["gnorm"] / plain["gnorm"] - 1), m


@pytest.mark.parametrize("lane", ("kernels",) + Z_FAULTS)
def test_phase_z_windows_hold_the_kernels_and_fail_a_fault(monkeypatch,
                                                           z_plain, lane):
    """The emulated kernels inside half of each of phase z's windows; a
    zeroed or negated dK, a zeroed dQ and a zeroed dV outside both."""
    gnorm, m = _z_gaps(_z_run(monkeypatch, lane), z_plain)
    if lane == "kernels":
        assert gnorm <= Z_GNORM_RTOL / 2 and m <= Z_M_RTOL / 2, (gnorm, m)
    else:
        assert gnorm > Z_GNORM_RTOL and m > Z_M_RTOL, (lane, gnorm, m)


# -- on the card ---------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


# chip_smoke.FLASH_BWD_CHECKS cut to at most 2 rows and 16 query heads; a
# group of 3 (phi4-mini-3.8b's, a cluster of 3 in dK/dV) at its KV heads
# cut to 4
CUDA_BWD_CASES = ((2, 16, 2, 1024, 128, None), (1, 16, 8, 2048, 128, 1024),
                  (2, 16, 16, 448, 64, None), (1, 8, 1, 4096, 256, 2048),
                  (2, 8, 2, 1000, 32, None), (1, 4, 2, 200, 64, 70),
                  (1, 12, 4, 1024, 128, None))


def _card_inputs(case, dev):
    q, k, v, do = (_as(x, torch.bfloat16).to(dev)
                   for x in _inputs(case, None, 11))
    o, lse = tflash._forward(q, k, v, True, case[5], True)
    return q, k, v, do, o, lse


@pytest.mark.cuda
@pytest.mark.parametrize("case", CUDA_BWD_CASES)
def test_cuda_backward_kernels_match_plain(cuda, case):
    """Kernel 11's lse and kernels (a)-(c) against their plain versions on
    the card (fp32 math on the kernels' bf16 inputs and lse), within
    BWD_TOL of max|plain|; a second call of each is bitwise equal."""
    window = case[5]
    q, k, v, do, o, lse = _card_inputs(case, cuda)
    _, want_lse = ref.flash_attention_lse(*tflash._bhsd(q, k, v), True,
                                          window)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-3)
    delta = tflash.flash_bwd_delta(o, do)
    want_delta = (do.float() * o.float()).sum(-1).transpose(1, 2)
    torch.testing.assert_close(delta, want_delta, rtol=1e-5, atol=1e-4)
    dk, dv = tflash.flash_bwd_dkdv(q, k, v, do, lse, delta, True, window)
    dq = tflash.flash_bwd_dq(q, k, v, do, lse, delta, True, window)
    want = ref.flash_bwd(*tflash._bhsd(q.float(), k.float(), v.float(),
                                       do.float()), lse, delta, True, window)
    for name, g, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        w = w.transpose(1, 2)
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        err = float((g.float() - w).abs().max() / w.abs().max())
        assert err <= BWD_TOL, (name, case, err)
    again = (tflash.flash_bwd_delta(o, do),
             *tflash.flash_bwd_dkdv(q, k, v, do, lse, delta, True, window),
             tflash.flash_bwd_dq(q, k, v, do, lse, delta, True, window))
    for a, b in zip((delta, dk, dv, dq), again):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_autograd_launches_the_kernels(cuda):
    """A card tensor under grad goes through ``FlashAttention``: one
    forward launch with the lse and one of each backward kernel; the
    gradients within AUTOGRAD_TOL of the plain version's autograd."""
    case = (2, 8, 2, 300, 128, 100)
    q, k, v, do = (_as(x, torch.bfloat16).to(cuda)
                   for x in _inputs(case, None, 5))
    for t in (q, k, v):
        t.requires_grad_(True)
    for name in ops.KERNELS:
        ops.KERNELS[name].launches = 0
    ops.flash_attention(q, k, v, causal=True, window=100).backward(do)
    got = [t.grad for t in (q, k, v)]
    counts = ops.launch_counts()
    assert {n: counts[n] for n in ("flash_attention", "flash_bwd_delta",
                                   "flash_bwd_dkdv", "flash_bwd_dq")} \
        == dict.fromkeys(("flash_attention", "flash_bwd_delta",
                          "flash_bwd_dkdv", "flash_bwd_dq"), 1)
    qf, kf, vf = (t.detach().float().requires_grad_(True) for t in (q, k, v))
    tflash.flash_attention_plain(qf, kf, vf, True, 100).backward(do.float())
    for g, t in zip(got, (qf, kf, vf)):
        err = float((g.float() - t.grad).abs().max() / t.grad.abs().max())
        assert err <= AUTOGRAD_TOL, err
