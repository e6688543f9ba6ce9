"""The port's serving path (``repro_torch.launch.serve``) and its INC
telemetry against the JAX package, on the CPU.

The reference's ``serve`` draws its weights from ``jax.random.key(0)`` and
its prompt from ``pipeline.make_batch(..., 0)``; the test draws both the
same way, carries them across, and hands them to the port's ``serve``.
Random-init greedy decoding collapses onto one token, so tokens are held
equal only where the port's top-2 logit gap is wider than the logit
tolerance of tests/test_torch_model.py, up to a row's first step where it
is not (after that the two runs feed different tokens).

``serve`` runs through ``build_serve_step``'s programs: at one rank they
are ``api.prefill`` and ``api.decode_step`` bit for bit; under two gloo
ranks (spawned, each a batch row pair), teacher forced with the
one-rank run's tokens, within the logit tolerance of one rank.
"""
import dataclasses
import os
import subprocess
import sys
import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.data import pipeline
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps
from repro_torch.models import api

ROOT = Path(__file__).resolve().parents[1]
LOGIT_TOL = 2e-2               # as tests/test_torch_model.py
PROMPT, DECODE, BATCH = 32, 4, 2
# the prompt of each served arch: longer than the reduced window (32) where
# the arch has local layers, so they take the band, the ring and the kernel
PROMPTS = {"qwen2.5-3b": PROMPT, "gemma3-27b": 64, "recurrentgemma-9b": 64,
           "moonshot-v1-16b-a3b": PROMPT, "mamba2-780m": 64,
           "whisper-medium": PROMPT, "llama-3.2-vision-90b": PROMPT}


def _reference_inputs(arch="qwen2.5-3b", prompt=PROMPT):
    """The weights, prompt and modality stubs (frames or patches, none for
    a text model) the reference's serve builds for itself."""
    import jax
    from repro.configs.base import get_arch
    from repro.data import pipeline as jpipeline
    from repro.models import api as japi
    cfg = get_arch(arch).reduced()
    params = jax.jit(lambda k: japi.init_params(k, cfg))(jax.random.key(0))
    dcfg = jpipeline.DataConfig(vocab=cfg.vocab, batch=BATCH,
                                seq_len=prompt - 1, kind="uniform")
    tokens = jpipeline.make_batch(dcfg, 0)["tokens"]
    stubs = jpipeline.add_modality_stubs({}, cfg, BATCH)
    return (jax.tree.map(np.asarray, params), np.asarray(tokens),
            {k: np.asarray(v) for k, v in stubs.items()})


def _held_equal(got, want, logits):
    """Tokens equal wherever the port's top-2 gap exceeds the tolerance,
    until a row's first step where it does not."""
    scale = logits.float().abs().amax(dim=-1)            # (steps, B)
    top2 = logits.float().topk(2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > 2 * LOGIT_TOL * scale
    checked = 0
    for b in range(got.shape[0]):
        for t in range(got.shape[1]):
            if not decided[t, b]:
                break
            assert int(got[b, t]) == int(want[b, t]), (b, t)
            checked += 1
    return checked


@pytest.mark.parametrize("arch", list(PROMPTS))
@pytest.mark.parametrize("flash", [False, True])
def test_serve_matches_reference(arch, flash, monkeypatch, capsys):
    from repro.launch import serve as jserve
    if flash:
        monkeypatch.setenv("REPRO_FLASH_ATTN", "1")
    else:
        monkeypatch.delenv("REPRO_FLASH_ATTN", raising=False)
    prompt = PROMPTS[arch]
    want = jserve.serve(arch=arch, prompt_len=prompt, decode_n=DECODE,
                        batch=BATCH, reduced=True)
    np_params, tokens, stubs = _reference_inputs(arch, prompt)
    # the reference's frames or patches in place of the port's own draw
    monkeypatch.setattr(tserve.pipeline, "add_modality_stubs",
                        lambda batch, *_: {**batch, **{
                            k: api._tensor(v, torch.device("cpu"))
                            for k, v in stubs.items()}})
    got = tserve.serve(arch=arch, prompt_len=prompt, decode_n=DECODE,
                       batch=BATCH, reduced=True, flash=flash, device="cpu",
                       params=api.params_from_jax(np_params, "cpu"),
                       tokens=torch.from_numpy(tokens.copy()))
    out = capsys.readouterr().out.splitlines()
    assert out[-3].startswith(f"prefill {prompt} tokens x{BATCH}: ")
    assert out[-2].startswith(f"inc telemetry: tokens={BATCH * DECODE} ")
    assert out[-1].startswith("sampled token ids[0]: [")
    assert got["tokens"].shape == (BATCH, DECODE + 1)
    assert got["logits"].shape == (DECODE + 1, BATCH, 512)
    assert torch.isfinite(got["logits"].float()).all()
    assert _held_equal(got["tokens"], np.asarray(want["tokens"]),
                       got["logits"]) >= 1
    for inc in (got["inc_telemetry"], want["inc_telemetry"]):
        assert inc["metrics"]["decode_tokens"] == BATCH * DECODE


def test_flash_and_dense_lanes_agree_teacher_forced():
    """The two prefill lanes on one set of weights, decoding the same fed
    tokens: logits within the model tolerance at every step."""
    cfg = tserve.model_config("qwen2.5-3b", reduced=True, layers=2)
    params = api.init_params(3, cfg, device="cpu")
    kw = dict(arch="qwen2.5-3b", prompt_len=PROMPT, decode_n=DECODE,
              batch=BATCH, reduced=True, layers=2, device="cpu",
              params=params)
    a = tserve.serve(flash=True, **kw)
    b = tserve.serve(flash=False, feed=a["tokens"][:, :-1], **kw)
    for t in range(DECODE + 1):
        la, lb = a["logits"][t].float(), b["logits"][t].float()
        assert float((la - lb).abs().max() / lb.abs().max()) < LOGIT_TOL


def test_grow_cache_pads_with_zeros():
    cfg = tserve.model_config("qwen2.5-3b", reduced=True, layers=2)
    params = api.init_params(0, cfg, device="cpu")
    toks = torch.randint(0, cfg.vocab, (BATCH, 8))
    _, cache = api.prefill(params, cfg, {"tokens": toks})
    grown = tserve.grow_cache(cache, cfg, BATCH, 12)
    k = grown[0]["s0"]["k"]
    assert tuple(k.shape) == tuple(api.cache_specs(cfg, BATCH, 12)[0]["s0"]
                                   ["k"].shape)
    assert torch.equal(k[:, :, :8], cache[0]["s0"]["k"])
    assert not k[:, :, 8:].any()


@pytest.mark.parametrize("arch", ["gemma3-27b", "recurrentgemma-9b",
                                  "moonshot-v1-16b-a3b", "mamba2-780m",
                                  "whisper-medium", "llama-3.2-vision-90b"])
def test_grow_cache_matches_reference(arch):
    """The reference's rule (pad what differs from cache_specs): a local
    ring and a recurrent state and conv tail keep their shape and values
    (the same tensors), a global K/V pads with zeros; leaf for leaf equal
    to the reference's ``grow`` of the same cache."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import get_arch as jget
    from repro.models import api as japi
    cfg = tserve.model_config(arch, reduced=True)
    params = api.init_params(1, cfg, device="cpu")
    prompt, total = PROMPTS[arch], PROMPTS[arch] + DECODE
    toks = torch.randint(0, cfg.vocab, (BATCH, prompt),
                         generator=torch.Generator().manual_seed(2))
    _, cache = api.prefill(params, cfg, pipeline.add_modality_stubs(
        {"tokens": toks}, cfg, BATCH))
    grown = tserve.grow_cache(cache, cfg, BATCH, total)

    def grow(leaf, like):                   # the reference's serve
        if leaf.shape == like.shape:
            return leaf
        return jnp.pad(leaf, [(0, l - s) for s, l in zip(leaf.shape,
                                                         like.shape)])
    want = jax.tree.map(grow, jax.tree.map(jnp.asarray,
                                           api.cache_to_numpy(cache)),
                        japi.cache_specs(jget(arch).reduced(), BATCH, total))
    kinds = set()
    for g, c, w in zip(grown, cache, want):
        for slot, entry in g.items():
            for key, t in entry.items():
                np.testing.assert_array_equal(
                    api.cache_to_numpy(t), np.asarray(w[slot][key]))
                kinds.add((key, t is c[slot][key]))
    if arch == "gemma3-27b":       # local rings kept, global K/V grown
        assert kinds == {("k", True), ("v", True), ("k", False),
                         ("v", False)}
    elif arch == "recurrentgemma-9b":   # every entry kept: rings, states
        assert kinds == {("k", True), ("v", True), ("state", True),
                         ("conv", True)}
    elif arch == "moonshot-v1-16b-a3b":     # the moe layer's K/V grown
        assert kinds == {("k", False), ("v", False)}
    elif arch in ("whisper-medium", "llama-3.2-vision-90b"):
        # the self K/V grown, the memory's K/V kept
        assert kinds == {("k", False), ("v", False), ("mk", True),
                         ("mv", True)}
    else:                          # the ssd state and conv tail kept
        assert kinds == {("state", True), ("conv", True)}
    if arch in ("gemma3-27b", "recurrentgemma-9b"):
        with pytest.raises(ValueError, match="does not grow"):
            tserve.grow_cache(cache, cfg, BATCH, 16)   # a ring past W = 32


def test_make_batch_is_a_function_of_seed_and_step():
    dcfg = pipeline.DataConfig(vocab=512, batch=2, seq_len=7)
    a, b = pipeline.make_batch(dcfg, 3), pipeline.make_batch(dcfg, 3)
    assert a["tokens"].shape == (2, 8) and a["tokens"].dtype == torch.int32
    assert torch.equal(a["tokens"], b["tokens"])
    assert not torch.equal(a["tokens"], pipeline.make_batch(dcfg, 4)["tokens"])
    assert int(a["tokens"].min()) >= 0 and int(a["tokens"].max()) < 512
    big = pipeline.make_batch(dataclasses.replace(dcfg, kind="bigram"), 0)
    assert big["tokens"].shape == (2, 8)
    assert int(big["tokens"].min()) >= 0 and int(big["tokens"].max()) < 512
    assert pipeline.DataConfig(vocab=8, batch=1, seq_len=1).kind == \
        "bigram"


def test_telemetry_matches_reference():
    """Metric pushes, a read, quorum votes and a gradient round trip on
    the port's TrainTelemetry (device="cpu") and the reference's."""
    from repro.launch import steps as jsteps
    rng = np.random.RandomState(11)
    pushes = [{"loss": float(rng.rand() * 3), "tokens": 8.0}
              for _ in range(6)]
    grads = {"w": rng.randn(3, 5).astype(np.float32),
             "b": [rng.randn(7).astype(np.float32)]}
    results = []
    for mod, kw, to in ((steps, {"device": "cpu"}, torch.from_numpy),
                        (jsteps, {}, np.asarray)):
        tel = mod.TrainTelemetry(n_workers=2, app_prefix="t", grad_slots=22,
                                 **kw)
        for p in pushes:
            tel.push(p)
        for step in range(3):
            tel.vote(step)
            tel.vote(step)
        agg = tel.aggregate_gradients({"w": to(grads["w"]),
                                       "b": [to(grads["b"][0])]})
        summary = tel.finish()
        results.append((summary["metrics"], summary["commits"],
                        np.asarray(agg["w"]), np.asarray(agg["b"][0])))
    (gm, gc, gw, gb), (wm, wc, ww, wb) = results
    assert gm == wm and gc == wc == 3
    np.testing.assert_array_equal(gw, ww)
    np.testing.assert_array_equal(gb, wb)


def test_serve_cli_runs_on_the_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "qwen2.5-3b", "--reduced", "--device", "cpu", "--prompt-len", "16",
         "--decode", "2", "--batch", "2"], cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        capture_output=True, text=True, timeout=120, check=True)
    lines = out.stdout.strip().splitlines()
    assert lines[-2].startswith("inc telemetry: tokens=4 ")
    assert lines[-1].startswith("sampled token ids[0]: [")


# -- the serve step (build_serve_step) ----------------------------------------

def _set_gates(params, cfg, gate=0.5) -> None:
    """Every cross layer's gate set to ``gate`` (it starts at 0, where the
    layer adds none of its attention)."""
    for gi, (pat, _) in enumerate(cfg.pattern_groups):
        for i, bt in enumerate(pat):
            if bt == "cross":
                params["groups"][gi][f"s{i}"]["gate"].fill_(gate)


# (arch, mode): zero1, fsdp (llama's own: mproj and the layers gathered,
# the leaves themselves at one rank), fsdp with an encoder (scope "enc")
ONE_RANK = [("qwen2.5-3b", None), ("llama-3.2-vision-90b", None),
            ("whisper-medium", "fsdp")]


@pytest.mark.parametrize("arch,mode", ONE_RANK)
def test_serve_at_one_rank_is_the_model_api(arch, mode):
    """``serve`` at one rank (its prefill and decode programs) gives the
    logits of ``api.prefill`` and greedy ``api.decode_step`` calls on the
    same weights and prompt, bit for bit."""
    cfg = tserve.model_config(arch, reduced=True)
    params = api.init_params(4, cfg, device="cpu")
    _set_gates(params, cfg)
    got = tserve.serve(arch=arch, prompt_len=PROMPT, decode_n=DECODE,
                       batch=BATCH, reduced=True, device="cpu",
                       params=params, mode=mode)
    tokens = pipeline.make_batch(pipeline.DataConfig(
        vocab=cfg.vocab, batch=BATCH, seq_len=PROMPT - 1, kind="uniform"),
        0)["tokens"]
    logits, cache = api.prefill(params, cfg, pipeline.add_modality_stubs(
        {"tokens": tokens}, cfg, BATCH), flash=True)
    cache = tserve.grow_cache(cache, cfg, BATCH, PROMPT + DECODE)
    every = [logits]
    for i in range(DECODE):
        logits, cache = api.decode_step(params, cfg, every[-1].argmax(-1),
                                        PROMPT + i, cache)
        every.append(logits)
    assert torch.equal(got["logits"], torch.stack(every))


# (arch, q8) served under two gloo ranks: zero1 (the batch's rows and the
# logits gathered), fsdp with the plain and the int8 gather
TWO_RANKS = [("qwen2.5-3b", False), ("llama-3.2-vision-90b", False),
             ("llama-3.2-vision-90b", True)]
TWO_BATCH, TWO_TIMEOUT = 4, 120


def _two_rank_params(arch):
    cfg = tserve.model_config(arch, reduced=True)
    params = api.init_params(6, cfg, device="cpu")
    _set_gates(params, cfg)
    return params


def _serve_rank(rank: int, out_dir: str) -> None:
    import torch.distributed as dist
    torch.set_num_threads(1)
    out = Path(out_dir)
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/store",
                            rank=rank, world_size=2,
                            timeout=timedelta(seconds=TWO_TIMEOUT))
    try:
        for arch, q8 in TWO_RANKS:
            # two data ranks: the zero1 rows and the fsdp gathers
            got = tserve.serve(
                arch=arch, prompt_len=PROMPT, decode_n=DECODE,
                batch=TWO_BATCH, reduced=True, device="cpu",
                params=_two_rank_params(arch), q8=q8, model_axis=1,
                feed=torch.from_numpy(np.load(out / f"feed-{arch}-{q8}.npy")))
            np.save(out / f"two-{arch}-{q8}-{rank}.npy",
                    got["logits"].float().numpy())
            assert (got["inc_telemetry"] is None) == (rank != 0)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The one-rank runs (greedy) here, then the same under two spawned
    gloo ranks fed the one-rank run's tokens: {case: (one, two)}."""
    import torch.multiprocessing as mp
    out = tmp_path_factory.mktemp("serve_two_ranks")
    one = {}
    for arch, q8 in TWO_RANKS:
        run = tserve.serve(arch=arch, prompt_len=PROMPT, decode_n=DECODE,
                           batch=TWO_BATCH, reduced=True, device="cpu",
                           params=_two_rank_params(arch), q8=q8)
        np.save(out / f"feed-{arch}-{q8}.npy", run["tokens"][:, :-1].numpy())
        one[(arch, q8)] = run["logits"].float().numpy()
    ctx = mp.start_processes(_serve_rank, args=(str(out),), nprocs=2,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + TWO_TIMEOUT
    try:
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                raise TimeoutError(f"gloo ranks still running after "
                                   f"{TWO_TIMEOUT} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
    return {case: (one[case], [np.load(out / f"two-{case[0]}-{case[1]}-"
                                       f"{r}.npy") for r in range(2)])
            for case in TWO_RANKS}


@pytest.mark.parametrize("arch,q8", TWO_RANKS)
def test_serve_under_two_ranks_matches_one_rank(two_ranks, arch, q8):
    """Both ranks return the whole batch's logits, the same; teacher
    forced, they are within the logit tolerance of one rank's at every
    step."""
    one, (r0, r1) = two_ranks[(arch, q8)]
    assert r0.shape == one.shape == (DECODE + 1, TWO_BATCH, 512)
    assert r0.tobytes() == r1.tobytes()
    for t in range(DECODE + 1):
        err = np.abs(r0[t] - one[t]).max() / np.abs(one[t]).max()
        assert err < LOGIT_TOL, (arch, q8, t, err)


def test_serve_cli_under_torch_distributed_run():
    """``torch.distributed.run`` with two gloo ranks: the world comes from
    the environment, and rank 0 alone prints."""
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.serve", "--arch",
         "qwen2.5-3b", "--reduced", "--device", "cpu", "--prompt-len", "16",
         "--decode", "2", "--batch", "2"], cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        capture_output=True, text=True, timeout=120, check=True)
    lines = out.stdout.strip().splitlines()
    assert sum(x.startswith("inc telemetry: tokens=4 ") for x in lines) == 1
    assert lines[-1].startswith("sampled token ids[0]: [")


def test_serve_step_refuses_shapes_that_do_not_split():
    """A sequence-sharded decode (a batch that does not split over the
    data ranks) whose cache length does not split either, and a prefill
    batch that does not split."""
    from repro_torch.compat import Mesh
    from repro_torch.configs.base import ShapeConfig, get_arch
    cfg = get_arch("gemma3-27b").reduced()
    mesh = Mesh((2, 1), ("data", "model"), {})
    with pytest.raises(ValueError, match="sequence-sharded cache of 67"):
        steps.build_serve_step(cfg, ShapeConfig("d", 67, 1, "decode"), mesh,
                               device="cpu")
    with pytest.raises(ValueError, match="prefill batch of 3"):
        steps.build_serve_step(cfg, ShapeConfig("p", 64, 3, "prefill"), mesh,
                               device="cpu")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


# (arch, layers, flash launches a prefill): the reduced qwen2.5-3b at two
# layers, gemma3-27b (8), recurrentgemma-9b (5), moonshot-v1-16b-a3b (1),
# mamba2-780m (1) and llama-3.2-vision-90b (5) at their full pattern depth,
# and whisper-medium at two decoder layers, where every gemma3 layer,
# recurrentgemma's one local layer, moonshot's moe layer, llama's four
# global layers and whisper's selfcross layers take the kernel at the
# prompt of PROMPTS, and mamba2's ssd layer, llama's cross layer and
# whisper's encoder none
CUDA_SERVE = [("qwen2.5-3b", 2, 2), ("gemma3-27b", None, 8),
              ("recurrentgemma-9b", None, 1), ("moonshot-v1-16b-a3b", None, 1),
              ("mamba2-780m", None, 0), ("whisper-medium", 2, 2),
              ("llama-3.2-vision-90b", None, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("arch,layers,launches", CUDA_SERVE)
def test_cuda_serve_matches_cpu(cuda, arch, layers, launches):
    """The reduced config on the card (prefill through the flash kernel,
    telemetry through sparse_addto) against the same weights and tokens
    on the CPU, teacher forced."""
    import copy
    from repro_torch.kernels import ops
    cfg = tserve.model_config(arch, reduced=True, layers=layers)
    p_cpu = api.init_params(5, cfg, device="cpu")
    kw = dict(arch=arch, prompt_len=PROMPTS[arch], decode_n=DECODE,
              batch=BATCH, reduced=True, layers=layers)
    ops.reset_counts()
    card = tserve.serve(device=None, params=copy.deepcopy(p_cpu).to(cuda),
                        **kw)
    counts = ops.launch_counts()
    assert counts["flash_attention"] == launches
    assert counts["sparse_addto"] > 0
    cpu = tserve.serve(device="cpu", params=p_cpu,
                       feed=card["tokens"][:, :-1].cpu(), **kw)
    for t in range(DECODE + 1):
        la, lb = card["logits"][t].float().cpu(), cpu["logits"][t].float()
        assert float((la - lb).abs().max() / lb.abs().max()) < LOGIT_TOL


@pytest.mark.cuda
def test_cuda_seq_axes_at_one_rank_is_the_whole_cache(cuda):
    """On the card, decode steps with ``seq_axes`` over a one-rank NCCL
    mesh (the partial-softmax combine's pmax and psums, over one rank)
    give the logits and cache of the same steps without, bit for bit."""
    from repro_torch.launch.mesh import make_host_mesh, one_rank_group
    cfg = tserve.model_config("gemma3-27b", reduced=True)
    params = api.init_params(7, cfg, device=cuda)
    toks = torch.randint(0, cfg.vocab, (1, 64),
                         generator=torch.Generator().manual_seed(8)).to(cuda)
    _, cache = api.prefill(params, cfg, {"tokens": toks})
    cache = tserve.grow_cache(cache, cfg, 1, 64 + DECODE)
    copy = tuple({s: {k: t.clone() for k, t in e.items()}
                  for s, e in g.items()} for g in cache)
    with one_rank_group(cuda):
        seq_axes = make_host_mesh(model=1).axes_of(("data",))
        tok = toks[:, -1]
        for i in range(DECODE):
            a, _ = api.decode_step(params, cfg, tok, 64 + i, cache,
                                   seq_axes=seq_axes)
            b, _ = api.decode_step(params, cfg, tok, 64 + i, copy)
            assert torch.equal(a, b), i
            tok = a.argmax(-1)
    for g, h in zip(cache, copy):
        for s in g:
            for k in g[s]:
                assert torch.equal(g[s][k], h[s][k]), (s, k)

