"""Serving launcher: prefill a batch of prompts, then decode N tokens.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \
        --prompt-len 2048 --decode 32 --batch 4
    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 2 \
        -m repro_torch.launch.serve --arch qwen2.5-3b --reduced \
        --device cpu --prompt-len 32 --decode 8 --batch 4

The port of ``repro/launch/serve.py`` (``--device cpu`` for the CPU,
with ``--reduced`` for the tiny same-family config). As the reference's,
it builds a prefill and a decode program with ``steps.build_serve_step``
on a ``make_host_mesh`` mesh over the world (``mesh.world_group``: the
ranks of ``torch.distributed.run``, NCCL on the card (one card a rank)
and gloo with ``--device cpu``, else one rank), each rank holding its
shards of the params (``--mode``: the arch's zero1 or fsdp by default;
``--q8-gather``: fsdp's int8 gather) and its rows of the batch.
``--model-axis`` (2 by default, as the reference's) is cut to the world,
as the reference cuts it to its devices: one card serves at a model axis
of 1, two ranks at one data rank over a model axis of 2, each rank its
cut of the heads, the ff dim, the vocab and the recurrent widths, for
every config. Prefill builds each rank's cache
(K/V of the attention layers, ``moe`` ones included, a ring of the
window for a ``local`` layer, the state and conv tail of an ``rglru`` or
``ssd`` layer, the memory's K/V of a ``cross`` or ``selfcross`` layer),
the global K/V grow with zeros to prompt + decode positions, and greedy
decode steps consume and update it; rank 0 pushes each step's token count
and time to the serve telemetry on the port's ``IncRuntime`` and prints.
Prefill attention runs through the flash kernel (``--no-flash`` for the
dense lane); a local layer takes it when the prompt is longer than its
window. Weights are random, from a seed; the audio frames (whisper) and
image patches (the VLM) are the pipeline's stubs
(``pipeline.add_modality_stubs``). ``--layers N`` cuts the depth to the
first N layers, for checks that compare the card with the CPU at full
width; it cuts whisper's decoder and leaves its ``enc_layers`` encoder
layers as they are. gemma3-27b, recurrentgemma-9b, moonshot-v1-16b-a3b
(MoE), mamba2-780m (SSD), whisper-medium (encoder-decoder; 448 = prompt
+ decode positions is its decoder's context) and llama-3.2-vision-90b
(cross-attention to the patches; the full 100 layers take several cards,
10 fit one) serve the same way; an ``ssd`` prompt longer than one SSD
chunk (256 tokens) must be a whole number of chunks:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-27b \
        --prompt-len 2048 --decode 32 --batch 4
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-780m \
        --prompt-len 4096 --decode 32 --batch 4
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-medium \
        --prompt-len 416 --decode 32 --batch 4
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch llama-3.2-vision-90b --layers 10 --prompt-len 2048 \
        --decode 32 --batch 4 --q8-gather
"""
from __future__ import annotations

import argparse
import time
from dataclasses import replace

import torch
import torch.distributed as dist

from repro_torch.configs.base import ArchConfig, ShapeConfig, get_arch
from repro_torch.data import pipeline
from repro_torch.kernels.backend import resolve_device
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_host_mesh, world_group
from repro_torch.models import api


def with_layers(cfg: ArchConfig, n: int) -> ArchConfig:
    """``cfg`` cut to its first ``n`` layers in stack order: whole repeats
    of each pattern unit while they fit, then the first layers of the
    next unit as a group of one repeat (gemma3-27b at 6: five ``local``
    and one ``global``). Past the stack's depth, more repeats of its last
    unit (the reduced qwen2.5-3b, one layer, at 2)."""
    if n < 1:
        raise ValueError(f"{cfg.name}: {n} layers")
    groups, left = [], n
    for pat, r in cfg.pattern_groups:
        whole = min(r, left // len(pat))
        if whole:
            groups.append((pat, whole))
            left -= whole * len(pat)
        if left and whole < r:
            groups.append((pat[:left], 1))
            left = 0
        if not left:
            break
    if left:
        pat, r = groups[-1]
        groups[-1] = (pat, r + left // len(pat))
        if left % len(pat):
            groups.append((pat[:left % len(pat)], 1))
    return replace(cfg, n_layers=n, pattern_groups=tuple(groups))


def model_config(arch: str | ArchConfig, reduced: bool = False,
                 layers: int | None = None) -> ArchConfig:
    """The config of an arch name (or an ``ArchConfig`` as it is), then
    reduced and cut as asked."""
    cfg = arch if isinstance(arch, ArchConfig) else get_arch(arch)
    if reduced:
        cfg = cfg.reduced()
    return with_layers(cfg, layers) if layers else cfg


def grow_cache(cache: tuple, cfg: ArchConfig, batch: int,
               total: int) -> tuple:
    """The prefill cache of ``batch`` rows grown to its decode length: a
    self-attention's K/V (not a local ring) padded with zeros along the
    sequence to the ``total`` positions of ``api.cache_specs(cfg, batch,
    total)``; every other leaf kept as it is (a local ring, a recurrent
    state and conv tail, a memory's K/V). Only the sequence grows: the
    other dims are the leaf's own, a tensor-parallel rank's KV heads
    (``meta["kv_heads"]``) or its cut of a recurrent state."""
    def grow(key, t, like):
        if t.shape[1] != batch:
            raise ValueError(f"a cache leaf of {t.shape[1]} rows, not "
                             f"{batch}")
        if key not in ("k", "v") or t.shape[2] == like.shape[2]:
            return t
        if t.shape[2] > like.shape[2]:
            raise ValueError(f"a cache leaf of shape {tuple(t.shape)} does "
                             f"not grow to {like.shape[2]} positions")
        out = t.new_zeros(t.shape[:2] + like.shape[2:3] + t.shape[3:])
        out[:, :, :t.shape[2]] = t
        return out
    specs = api.cache_specs(cfg, batch, total)
    return tuple({s: {k: grow(k, t, sg[s][k]) for k, t in e.items()}
                  for s, e in g.items()} for g, sg in zip(cache, specs))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(*, arch: str | ArchConfig, prompt_len: int, decode_n: int,
          batch: int, reduced: bool = False, flash: bool = True,
          device=None, layers: int | None = None, params=None, tokens=None,
          feed=None, seed: int = 0, mode: str | None = None,
          q8: bool = False, model_axis: int = 2) -> dict:
    """Prefill ``batch`` prompts of ``prompt_len`` tokens, then decode
    ``decode_n`` tokens greedily, through ``build_serve_step``'s programs
    on a ``make_host_mesh(min(model_axis, world))`` mesh over the world
    (``world_group``). ``params`` (the full tree) and ``tokens`` (B,
    prompt_len) default to random weights from ``seed`` and a uniform
    batch; each rank keeps its shards of ``params``. ``feed`` (B,
    decode_n) replaces the greedy tokens fed to the decode steps (teacher
    forcing, to compare two lanes step by step). The frames or patches of
    an arch with a memory are the pipeline's stubs for ``batch`` rows.
    ``mode`` and ``q8`` are ``build_serve_step``'s.

    Returns the tokens (B, decode_n + 1), the logits of every step
    (decode_n + 1, B, V), the telemetry summary (rank 0; None elsewhere)
    and the seconds of prefill and decode."""
    dev = resolve_device(device)
    cfg = model_config(arch, reduced, layers)
    total = prompt_len + decode_n
    if params is None:
        params = api.init_params(seed, cfg, device=dev)
    if tokens is None:
        dcfg = pipeline.DataConfig(vocab=cfg.vocab, batch=batch,
                                   seq_len=prompt_len - 1, kind="uniform")
        tokens = pipeline.make_batch(dcfg, 0)["tokens"]
    b = tokens.shape[0]
    inputs = pipeline.add_modality_stubs({"tokens": tokens}, cfg, b)
    with world_group(dev):
        mesh = make_host_mesh(model=min(model_axis, dist.get_world_size()),
                              device=dev)
        lead = dist.get_rank() == 0
        kw = dict(mode=mode, q8=q8, flash=flash, device=dev)
        pf = steps.build_serve_step(
            cfg, ShapeConfig("cli_prefill", seq_len=prompt_len,
                             global_batch=b, kind="prefill"), mesh, **kw)
        dec = steps.build_serve_step(
            cfg, ShapeConfig("cli_decode", seq_len=total, global_batch=b,
                             kind="decode"), mesh, **kw)
        # this rank's shards (at one rank the leaves themselves)
        params = api.shard_tree(params, pf.meta["param_specs"], mesh)
        # serve telemetry on the async INC runtime: per-token counters
        # enqueue on the decode path through the generated stubs and
        # coalesce off-thread (never a blocking INC call)
        telemetry = steps.TrainTelemetry(app_prefix="serve", device=dev) \
            if lead else None
        t0 = time.perf_counter()
        logits, cache = pf.fn(params, inputs)
        cache = grow_cache(cache, cfg, b // pf.meta["n_dp"], total)
        _sync(dev)
        t1 = time.perf_counter()
        toks = [logits.argmax(-1)]
        every = [logits]
        tprev = time.perf_counter()
        for i in range(decode_n):
            tok = toks[-1] if feed is None else feed[:, i].to(dev)
            logits, cache = dec.fn(params, tok, prompt_len + i, cache)
            toks.append(logits.argmax(-1))
            every.append(logits)
            _sync(dev)
            tnow = time.perf_counter()
            if lead:
                telemetry.push({"decode_tokens": b,
                                "decode_ms_sum": (tnow - tprev) * 1e3})
            tprev = tnow
        t2 = time.perf_counter()
        out = torch.stack(toks, dim=1)
        inc = telemetry.finish() if lead else None
    if lead:
        got = inc["metrics"]
        print(f"prefill {prompt_len} tokens x{b}: {t1 - t0:.2f}s; "
              f"decode {decode_n} tokens: {t2 - t1:.2f}s "
              f"({decode_n / max(t2 - t1, 1e-9):.1f} tok/s)")
        sched = inc["scheduling"].get("serve-metrics", {})
        print(f"inc telemetry: tokens={got.get('decode_tokens', 0):.0f} "
              f"mean_step_ms={got.get('decode_ms_sum', 0.0) / max(decode_n, 1):.1f} "
              f"mean_drained_batch={sched.get('mean_drained_batch', 0)}")
        print("sampled token ids[0]:", out[0][:16].tolist())
    return {"tokens": out, "logits": torch.stack(every),
            "inc_telemetry": inc, "prefill_s": t1 - t0,
            "decode_s": t2 - t1}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--decode", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to N layers")
    ap.add_argument("--no-flash", dest="flash", action="store_false",
                    help="dense prefill attention instead of the flash "
                         "kernel")
    ap.add_argument("--mode", choices=("zero1", "fsdp"), default=None,
                    help="the arch's (sharding.rules.mode_for) by default")
    ap.add_argument("--q8-gather", dest="q8", action="store_true",
                    help="fsdp's param gather in int8 (the reference's "
                    "REPRO_QUANTIZED_GATHER=1)")
    ap.add_argument("--model-axis", type=int, default=2,
                    help="the mesh's model axis (tensor parallelism), cut "
                    "to the world")
    args = ap.parse_args()
    serve(arch=args.arch, prompt_len=args.prompt_len, decode_n=args.decode,
          batch=args.batch, reduced=args.reduced, flash=args.flash,
          device=args.device, layers=args.layers, mode=args.mode,
          q8=args.q8, model_axis=args.model_axis)


if __name__ == "__main__":
    main()
