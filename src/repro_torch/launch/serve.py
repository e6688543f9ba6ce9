"""Serving launcher: prefill a batch of prompts, then decode N tokens.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \
        --prompt-len 2048 --decode 32 --batch 4

The port of ``repro/launch/serve.py`` on one card (``--device cpu`` for
the CPU, with ``--reduced`` for the tiny same-family config): prefill
builds the KV cache, the cache grows with zeros to prompt + decode
positions, and greedy decode steps consume and update it, each pushing
its token count and step time to the serve telemetry on the port's
``IncRuntime``. Prefill attention runs through the flash kernel
(``--no-flash`` for the dense lane). Weights are random, from a seed.
``--layers N`` cuts the depth, for checks that compare the card with the
CPU at full width.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import replace

import torch

from repro_torch.configs.base import ArchConfig, get_arch
from repro_torch.data import pipeline
from repro_torch.kernels.backend import resolve_device
from repro_torch.launch import steps
from repro_torch.models import api


def with_layers(cfg: ArchConfig, n: int) -> ArchConfig:
    """``cfg`` cut to its first ``n`` layers (one repeating pattern)."""
    if len(cfg.pattern_groups) != 1 or len(cfg.pattern_groups[0][0]) != 1:
        raise ValueError(f"{cfg.name}: --layers needs a stack of one block "
                         f"type")
    (pat, _), = cfg.pattern_groups
    return replace(cfg, n_layers=n, pattern_groups=((pat, n),))


def model_config(arch: str, reduced: bool = False,
                 layers: int | None = None) -> ArchConfig:
    cfg = get_arch(arch)
    if reduced:
        cfg = cfg.reduced()
    return with_layers(cfg, layers) if layers else cfg


def grow_cache(cache: tuple, total: int) -> tuple:
    """The prefill cache, its sequence dim padded with zeros to ``total``
    positions (dim 2 of each stacked (n, B, S, KV, hd) leaf)."""
    def grow(t):
        out = t.new_zeros(t.shape[:2] + (total,) + t.shape[3:])
        out[:, :, :t.shape[2]] = t
        return out
    return tuple({s: {k: grow(t) for k, t in e.items()} for s, e in g.items()}
                 for g in cache)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(*, arch: str, prompt_len: int, decode_n: int, batch: int,
          reduced: bool = False, flash: bool = True, device=None,
          layers: int | None = None, params=None, tokens=None,
          feed=None, seed: int = 0) -> dict:
    """Prefill ``batch`` prompts of ``prompt_len`` tokens, then decode
    ``decode_n`` tokens greedily. ``params`` and ``tokens`` (B, prompt_len)
    default to random weights from ``seed`` and a uniform batch;
    ``feed`` (B, decode_n) replaces the greedy tokens fed to the decode
    steps (teacher forcing, to compare two lanes step by step).

    Returns the tokens (B, decode_n + 1), the logits of every step
    (decode_n + 1, B, V), the telemetry summary and the seconds of
    prefill and decode."""
    dev = resolve_device(device)
    cfg = model_config(arch, reduced, layers)
    total = prompt_len + decode_n
    if params is None:
        params = api.init_params(seed, cfg, device=dev)
    if tokens is None:
        dcfg = pipeline.DataConfig(vocab=cfg.vocab, batch=batch,
                                   seq_len=prompt_len - 1, kind="uniform")
        tokens = pipeline.make_batch(dcfg, 0)["tokens"]
    tokens = tokens.to(dev)

    # serve telemetry on the async INC runtime: per-token counters
    # enqueue on the decode path through the generated stubs and coalesce
    # off-thread (never a blocking INC call)
    telemetry = steps.TrainTelemetry(app_prefix="serve", device=dev)
    t0 = time.perf_counter()
    logits, cache = api.prefill(params, cfg, {"tokens": tokens},
                                flash=flash)
    cache = grow_cache(cache, total)
    _sync(dev)
    t1 = time.perf_counter()
    toks = [logits.argmax(-1)]
    every = [logits]
    tprev = time.perf_counter()
    for i in range(decode_n):
        tok = toks[-1] if feed is None else feed[:, i].to(dev)
        logits, cache = api.decode_step(params, cfg, tok, prompt_len + i,
                                        cache)
        toks.append(logits.argmax(-1))
        every.append(logits)
        _sync(dev)
        tnow = time.perf_counter()
        telemetry.push({"decode_tokens": batch,
                        "decode_ms_sum": (tnow - tprev) * 1e3})
        tprev = tnow
    t2 = time.perf_counter()
    out = torch.stack(toks, dim=1)
    inc = telemetry.finish()
    got = inc["metrics"]
    print(f"prefill {prompt_len} tokens x{batch}: {t1 - t0:.2f}s; "
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
    args = ap.parse_args()
    serve(arch=args.arch, prompt_len=args.prompt_len, decode_n=args.decode,
          batch=args.batch, reduced=args.reduced, flash=args.flash,
          device=args.device, layers=args.layers)


if __name__ == "__main__":
    main()
