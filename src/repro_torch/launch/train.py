"""Training launcher: the port of ``repro/launch/train.py`` on one card.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
        --inc-mode netrpc --steps 200 --seq 128 --batch 8

The train step runs on the card unless ``--device cpu`` (with
``--reduced`` for the tiny same-family config; ``--layers N`` cuts the
depth). Without a card and without ``--device cpu`` it raises. The loop
integrates: the deterministic data pipeline, the INC-aggregated train
step (``launch/steps.py``), the CntFwd elastic quorum (``--quorum``; one
rank casts one vote a step), the metric telemetry on the port's
``IncRuntime``, and checkpoint/restart with the step-parity exactly-once
gate. Weights are random, from a seed. One process is one data-parallel
rank: the loop makes a ``torch.distributed`` group of one rank (a free
port on localhost) unless one is already initialized.
"""
from __future__ import annotations

import argparse
import contextlib
import socket
import time

import torch
import torch.distributed as dist

from repro_torch import compat
from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.inc_agg import IncAggConfig
from repro_torch.data import pipeline
from repro_torch.kernels.backend import resolve_device
from repro_torch.launch import steps
from repro_torch.launch.serve import model_config
from repro_torch.optim.adamw import AdamWConfig


@contextlib.contextmanager
def one_rank_group(device: torch.device):
    """A default process group of one rank for the loop, unless the
    caller already made one: NCCL on the card, gloo on the CPU."""
    if dist.is_initialized():
        yield
        return
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=f"tcp://127.0.0.1:{port}", rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def train_loop(*, arch: str, inc_mode: str, steps_n: int, seq: int,
               batch: int, reduced: bool, precision: int = 8,
               ckpt_dir: str | None = None, ckpt_every: int = 50,
               resume: bool = True, data_kind: str = "bigram",
               log_every: int = 10, n_micro: int = 1, quorum: float = 1.0,
               device=None, layers: int | None = None) -> dict:
    """Train ``arch`` for ``steps_n`` steps on ``device`` (the card by
    default), on a ``(data=1, model=1)`` mesh. Returns the losses,
    gnorms and seconds of every step run, the final params and optimizer
    state, the telemetry summary and the bigram loss floor."""
    dev = resolve_device(device)
    cfg = model_config(arch, reduced, layers)
    with one_rank_group(dev):
        mesh = compat.make_mesh((1, 1), ("data", "model"), device=dev)
        shape = ShapeConfig("cli_train", seq_len=seq, global_batch=batch,
                            kind="train")
        inc = IncAggConfig(mode=inc_mode, precision=precision)
        opt_cfg = AdamWConfig(warmup_steps=max(steps_n // 20, 5),
                              total_steps=steps_n)
        prog = steps.build_train_step(cfg, shape, mesh, inc=inc,
                                      opt_cfg=opt_cfg, n_micro=n_micro,
                                      device=dev)
        params, opt = steps.init_state(prog, cfg)

        store = CheckpointStore(ckpt_dir) if ckpt_dir else None
        start = 0
        if store and resume and store.latest_step() is not None:
            start = store.latest_step() + 1
            state = store.restore(store.latest_step(),
                                  {"params": params, "opt": opt})
            params, opt = state["params"], state["opt"]
            print(f"resumed from step {start - 1}")

        dcfg = pipeline.DataConfig(vocab=cfg.vocab, batch=batch,
                                   seq_len=seq, kind=data_kind)
        # metric + agreement channels on the async INC runtime (typed
        # schema services, launch/steps.py): per-step pushes and commit
        # votes enqueue through the generated stubs and return; the
        # scheduler coalesces them into drained batches off the hot path
        telemetry = steps.TrainTelemetry(n_workers=prog.meta["n_dp"],
                                         quorum=quorum, app_prefix="train",
                                         device=dev)
        losses, gnorms, step_s = [], [], []
        ran = 0
        t0 = time.time()
        for s in range(start, steps_n):
            if store and store.already_applied(s):
                continue  # exactly-once: this step is a "retransmission"
            b = pipeline.make_batch(dcfg, s)
            b = pipeline.shard_batch(
                pipeline.add_modality_stubs(b, cfg, batch), dev)
            ts = time.perf_counter()
            params, opt, m = prog.fn(params, opt, b, s)
            losses.append(float(m["loss"]))
            gnorms.append(float(m["gnorm"]))
            _sync(dev)
            step_s.append(time.perf_counter() - ts)
            ran += 1
            telemetry.push({"loss_sum": losses[-1], "steps": 1,
                            "gnorm_sum": gnorms[-1]})
            # one commit vote per dp rank; CntFwd forwards exactly one
            # quorum notification per step once >= quorum * n_dp votes
            for _ in range(prog.meta["n_dp"]):
                telemetry.vote(s)
            if s % log_every == 0 or s == steps_n - 1:
                print(f"step {s:5d} loss {losses[-1]:.4f} "
                      f"gnorm {gnorms[-1]:.3f} lr {float(m['lr']):.2e} "
                      f"({time.time() - t0:.1f}s)")
            if store and s and s % ckpt_every == 0:
                store.save(s, {"params": params, "opt": opt})
        if store:
            store.save(steps_n - 1, {"params": params, "opt": opt})
            store.wait()
        summary = telemetry.finish()
    if ran:
        sched = summary["scheduling"].get("train-metrics", {})
        print(f"inc telemetry: steps="
              f"{summary['metrics'].get('steps', 0):.0f} mean_loss="
              f"{summary['metrics'].get('loss_sum', 0.0) / ran:.4f} "
              f"commits={summary['commits']}/{ran} "
              f"mean_drained_batch={sched.get('mean_drained_batch', 0)}")
    return {"losses": losses, "gnorms": gnorms, "step_s": step_s,
            "params": params, "opt": opt, "inc_telemetry": summary,
            "n_layers": cfg.n_layers,
            "entropy_floor": (pipeline.bigram_entropy(dcfg)
                              if data_kind == "bigram" else None)}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--inc-mode", default="netrpc")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--precision", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--data", default="bigram")
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--quorum", type=float, default=1.0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to N layers")
    args = ap.parse_args()
    out = train_loop(arch=args.arch, inc_mode=args.inc_mode,
                     steps_n=args.steps, seq=args.seq, batch=args.batch,
                     reduced=args.reduced, precision=args.precision,
                     ckpt_dir=args.ckpt_dir, data_kind=args.data,
                     n_micro=args.n_micro, quorum=args.quorum,
                     device=args.device, layers=args.layers)
    ls = out["losses"]
    if ls:
        print(f"final loss {ls[-1]:.4f} (first {ls[0]:.4f}); "
              f"entropy floor {out['entropy_floor']}")


if __name__ == "__main__":
    main()
