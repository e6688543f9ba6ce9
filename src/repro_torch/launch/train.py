"""Training launcher: the port of ``repro/launch/train.py``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
        --inc-mode netrpc --steps 200 --seq 128 --batch 8
    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 2 \\
        -m repro_torch.launch.train --arch qwen2.5-3b --reduced \\
        --device cpu --mode fsdp --steps 20

The train step runs on the card unless ``--device cpu`` (with
``--reduced`` for the tiny same-family config; ``--layers N`` cuts the
depth). ``--flash`` trains the causal attention through the flash kernel
and its backward kernels, the reference's ``REPRO_FLASH_ATTN=1``. Without a card and without ``--device cpu`` it raises. The loop
integrates: the deterministic data pipeline, the INC-aggregated train
step (``launch/steps.py``, ``--mode zero1`` or ``fsdp``, by default the
arch's ``rules.mode_for``), the CntFwd elastic quorum (``--quorum``; one
vote a dp rank and step), the metric telemetry on the port's
``IncRuntime``, and checkpoint/restart with the step-parity exactly-once
gate. Weights are random, from a seed. One process is one rank of a
``make_host_mesh`` mesh over the world that
``torch.distributed.run`` initialized (``RANK`` and ``WORLD_SIZE`` in the
environment; on the card each rank takes ``cuda:LOCAL_RANK``); without
that environment the loop makes a group of one rank (a free port on
localhost) unless one is already initialized. Rank 0 alone runs the
telemetry, as the reference's single controller does, and prints.
``--model-axis`` (2 by default, as the reference's) is cut to the world,
as the reference cuts it to its devices: ranks ``m * i .. m * i + m - 1``
are the tensor-parallel ranks of data index ``i`` (``make_host_mesh``,
row-major over ("data", "model")), so ``--nproc-per-node 2`` runs one data
rank over a model axis of 2, and one card (one rank) a model axis of 1.
"""
from __future__ import annotations

import argparse
import math
import os
import time
from concurrent.futures import ThreadPoolExecutor

import torch
import torch.distributed as dist

from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.inc_agg import IncAggConfig
from repro_torch.data import pipeline
from repro_torch.kernels.backend import resolve_device
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_host_mesh, world_group
from repro_torch.launch.serve import model_config
from repro_torch.optim.adamw import AdamWConfig


def _timed_batch(dcfg: pipeline.DataConfig, step: int):
    t = time.perf_counter()
    b = pipeline.make_batch(dcfg, step)
    return b, time.perf_counter() - t


def drawn_ahead(dcfg: pipeline.DataConfig, run: list[int]):
    """(step, batch) for each step of ``run``, each batch drawn on a host
    thread ahead of its step. The reference draws its batches on its
    device; the port draws them on the host, where a bigram batch takes
    one exponential a vocab lane and token (16.8 M at B = 16, S = 128 and
    vocab 8 192), on one thread. The depth follows measured times:
    after each step it is ceil(draw seconds / the loop's seconds a
    step), the threads that keep the loop fed, and at most the host's
    cores less the loop's own. A batch is a pure function of (seed,
    step), so drawing ahead changes no token."""
    most = max(1, (os.cpu_count() or 2) - 1)
    depth = 1
    with ThreadPoolExecutor(most) as pool:
        ahead = {}
        for i, s in enumerate(run):
            # the first batch alone: it draws the chain's table, which the
            # others then share from its cache (else one draw a thread)
            stop = i + 1 + depth if i else 1
            for t in run[i:stop]:
                if t not in ahead:
                    ahead[t] = pool.submit(_timed_batch, dcfg, t)
            b, draw_s = ahead.pop(s).result()
            t0 = time.perf_counter()
            yield s, b
            step_s = time.perf_counter() - t0
            depth = min(most, max(1, math.ceil(draw_s / max(step_s, 1e-6))))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def train_loop(*, arch: str, inc_mode: str, steps_n: int, seq: int,
               batch: int, reduced: bool, precision: int = 8,
               ckpt_dir: str | None = None, ckpt_every: int = 50,
               resume: bool = True, data_kind: str = "bigram",
               log_every: int = 10, n_micro: int = 1, quorum: float = 1.0,
               device=None, layers: int | None = None,
               mode: str | None = None, model_axis: int = 2,
               flash: bool = False) -> dict:
    """Train ``arch`` for ``steps_n`` steps on ``device`` (the card by
    default), this process one rank of a ``make_host_mesh(min(model_axis,
    world))`` mesh over the world (``world_group``), in ``mode`` (zero1 or fsdp;
    the arch's by default); ``flash`` trains the causal attention through
    the flash kernel and its backward kernels (the reference's
    ``REPRO_FLASH_ATTN=1``). Returns the losses, gnorms and seconds of
    every step run, this rank's params and optimizer state, the
    telemetry summary (rank 0; None elsewhere) and the bigram loss
    floor."""
    dev = resolve_device(device)
    cfg = model_config(arch, reduced, layers)
    with world_group(dev):
        mesh = make_host_mesh(model=min(model_axis, dist.get_world_size()),
                              device=dev)
        lead = dist.get_rank() == 0
        shape = ShapeConfig("cli_train", seq_len=seq, global_batch=batch,
                            kind="train")
        inc = IncAggConfig(mode=inc_mode, precision=precision)
        opt_cfg = AdamWConfig(warmup_steps=max(steps_n // 20, 5),
                              total_steps=steps_n)
        prog = steps.build_train_step(cfg, shape, mesh, inc=inc,
                                      opt_cfg=opt_cfg, n_micro=n_micro,
                                      mode=mode, flash=flash, device=dev)
        params, opt = steps.init_state(prog, cfg)
        specs = steps.state_specs(prog)

        store = CheckpointStore(ckpt_dir) if ckpt_dir else None
        start = 0
        if store and resume and store.latest_step() is not None:
            start = store.latest_step() + 1
            state = store.restore(store.latest_step(),
                                  {"params": params, "opt": opt},
                                  specs=specs, mesh=mesh)
            params, opt = state["params"], state["opt"]
            if lead:
                print(f"resumed from step {start - 1}")

        dcfg = pipeline.DataConfig(vocab=cfg.vocab, batch=batch,
                                   seq_len=seq, kind=data_kind)
        # metric + agreement channels on the async INC runtime (typed
        # schema services, launch/steps.py): per-step pushes and commit
        # votes enqueue through the generated stubs and return; the
        # scheduler coalesces them into drained batches off the hot path
        telemetry = steps.TrainTelemetry(n_workers=prog.meta["n_dp"],
                                         quorum=quorum, app_prefix="train",
                                         device=dev) if lead else None
        losses, gnorms, step_s = [], [], []
        ran = 0
        t0 = time.time()
        # exactly-once: a step already applied is a "retransmission"
        run = [s for s in range(start, steps_n)
               if not (store and store.already_applied(s))]
        for s, b in drawn_ahead(dcfg, run):
            b = pipeline.shard_batch(
                pipeline.add_modality_stubs(b, cfg, batch), dev)
            ts = time.perf_counter()
            params, opt, m = prog.fn(params, opt, b, s)
            losses.append(float(m["loss"]))
            gnorms.append(float(m["gnorm"]))
            _sync(dev)
            step_s.append(time.perf_counter() - ts)
            ran += 1
            if lead:
                telemetry.push({"loss_sum": losses[-1], "steps": 1,
                                "gnorm_sum": gnorms[-1]})
                # one commit vote per dp rank; CntFwd forwards exactly one
                # quorum notification per step once >= quorum * n_dp votes
                for _ in range(prog.meta["n_dp"]):
                    telemetry.vote(s)
            if lead and (s % log_every == 0 or s == steps_n - 1):
                print(f"step {s:5d} loss {losses[-1]:.4f} "
                      f"gnorm {gnorms[-1]:.3f} lr {float(m['lr']):.2e} "
                      f"({time.time() - t0:.1f}s)")
            if store and s and s % ckpt_every == 0:
                store.save(s, {"params": params, "opt": opt}, specs=specs,
                           mesh=mesh)
        if store:
            store.save(steps_n - 1, {"params": params, "opt": opt},
                       specs=specs, mesh=mesh)
            store.wait()
            dist.barrier()       # rank 0's write is done for every rank
        summary = telemetry.finish() if lead else None
    if ran and summary:
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
    ap.add_argument("--mode", choices=("zero1", "fsdp"), default=None,
                    help="the arch's (sharding.rules.mode_for) by default")
    ap.add_argument("--model-axis", type=int, default=2,
                    help="the mesh's model axis (tensor parallelism), cut "
                    "to the world")
    ap.add_argument("--flash", action="store_true",
                    help="the causal attention through the flash kernel "
                    "and its backward kernels (the reference's "
                    "REPRO_FLASH_ATTN=1)")
    args = ap.parse_args()
    out = train_loop(arch=args.arch, inc_mode=args.inc_mode,
                     steps_n=args.steps, seq=args.seq, batch=args.batch,
                     reduced=args.reduced, precision=args.precision,
                     ckpt_dir=args.ckpt_dir, data_kind=args.data,
                     n_micro=args.n_micro, quorum=args.quorum,
                     device=args.device, layers=args.layers,
                     mode=args.mode, model_axis=args.model_axis,
                     flash=args.flash)
    ls = out["losses"]
    if ls and out["inc_telemetry"] is not None:
        print(f"final loss {ls[-1]:.4f} (first {ls[0]:.4f}); "
              f"entropy floor {out['entropy_floor']}")


if __name__ == "__main__":
    main()
