"""The dry run of one (arch x shape) cell on a production mesh: the port
of ``repro/launch/dryrun.py``.

One process stands for rank 0 of the (16, 16) ("data", "model") mesh,
or of the (2, 16, 16) ("pod", "data", "model") one with ``--mesh multi``:
``run_cell`` starts a world of 256 or 512 ranks on torch's fake process
group (its collectives move nothing and return at once), builds the
mesh's groups over it, builds the rank's program (``build_train_step``
or ``build_serve_step``) on the meta device, and runs one call of it on
meta tensors (shapes and dtypes, no data) under ``roofline.analysis``'s
counter. It reports the rank's FLOPs, HBM bytes and collective bytes as
a three-term roofline on an H100, and the peak of its live bytes against
the card's memory (``fits``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-27b \\
        --shape train_4k --mesh multi --inc-mode netrpc [--json out.json]

Prints ``DRYRUN_RESULT {...}`` with the reference's keys (``trace_s``,
the call's seconds on the host, in place of ``lower_s``/``compile_s``).
Exit code 0 iff the cell ran or ``shape_applicable`` skipped it; a cell
that does not fit is reported, not failed. The world starts inside
``run_cell``, never at import, and one process runs one cell: the sweep
(``launch/dryrun_all.py``) runs each in a subprocess.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback

# torch.cuda.get_device_properties(0).total_memory of an NVIDIA H100 80GB
# HBM3, as chip_smoke.py's phase x prints it
CARD_BYTES = 85_017_493_504


def fake_world(world: int) -> None:
    """The default process group: ``world`` ranks of torch's fake backend,
    this process rank 0, for CPU and meta tensors."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a dry run starts its own world: one cell a "
                           "process")
    dist.init_process_group("cpu:fake,meta:fake", store=FakeStore(),
                            rank=0, world_size=world)


def cell_inputs(prog, cfg, shape) -> tuple:
    """The program's arguments on the meta device: this rank's shards of
    the params (and, to train, a fresh optimizer state), and the global
    batch, or a decode's token, last position and cache shard."""
    import torch

    from repro_torch.launch import steps
    from repro_torch.models import api
    shapes = api.param_shapes(cfg)
    params = api.shard_tree(shapes, prog.meta["param_specs"], prog.mesh)
    specs = api.input_specs(cfg, shape)
    if shape.kind == "train":
        opt = steps.init_opt(shapes, prog.meta["opt_specs"], prog.mesh)
        return params, opt, specs, 0
    if shape.kind == "prefill":
        return params, specs
    cache = steps.shard_cache(specs["cache"], prog)
    token = torch.empty(specs["token"].shape, dtype=specs["token"].dtype,
                        device="meta")
    return params, token, shape.seq_len - 1, cache


def count_program(cfg, shape, mesh, *, inc=None, opt_cfg=None,
                  n_micro: int | None = None, flash: bool = False,
                  q8: bool = False) -> tuple:
    """This rank's program of ``cfg`` at ``shape`` on ``mesh`` (built over
    a fake world, its groups of ``device="meta"``), run once on meta
    inputs under the counter: (the program, its ``Roofline``, the call's
    seconds on the host). A train step takes ``inc``, ``opt_cfg``,
    ``n_micro`` and ``flash``, a serve program ``flash`` and ``q8``."""
    from repro_torch.launch import steps
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.roofline import analysis
    if shape.kind == "train":
        prog = steps.build_train_step(
            cfg, shape, mesh, inc=inc, opt_cfg=opt_cfg or AdamWConfig(),
            n_micro=n_micro, flash=flash, device="meta")
    else:
        prog = steps.build_serve_step(cfg, shape, mesh, q8=q8, flash=flash,
                                      device="meta")
    args = cell_inputs(prog, cfg, shape)
    t0 = time.time()
    _, roof = analysis.analyze(prog.fn, *args)
    return prog, roof, time.time() - t0


def run_cell(arch: str, shape_name: str, mesh_kind: str, inc_mode: str,
             precision: int = 8, n_micro: int | None = None,
             flash: bool = False, pad_heads: int = 0,
             qgather: bool = False, pad_kv: int = 0) -> dict:
    """The cell's roofline and memory on rank 0 of the production mesh,
    as a dict (``status`` "ok" or "skipped"). ``flash`` routes a prefill
    through kernel 11 and a train step through kernel 11 and its backward
    kernels, as the reference's ``REPRO_FLASH_ATTN=1`` does (its
    ``flash_traffic_bytes`` then equals the flash kernels' records),
    ``qgather`` the fsdp serve gather through int8,
    ``pad_heads``/``pad_kv`` pad the heads as the reference does."""
    from dataclasses import replace as _replace

    from repro_torch.configs.base import SHAPES, get_arch, shape_applicable
    from repro_torch.core.inc_agg import IncAggConfig
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import api
    from repro_torch.roofline import analysis
    from repro_torch.roofline.flash_model import flash_traffic_bytes

    cfg = get_arch(arch)
    if pad_heads:
        # sharding-equivalence padding (zero heads + grad mask in prod):
        # shapes-only measurement, as in the reference
        kv = pad_kv or cfg.n_kv_heads
        if pad_heads % kv:
            raise ValueError(f"{pad_heads} heads do not group over {kv} KV "
                             f"heads")
        cfg = _replace(cfg, n_heads=pad_heads, n_kv_heads=kv)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                "status": "skipped", "why": why}

    n_chips = 512 if mesh_kind == "multi" else 256
    fake_world(n_chips)
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"),
                                device="meta")
    prog, roof, trace_s = count_program(
        cfg, shape, mesh, inc=IncAggConfig(mode=inc_mode,
                                           precision=precision),
        n_micro=n_micro, flash=flash, q8=qgather)

    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    mf = analysis.model_flops(api.count_params(cfg),
                              api.count_params(cfg, active_only=True),
                              shape.kind, tokens)
    s = roof.summary()
    s.update({
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "inc_mode": inc_mode, "status": "ok",
        "flash": flash, "pad_heads": pad_heads, "qgather": qgather,
        "kind": shape.kind, "mode": prog.meta["mode"],
        "n_micro": prog.meta.get("n_micro"),
        "chips": n_chips,
        "trace_s": round(trace_s, 1),
        "memory": {"argument_size_in_bytes": roof.arg_bytes,
                   "peak_size_in_bytes": roof.peak_bytes},
        "bytes_per_device": roof.peak_bytes,
        "card_bytes": CARD_BYTES,
        "fits": roof.peak_bytes <= CARD_BYTES,
        "flash_traffic_bytes": flash_traffic_bytes(
            cfg, shape, n_dp=prog.meta["n_dp"],
            n_model=prog.meta["n_model"],
            n_micro=prog.meta.get("n_micro") or 1) if flash else 0.0,
        "model_flops_per_dev": mf / n_chips,
        "useful_ratio": (mf / n_chips) / max(roof.flops, 1.0),
        "model_compute_s": mf / n_chips / analysis.PEAK_FLOPS,
    })
    s["roofline_fraction"] = s["model_compute_s"] / max(
        s["compute_s"], s["memory_s"], s["collective_s"], 1e-30)
    return s


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", choices=("single", "multi"), default="single")
    ap.add_argument("--inc-mode", default="netrpc")
    ap.add_argument("--precision", type=int, default=8)
    ap.add_argument("--n-micro", type=int, default=None)
    ap.add_argument("--flash", action="store_true")
    ap.add_argument("--pad-heads", type=int, default=0)
    ap.add_argument("--pad-kv", type=int, default=0)
    ap.add_argument("--qgather", action="store_true")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    try:
        res = run_cell(args.arch, args.shape, args.mesh, args.inc_mode,
                       args.precision, args.n_micro, args.flash,
                       args.pad_heads, args.qgather, args.pad_kv)
    except Exception as e:
        traceback.print_exc()
        res = {"arch": args.arch, "shape": args.shape, "mesh": args.mesh,
               "inc_mode": args.inc_mode, "status": "error",
               "error": f"{type(e).__name__}: {e}"}
    print("DRYRUN_RESULT " + json.dumps(res))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res, f, indent=2)
    return 0 if res["status"] in ("ok", "skipped") else 1


if __name__ == "__main__":
    sys.exit(main())
