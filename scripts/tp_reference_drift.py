"""The reference's own drift between its train step at a (2, 2) mesh and
on one device, from the same state and batch: the reason
tests/test_torch_tp_families.py holds the port's (2, 2) step to the
reference's on loss, global norm, learning rate and the masters' update,
and holds its m and v to the port's one-rank step.

For each (2, 2) train case of that test (the reduced configs, netrpc,
each family's mode, the cross gates at 0.5) it builds the reference's
step on a (2, 2) mesh and on a (1, 1) mesh of forced host devices, runs
both from ``init_state`` on the test's batch, and prints the loss and
the global norm of each, and the leaves of m and v whose ||a - b|| /
||b|| (b the one-device step's) is largest, against the 5% bound of
``test_torch_multirank.py``.

With ``--probe`` it instead tries the reference's step of each family
(its mode) at (1, 2) and (1, 4) in xla-psum and in netrpc, and prints
which run and the first line of each failure: why that test holds the
port's (1, m) steps to the port's one-rank step.

    XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu \\
        PYTHONPATH=src:tests python scripts/tp_reference_drift.py [--probe]

About 4 minutes on the CPU (the probe about as long).
"""
from __future__ import annotations

import argparse

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

import test_torch_tp_families as t
from test_torch_multirank import _flat_jax
from repro.configs.base import ShapeConfig, get_arch
from repro.core.inc_agg import IncAggConfig
from repro.data import pipeline
from repro.launch import steps
from repro.optim.adamw import AdamWConfig


def step(cfg, mode: str, shape: tuple, batch, inc_mode="netrpc") -> dict:
    """One step from ``init_state`` (the cross gates at t.GATE) on a mesh
    of ``shape``: the state after it, flat, and its metrics."""
    mesh = Mesh(np.array(jax.devices()[:int(np.prod(shape))]).reshape(
        shape), ("data", "model"))
    prog = steps.build_train_step(
        cfg, ShapeConfig("t", t.SEQ, t.BATCH, "train"), mesh,
        inc=IncAggConfig(mode=inc_mode, precision=t.PRECISION),
        opt_cfg=AdamWConfig(**t.OPT), n_micro=t.N_MICRO, mode=mode,
        donate=False)
    params, opt = steps.init_state(prog, cfg)

    def gate(g):
        return jnp.full_like(g, t.GATE)
    o_shard = prog.meta["opt_shardings"]
    params = jax.device_put(t._jax_gates(params, cfg, gate),
                            prog.meta["param_shardings"])
    opt = jax.device_put({**opt, "master": t._jax_gates(
        opt["master"], cfg, gate)}, {"master": o_shard, "m": o_shard,
                                     "v": o_shard})
    p2, o2, m = prog.fn(params, opt, batch, jnp.int32(t.STEP))
    return {**_flat_jax(o2, "opt"),
            **{k: float(v) for k, v in m.items()}}


def inputs(cfg):
    return pipeline.add_modality_stubs(pipeline.make_batch(
        pipeline.DataConfig(vocab=cfg.vocab, batch=t.BATCH, seq_len=t.SEQ,
                            kind="bigram"), t.STEP), cfg, t.BATCH)


def probe() -> None:
    for arch, mode in t.MODE.items():
        cfg = get_arch(arch).reduced()
        for shape in ((1, 2), (1, 4)):
            for inc_mode in ("xla-psum", "netrpc"):
                try:
                    step(cfg, mode, shape, inputs(cfg), inc_mode)
                    got = "runs"
                except Exception as e:      # the reference's own failure
                    got = f"fails: {type(e).__name__}: " + \
                        str(e).strip().splitlines()[0][:160]
                print(f"{arch} {mode} {shape} {inc_mode}: {got}",
                      flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--probe", action="store_true")
    if ap.parse_args().probe:
        probe()
        return
    for arch, mode in t.TRAINS:
        cfg = get_arch(arch).reduced()
        batch = inputs(cfg)
        mesh, one = (step(cfg, mode, s, batch) for s in ((2, 2), (1, 1)))
        rel = sorted(
            ((float(np.linalg.norm(mesh[k] - one[k])
                    / (np.linalg.norm(one[k]) + 1e-30)), k)
             for k in one if k.startswith(("opt/m/", "opt/v/"))),
            reverse=True)
        print(f"{arch} {mode}: loss (2, 2) {mesh['loss']:.6f}, one device "
              f"{one['loss']:.6f}; gnorm {mesh['gnorm']:.6f}, "
              f"{one['gnorm']:.6f}; m and v past 5%: "
              f"{sum(r > 0.05 for r, _ in rel)} of {len(rel)}; largest "
              + ", ".join(f"{k} {r:.4f}" for r, k in rel[:3]), flush=True)


if __name__ == "__main__":
    main()
