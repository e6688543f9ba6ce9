"""The drift behind the gradient bounds of tests/test_torch_cross.py, on
the CPU: the reduced llama-3.2-vision-90b (4 ``global`` + 1 ``cross``
layer, the test's shapes and seeding) for ``--draws`` weight draws, each
with its own tokens and patches.

For every leaf it measures ||a - b|| / ||b|| between the port's bf16
gradient, the reference's bf16 gradient and the reference's gradient with
every bf16 leaf, input and product in fp32 (the exact one, up to fp32):
the port against the reference, each against the exact one, and their
ratio. The gate, a scalar summed over every position, is also given as
an absolute error, and the cross layer alone (the gradient of
sum(out * w) by its input, memory and leaves) as the port against the
reference. Prints the largest of each over the draws.

    JAX_PLATFORMS=cpu PYTHONPATH=src:tests python scripts/cross_grad_drift.py --draws 40

About 10 s a draw.
"""
from __future__ import annotations

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_cross as tc
from repro.models import api as japi
from repro.models import blocks as jblocks
from repro_torch.models import api, blocks
from test_torch_model import _bf16, _j, _jtree, _t


def exact_grads(w, toks, patches):
    w32 = jax.tree.map(lambda a: np.asarray(a, np.float32), w)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(japi, "COMPUTE_DTYPE", jnp.float32)
        return tc._ref_grads(w32, toks, patches)[1]


def block_drift(w, rng) -> float:
    """The cross layer alone in bf16: the largest drift of the gradient
    of sum(out * w) by its input, memory and leaves but the gate."""
    jcfg, cfg = tc._cfgs()
    lp, tp = tc._cross_layer(w)
    x, mem = _bf16(rng, tc.B, tc.S, tc.D), _bf16(rng, tc.B, tc.M, tc.D)
    wout = rng.randn(tc.B, tc.S, tc.D).astype(np.float32)

    def jloss(p, x, mem):
        ctx = jblocks.Ctx(cfg=jcfg, positions=jnp.arange(tc.S), memory=mem)
        y, _ = jblocks.block_train(p, "cross", x, ctx)
        return jnp.sum(y.astype(jnp.float32) * wout)
    jp, jx, jm = jax.grad(jloss, argnums=(0, 1, 2))(_jtree(lp), _j(x),
                                                     _j(mem))

    def leaf(t):
        return t.detach().clone().requires_grad_(True)
    tp = {k: {n: leaf(t) for n, t in v.items()} if isinstance(v, dict)
          else leaf(v) for k, v in tp.items()}
    tx, tm = leaf(_t(x)), leaf(_t(mem))
    y, _ = blocks.block_train(tp, "cross", tx, blocks.Ctx(
        cfg=cfg, positions=torch.arange(tc.S), memory=tm))
    (y.float() * torch.from_numpy(wout)).sum().backward()
    pairs = [(tx.grad, jx), (tm.grad, jm), (tp["n1"].grad, jp["n1"]),
             (tp["n2"].grad, jp["n2"])]
    pairs += [(tp[g][n].grad, jp[g][n]) for g in ("xattn", "mlp")
              for n in tp[g]]
    return max(tc._drift(g.double().numpy(),
                         np.asarray(r, np.float64).reshape(g.shape))
               for g, r in pairs)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--draws", type=int, default=40)
    args = ap.parse_args()
    worst = {"port~ref": 0.0, "port~exact": 0.0, "ref~exact": 0.0,
             "ratio": 0.0, "gate port abs": 0.0, "gate ref abs": 0.0,
             "block port~ref": 0.0}
    for seed in range(args.draws):
        w = tc._np_params(seed)
        rng = np.random.RandomState(1000 + seed)
        toks = rng.randint(0, 512, (tc.B, tc.S + 1))
        patches = _bf16(rng, tc.B, tc.M, tc.D)
        _, ref = tc._ref_grads(w, toks, patches)
        _, got = tc._port_grads(api.params_from_jax(w, "cpu"), toks, patches)
        exact = exact_grads(w, toks, patches)
        row = {"gate port abs": float(abs(got[tc.GATE] - exact[tc.GATE])[0]),
               "gate ref abs": float(abs(ref[tc.GATE] - exact[tc.GATE])[0]),
               "block port~ref": block_drift(w, rng)}
        for name in ref:
            if name == tc.GATE:
                continue
            d = {"port~ref": tc._drift(got[name], ref[name]),
                 "port~exact": tc._drift(got[name], exact[name]),
                 "ref~exact": tc._drift(ref[name], exact[name])}
            d["ratio"] = d["port~exact"] / d["ref~exact"]
            for k, v in d.items():
                row[k] = max(row.get(k, 0.0), v)
        for k, v in row.items():
            worst[k] = max(worst[k], v)
        print(f"draw {seed}: " + ", ".join(f"{k} {v:.4e}"
                                           for k, v in row.items()),
              flush=True)
    print("largest over the draws: " + ", ".join(
        f"{k} {v:.4e}" for k, v in worst.items()))


if __name__ == "__main__":
    main()
