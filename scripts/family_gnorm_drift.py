"""The drift behind the gradient-norm bounds of
tests/test_torch_train_families.py, on the CPU: each family's reduced
config (the test's batch of 4 x 64 uniform tokens, with its frames or
patches, llama's cross gates at the test's 0.5) for ``--draws`` weight
and token draws.

For each draw it takes the norm of the gradient of ``train_loss`` (the
step's clip norm before aggregation: one rank, the microbatches summed)
three ways: the port in bf16, the reference in bf16 (jitted, as its step
is) and the reference with every bf16 leaf, input and product in fp32
(``COMPUTE_DTYPE`` patched: the exact norm, up to fp32). It prints the
port against the reference, each against the exact norm, and the loss
and largest leaf of the port against the reference in fp32 (the same
math: rounding taken out). The bf16 norms of both packages lie about as
far from the exact one as from each other: a port-vs-reference bound
below the reference's own drift holds rounding, not the port.

    JAX_PLATFORMS=cpu PYTHONPATH=src:tests python scripts/family_gnorm_drift.py --draws 5

About 20 s an arch and 2 s a draw.
"""
from __future__ import annotations

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jget
from repro.data import pipeline as jpipeline
from repro.models import api as japi
from repro_torch.configs.base import get_arch
from repro_torch.models import api

ARCHS = ("qwen2.5-3b", "mamba2-780m", "gemma3-27b", "recurrentgemma-9b",
         "moonshot-v1-16b-a3b", "llama-3.2-vision-90b", "whisper-medium")
BATCH, SEQ, GATE = 4, 64, 0.5


def _norm(grads: dict) -> float:
    return float(np.sqrt(sum(np.sum(g.astype(np.float64) ** 2)
                             for g in grads.values())))


def _flat(tree) -> dict:
    return {n: t.detach().double().numpy()
            for n, t in api.named_leaves(tree)}


def reference(arch: str, fp32: bool):
    """The reference's jitted (loss, grads) of the reduced ``arch``, in
    bf16 or with COMPUTE_DTYPE fp32 (traced under the patch)."""
    jcfg = jget(arch).reduced()
    dtype = jnp.float32 if fp32 else japi.COMPUTE_DTYPE

    def loss(p, batch):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(japi, "COMPUTE_DTYPE", dtype)
            return japi.train_loss(p, jcfg, batch)[0]
    return jax.jit(jax.value_and_grad(loss))


def port(arch: str, params: dict, batch: dict, fp32: bool):
    cfg = get_arch(arch).reduced()
    tree = api.params_from_jax(
        jax.tree.map(lambda a: np.asarray(a, np.float32), params) if fp32
        else params, "cpu")
    for t in tree.parameters():
        t.requires_grad_(True)
    tb = {k: api._tensor(np.asarray(v, np.float32) if fp32 and k != "tokens"
                         else v, torch.device("cpu")) for k, v in batch.items()}
    with pytest.MonkeyPatch.context() as mp:
        if fp32:
            mp.setattr(api, "COMPUTE_DTYPE", torch.float32)
        loss, _ = api.train_loss(tree, cfg, tb)
    loss.backward()
    return float(loss), {n: t.grad.double().numpy()
                         for n, t in api.named_leaves(tree)}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--draws", type=int, default=5)
    ap.add_argument("--archs", nargs="*", default=ARCHS)
    args = ap.parse_args()
    for arch in args.archs:
        jcfg = jget(arch).reduced()
        fns = {fp32: reference(arch, fp32) for fp32 in (False, True)}
        rows = []
        for seed in range(args.draws):
            params = jax.tree.map(np.asarray, japi.init_params(
                jax.random.key(seed), jcfg))
            for gi, (pat, _) in enumerate(jcfg.pattern_groups):
                for i, bt in enumerate(pat):
                    if bt == "cross":       # the test's gate: 0 passes none
                        slot = params["groups"][gi][f"s{i}"]
                        slot["gate"] = np.full_like(slot["gate"], GATE)
            dcfg = jpipeline.DataConfig(vocab=jcfg.vocab, batch=BATCH,
                                        seq_len=SEQ, seed=seed,
                                        kind="uniform")
            batch = {k: np.asarray(v) for k, v in
                     jpipeline.add_modality_stubs(jpipeline.make_batch(
                         dcfg, 0), jcfg, BATCH, seed=seed).items()}
            exact = {}
            for fp32 in (False, True):
                p = (jax.tree.map(lambda a: np.asarray(a, np.float32),
                                  params) if fp32 else params)
                jb = {k: (jnp.asarray(v, jnp.float32) if fp32 and k != "tokens"
                          else jnp.asarray(v)) for k, v in batch.items()}
                loss, g = fns[fp32](p, jb)
                exact[fp32] = (float(loss), _flat(api.params_from_jax(
                    jax.tree.map(np.asarray, g), "cpu")))
            p16 = port(arch, params, batch, False)
            p32 = port(arch, params, batch, True)
            n = {k: _norm(v[1]) for k, v in (("port", p16),
                                             ("ref", exact[False]),
                                             ("exact", exact[True]),
                                             ("port32", p32))}
            leaf32 = max(np.linalg.norm(p32[1][k] - exact[True][1][k])
                         / max(np.linalg.norm(exact[True][1][k]), 1e-30)
                         for k in exact[True][1])
            rows.append((abs(n["port"] / n["ref"] - 1),
                         abs(n["ref"] / n["exact"] - 1),
                         abs(n["port"] / n["exact"] - 1),
                         abs(p32[0] / exact[True][0] - 1), leaf32))
            print(f"{arch} draw {seed}: gnorm port vs reference "
                  f"{rows[-1][0]:.3e}; reference vs exact {rows[-1][1]:.3e};"
                  f" port vs exact {rows[-1][2]:.3e}; in fp32 loss "
                  f"{rows[-1][3]:.2e}, worst leaf {rows[-1][4]:.2e}",
                  flush=True)
        worst = np.max(np.array(rows), axis=0)
        print(f"{arch} over {args.draws} draws, largest: gnorm port vs "
              f"reference {worst[0]:.3e}, reference vs exact {worst[1]:.3e}, "
              f"port vs exact {worst[2]:.3e}; fp32 loss {worst[3]:.2e}, "
              f"leaf {worst[4]:.2e}", flush=True)


if __name__ == "__main__":
    main()
