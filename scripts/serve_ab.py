"""Prefill and decode rates of two checkouts of the port, side by side on
one card.

Each model of a serve phase of ``chip_smoke.py`` (the same arch, prompt,
batch and 32 decode steps at full width) runs through
``repro_torch.launch.serve.serve`` in a process of its own for each
checkout, in the order A B B A (``--order``): a drift of the host
between runs shows as the difference between the two A runs. A process serves twice from the
same weights and keeps the second run (the first pays the libraries'
warm-up and the kernels' build).

    python3 scripts/serve_ab.py --a <checkout> --b <checkout> [--phases ilmno]

Prints the card's name and power limit, one JSON line a run, then one a
phase with each checkout's rates and their medians. Needs one CUDA card
(``--device cpu --reduced`` runs the reduced models on the CPU, to check
the script).
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

# phase -> (arch, prompt, batch, layers), as chip_smoke.SERVES
PHASES = {
    "i": ("qwen2.5-3b", 2048, 4, None),
    "l": ("gemma3-27b", 2048, 4, None),
    "m": ("recurrentgemma-9b", 4096, 2, None),
    "n": ("moonshot-v1-16b-a3b", 2048, 4, None),
    "o": ("mamba2-780m", 4096, 4, None),
    "p": ("whisper-medium", 416, 4, None),
    "q": ("llama-3.2-vision-90b", 2048, 4, 10),
}
DECODE = 32

CHILD = """
import json, sys
from repro_torch.launch import serve as s
from repro_torch.models import api
arch, prompt, batch, layers, decode, device, reduced = json.loads(sys.argv[1])
params = api.init_params(0, s.model_config(arch, reduced, layers),
                         device=device)
runs = [s.serve(arch=arch, prompt_len=prompt, decode_n=decode, batch=batch,
                layers=layers, params=params, device=device, reduced=reduced)
        for _ in range(2)]
r = runs[-1]
print("AB " + json.dumps({"prefill_s": r["prefill_s"],
                          "decode_s": r["decode_s"],
                          "decode_tokens_per_s": decode * batch / r["decode_s"]}))
"""


def run(tree: str, phase: str, device: str, reduced: bool) -> dict:
    arch, prompt, batch, layers = PHASES[phase]
    if reduced:
        prompt = min(prompt, 64)
    env = dict(os.environ, PYTHONPATH=os.path.join(tree, "src"))
    out = subprocess.run(
        [sys.executable, "-c", CHILD,
         json.dumps([arch, prompt, batch, layers, DECODE, device, reduced])],
        cwd=tree, env=env, capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        raise RuntimeError(f"{tree} phase {phase}: {out.stderr[-2000:]}")
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("AB ")][-1]
    return json.loads(line[3:])


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--a", required=True, help="the first checkout")
    ap.add_argument("--b", required=True, help="the second checkout")
    ap.add_argument("--phases", default="ilmno")
    ap.add_argument("--order", default="abba",
                    help="the checkouts' runs a phase, in turn")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true")
    args = ap.parse_args()
    trees = {"a": os.path.abspath(args.a), "b": os.path.abspath(args.b)}
    if args.device == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True).stdout.strip(), flush=True)
    for phase in args.phases:
        got = {"a": [], "b": []}
        for which in args.order:
            r = run(trees[which], phase, args.device, args.reduced)
            got[which].append(r)
            print(json.dumps({"phase": phase, "tree": which, **r}),
                  flush=True)
        print(json.dumps({"phase": phase, "arch": PHASES[phase][0], **{
            f"{which}_{key}": [r[key] for r in got[which]]
            + [statistics.median(r[key] for r in got[which])]
            for which in "ab" for key in ("prefill_s",
                                           "decode_tokens_per_s")}}),
            flush=True)


if __name__ == "__main__":
    main()
