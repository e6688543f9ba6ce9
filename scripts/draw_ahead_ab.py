"""What a bigram batch costs on the host, and what drawing it ahead does to
train_mini's step on the card, for two checkouts of the port.

Host part (no card needed): at train_mini's data (vocab 8 192, B = 16,
S = 128), the time of the chain's logits, of their softmax alone, of the
128 ``torch.multinomial`` draws alone, and of ``make_batch`` (the
checkout given by ``--b``), one after another, then with 1, 3 and 6
draws at once on as many threads.

Card part: ``repro_torch.examples.train_mini`` for ``--steps`` steps in
netrpc, in a process of its own for each run: each checkout with its
batches drawn ahead (its ``drawn_ahead``) in the order A B B A, then each
with its batches drawn in line (``drawn_ahead`` replaced by a plain
loop). Each run prints its wall seconds, its median warm step (steps 1
on) and its last loss, which equals across runs where the tokens do.

    python3 scripts/draw_ahead_ab.py --a <checkout> --b <checkout> \\
        [--steps 60] [--device cpu --layers 1]

Prints the card's name and power limit, then one JSON line a
measurement.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

CHILD = """
import json, statistics, sys, time
from repro_torch.examples import train_mini
from repro_torch.launch import train
steps, layers, device, inline = json.loads(sys.argv[1])
if inline:
    train.drawn_ahead = lambda dcfg, run: (
        (s, train.pipeline.make_batch(dcfg, s)) for s in run)
argv = ["--steps", str(steps)] + (["--layers", str(layers)] if layers else [])
t0 = time.perf_counter()
out = train_mini.main(argv, device=device)
wall = time.perf_counter() - t0
print("AB " + json.dumps({"wall_s": wall,
                          "warm_step_s": statistics.median(out["step_s"][1:]),
                          "last_loss": out["losses"][-1]}))
"""


def host_draws(tree: str, reps: int) -> dict:
    """The bigram draw's parts on this host, from ``tree``'s pipeline."""
    sys.path.insert(0, os.path.join(tree, "src"))
    import torch

    from repro_torch.data import pipeline
    dcfg = pipeline.DataConfig(vocab=8192, batch=16, seq_len=128)

    def clock(fn) -> float:
        t = time.perf_counter()
        fn()
        return time.perf_counter() - t

    logits_s = clock(lambda: pipeline.transition_logits(dcfg))
    logits = pipeline.transition_logits(dcfg)
    softmax_s = statistics.median(
        clock(lambda: torch.softmax(logits, dim=-1)) for _ in range(reps))
    probs = torch.softmax(logits, dim=-1)

    def chain():
        gen = torch.Generator().manual_seed(1)
        tok = torch.randint(0, dcfg.vocab, (dcfg.batch,), generator=gen)
        for _ in range(dcfg.seq_len):
            tok = torch.multinomial(probs[tok], 1, generator=gen)[:, 0]
    multinomial_s = statistics.median(clock(chain) for _ in range(reps))
    pipeline.make_batch(dcfg, 0)
    batch_s = statistics.median(
        clock(lambda: pipeline.make_batch(dcfg, s)) for s in range(1, reps + 1))
    at_once = {}
    for n in (1, 3, 6):
        with ThreadPoolExecutor(n) as pool:
            t = time.perf_counter()
            list(pool.map(lambda s: pipeline.make_batch(dcfg, s),
                          range(100, 100 + n)))
            at_once[n] = time.perf_counter() - t
    return {"cpu_count": os.cpu_count(), "torch_threads":
            torch.get_num_threads(), "logits_s": logits_s,
            "softmax_s": softmax_s, "multinomial_s": multinomial_s,
            "make_batch_s": batch_s, "n_at_once_wall_s": at_once}


def run(tree: str, steps: int, layers, device: str, inline: bool) -> dict:
    env = dict(os.environ, PYTHONPATH=os.path.join(tree, "src"))
    p = subprocess.run(
        [sys.executable, "-c", CHILD,
         json.dumps([steps, layers, device, inline])],
        env=env, capture_output=True, text=True, check=False)
    lines = [ln for ln in p.stdout.splitlines() if ln.startswith("AB ")]
    if p.returncode or not lines:
        sys.stderr.write(p.stdout[-4000:] + p.stderr[-4000:])
        raise SystemExit(f"run of {tree} failed ({p.returncode})")
    return json.loads(lines[-1][3:])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--a", required=True, help="checkout A (the parent)")
    ap.add_argument("--b", required=True, help="checkout B (the change)")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip() if args.device != "cpu" else "cpu"
    print(f"card: {smi}", flush=True)
    print("host " + json.dumps(host_draws(args.b, args.reps)), flush=True)
    trees = {"A": args.a, "B": args.b}
    for tag, inline in (("A", False), ("B", False), ("B", False),
                        ("A", False), ("A", True), ("B", True)):
        r = run(trees[tag], args.steps, args.layers, args.device, inline)
        print("run " + json.dumps({"tree": tag, "drawn": "in line" if inline
                                   else "ahead", **r}), flush=True)


if __name__ == "__main__":
    main()
