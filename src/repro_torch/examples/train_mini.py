"""End-to-end driver: train a small member of the qwen2.5 family for a few
hundred steps with the NetRPC (SyncAgtr) gradient path and verify it
learns as well as the fp32 software baseline (the paper's Fig. 6 claim,
as convergence).

    PYTHONPATH=src python -m repro_torch.examples.train_mini [--steps 300] \\
        [--compare] [--layers N] [--device cpu]

Uses a bigram synthetic corpus with a known conditional-entropy floor; the
run prints loss vs floor. --compare reruns with --inc-mode xla-psum and
reports the final-loss gap (should be ~quantization noise). The model
trains on the card (every gradient leaf through the quantize, sat_add and
dequantize kernels in netrpc) unless ``--device cpu``; ``--layers`` cuts
its depth.
"""
import argparse
import sys
from dataclasses import replace

import repro_torch.configs.base as B
from repro_torch.configs.base import get_arch
from repro_torch.kernels.backend import resolve_device
from repro_torch.launch.serve import with_layers
from repro_torch.launch.train import train_loop
from repro_torch.models import api


def hundred_m_config():
    """A small member of the qwen2.5 family: 28 326 400 parameters by
    ``count_params`` (the log line prints the count)."""
    base = get_arch("qwen2.5-3b")
    return replace(
        base, name="qwen2.5-3b", n_layers=8, d_model=512, n_heads=8,
        n_kv_heads=2, head_dim=64, d_ff=1536, vocab=8192,
        pattern_groups=((("global",), 8),), window=256)


def main(argv=None, *, device=None) -> dict:
    """Trains ``mini-100m`` for ``--steps`` steps in ``--inc-mode`` (and in
    xla-psum with ``--compare``); returns the parameter count, each run's
    losses and step seconds, the entropy floor and the final-loss gap
    (None without ``--compare``)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--inc-mode", default="netrpc")
    ap.add_argument("--compare", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to N layers")
    ap.add_argument("--device", default=device,
                    help="cuda (the default) or cpu")
    args = ap.parse_args([] if argv is None else argv)

    # no card and no --device cpu: raise before the registry is touched
    resolve_device(args.device)
    cfg = hundred_m_config()
    if args.layers:
        cfg = with_layers(cfg, args.layers)
    n_params = api.count_params(cfg)
    print(f"model: {n_params / 1e6:.1f}M params")
    # by assignment, so a second run in one process re-registers it
    B._REGISTRY["mini-100m"] = replace(cfg, name="mini-100m")

    out = train_loop(arch="mini-100m", inc_mode=args.inc_mode,
                     steps_n=args.steps, seq=128, batch=16, reduced=False,
                     data_kind="bigram", n_micro=1, device=args.device)
    ls = out["losses"]
    print(f"[{args.inc_mode}] loss {ls[0]:.3f} -> {ls[-1]:.3f} "
          f"(entropy floor {out['entropy_floor']:.3f})")
    result = {"params": n_params, "losses": ls, "step_s": out["step_s"],
              "entropy_floor": out["entropy_floor"], "compare": None,
              "gap": None}
    if args.compare:
        out2 = train_loop(arch="mini-100m", inc_mode="xla-psum",
                          steps_n=args.steps, seq=128, batch=16,
                          reduced=False, data_kind="bigram", n_micro=1,
                          device=args.device)
        gap = abs(ls[-1] - out2["losses"][-1])
        print(f"[xla-psum] final {out2['losses'][-1]:.3f}; "
              f"INC-vs-fp32 gap {gap:.4f}")
        result.update(compare={"losses": out2["losses"],
                               "step_s": out2["step_s"]}, gap=gap)
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
