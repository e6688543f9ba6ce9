"""The work of kernel 11 (``csrc/flash_attn.cu``): the port of
``repro/roofline/flash_model.py``.

Two counts of one causal call, in bf16:

  - ``flash_work``: the floor, the two products over the (q, k) pairs the
    mask keeps, and q, k, v read once and out written once. It is what
    PERF.md's bound for kernel 11 divides by the card's rates, and what
    the kernel's meta lane records (``kernels/flash_attn.py``).
  - ``call_traffic_bytes``: the kernel's HBM traffic with its tiles. A
    CTA takes BM = 128 query rows of one (batch, head) and streams the
    K and V tiles of BN keys (128, or 64 at D = 256) that its rows can
    see: from the first tile inside the window to the diagonal tile.
    Each query head reads its KV head's tiles itself (K and V are never
    broadcast over a group), so the tiles are re-read once a q tile and
    a query head. It is an upper bound: the L2 keeps some of them.

``flash_traffic_bytes`` sums the second over the layers that a prefill
routes through the kernel (``flashed_layers``: every ``global``, ``moe``
and ``selfcross`` layer, and a ``local`` one only when the prompt is
longer than its window). The port trains through the plain attention
(the kernel has no backward), so a train step and a decode step have
none, and there is no train factor.
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.sharding import tp

BM = 128                 # q rows a CTA (csrc/flash_attn.cu: BM)
BYTES = 2                # bf16


def block_n(d: int) -> int:
    """Keys a K/V tile (csrc/flash_attn.cu: Tile<D>::BN)."""
    return 64 if d == 256 else 128


def flash_work(b, h, kv, s, d, window) -> tuple[int, int]:
    """(operations, bytes) of one causal call: two products over the
    (q, k) pairs with 0 <= qpos - kpos < window; q, k, v read once and out
    written once, in bf16."""
    w = s if window is None else min(window, s)
    pairs = w * (w + 1) // 2 + (s - w) * w
    return 4 * d * b * h * pairs, 2 * b * s * (2 * h + 2 * kv) * d


def call_traffic_bytes(b, h, kv, s, d, window) -> int:
    """HBM bytes one causal call moves with the kernel's tiles: q read and
    out written once, and for each (batch, query head, q tile) the K and V
    rows of every key tile from the window's first to the diagonal one."""
    bn = block_n(d)
    rows = 0
    for i in range(-(-s // BM)):
        last = min((i + 1) * BM, s) - 1          # the tile's last q row
        first = 0 if window is None else max(0, i * BM - window + 1)
        for j in range(first // bn, last // bn + 1):
            rows += min((j + 1) * bn, s) - j * bn
    return BYTES * b * h * d * (2 * s + 2 * rows)


def flashed_layers(cfg: ArchConfig, seq_len: int) -> tuple[int, int]:
    """(full-context, sliding-window) layers whose prefill at ``seq_len``
    tokens takes kernel 11: a ``local`` layer only past its window."""
    n_full = n_local = 0
    for pat, r in cfg.pattern_groups:
        for bt in pat:
            if bt in ("global", "moe", "selfcross"):
                n_full += r
            elif bt == "local" and seq_len > cfg.window:
                n_local += r
    return n_full, n_local


def flash_traffic_bytes(cfg: ArchConfig, shape: ShapeConfig, *,
                        n_dp: int, n_model: int) -> float:
    """Per-rank HBM bytes a step moves through kernel 11 (its tiles), at
    a rank's batch rows and its query and KV heads over "model"."""
    n_full, n_local = flashed_layers(cfg, shape.seq_len)
    if n_full + n_local == 0 or shape.kind != "prefill":
        return 0.0
    b = max(shape.global_batch // n_dp, 1)
    h = cfg.n_heads if cfg.n_heads % n_model else cfg.n_heads // n_model
    kv = tp.kv_heads(cfg.n_heads, cfg.n_kv_heads, n_model, 0)[1]
    s, d = shape.seq_len, cfg.hd
    return float(n_full * call_traffic_bytes(b, h, kv, s, d, None)
                 + n_local * call_traffic_bytes(b, h, kv, s, d, cfg.window))
