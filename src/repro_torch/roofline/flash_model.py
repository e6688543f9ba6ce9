"""The work of kernel 11 (``csrc/flash_attn.cu``) and of its backward
kernels (``csrc/flash_attn_bwd.cu``): the port of
``repro/roofline/flash_model.py``.

Two counts of one causal call of the forward, in bf16:

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

The backward (``flash=True`` train steps): ``flash_bwd_work`` is the
floor of the whole gradient, five products over the kept pairs (the
recomputed S, dP, dV, dK and dQ) against the forward's two, so 2.5 times
its operations, and q, k, v, o, dO, lse and delta read once and dq, dk
and dv written once: the bound of a backward done in one call, such as
the yardstick chip_smoke.py times beside the kernels
(scaled_dot_product_attention's). ``bwd_kernel_work`` is each of the three kernels'
own floor, what its meta lane records: (a) delta reads o and dO and
writes delta; (b) dK/dV does four products (S, dP, dV, dK) and reads q,
k, v, dO, lse and delta; (c) dQ does three (S, dP, dQ) and reads the same.

``flash_traffic_bytes`` counts the bytes a step moves through the kernels
over the layers that route through kernel 11 (``flashed_layers``: every
``global``, ``moe`` and ``selfcross`` layer, and a ``local`` one only
when the sequence is longer than its window). A prefill takes the
forward's tile model. A train step takes each microbatch's forward, the
checkpoint's recomputed forward and the three backward kernels, each at
its meta record (``flash_work`` for a forward, ``bwd_kernel_work``), so
it equals the bytes of the dry run's kernel records; it replaces the
reference's ``TRAIN_FACTOR`` of 4.5 forwards. A decode step has none.

``dkdv_split`` is how backward kernel (b) splits a KV head's group of
query heads over a thread block cluster: the wrapper passes it to the
kernel, which never derives it.
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
    return (4 * d * b * h * kept_pairs(s, window),
            2 * b * s * (2 * h + 2 * kv) * d)


def kept_pairs(s, window, causal: bool = True) -> int:
    """(q, k) pairs a row of heads keeps: 0 <= qpos - kpos < window, or
    every pair when not causal."""
    if not causal:
        return s * s
    w = s if window is None else min(window, s)
    return w * (w + 1) // 2 + (s - w) * w


def flash_bwd_work(b, h, kv, s, d, window) -> tuple[int, int]:
    """(operations, bytes) of the whole causal backward: five products
    over the kept pairs (2.5 times ``flash_work``'s two); q, o, dO and dq
    (B, S, H, D) and k, v, dk and dv (B, S, KV, D) in bf16, lse and delta
    (B, H, S) in fp32, each read or written once."""
    ops = 10 * d * b * h * kept_pairs(s, window)
    return ops, BYTES * b * s * d * (4 * h + 4 * kv) + 2 * 4 * b * h * s


BWD_KERNELS = ("flash_bwd_delta", "flash_bwd_dkdv", "flash_bwd_dq")
MAX_CLUSTER = 8          # CTAs a cluster of (b): the portable most


def dkdv_split(h: int, kv: int) -> tuple[int, int]:
    """(cluster, heads_per_cta) of kernel (b) for ``h`` query heads on
    ``kv`` KV heads: the cluster is the largest divisor of the group
    (h / kv) up to MAX_CLUSTER, and each of its CTAs walks group / cluster
    query heads of the group."""
    if kv < 1 or h % kv:
        raise ValueError(f"dkdv_split: {h} query heads on {kv} KV heads")
    group = h // kv
    cluster = max(c for c in range(1, min(group, MAX_CLUSTER) + 1)
                  if group % c == 0)
    return cluster, group // cluster


def bwd_kernel_work(name, b, h, kv, s, d, window,
                    causal: bool = True) -> tuple[int, int]:
    """(operations, bytes) of one launch of backward kernel ``name``:
    each input read once and each output written once."""
    q_b = BYTES * b * s * h * d          # q, o, dO or dq
    kv_b = BYTES * b * s * kv * d        # k, v, dk or dv
    row_b = 4 * b * h * s                # lse or delta
    pairs = kept_pairs(s, window, causal)
    if name == "flash_bwd_delta":
        return 2 * b * s * h * d, 2 * q_b + row_b
    if name == "flash_bwd_dkdv":         # S, dP, dV, dK
        return 8 * d * b * h * pairs, 2 * q_b + 4 * kv_b + 2 * row_b
    if name == "flash_bwd_dq":           # S, dP, dQ
        return 6 * d * b * h * pairs, 3 * q_b + 2 * kv_b + 2 * row_b
    raise ValueError(f"no backward kernel {name!r}")


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


def train_call_bytes(b, h, kv, s, d, window) -> int:
    """Bytes one flashed layer of one train microbatch records: the
    forward, the checkpoint's recomputed forward and the three backward
    kernels."""
    return (2 * flash_work(b, h, kv, s, d, window)[1]
            + sum(bwd_kernel_work(n, b, h, kv, s, d, window)[1]
                  for n in BWD_KERNELS))


def flash_traffic_bytes(cfg: ArchConfig, shape: ShapeConfig, *,
                        n_dp: int, n_model: int, n_micro: int = 1) -> float:
    """Per-rank HBM bytes a step moves through the flash kernels, at a
    rank's batch rows (a train step's in ``n_micro`` microbatches) and its
    query and KV heads over "model": a prefill's by kernel 11's tiles, a
    train step's as its kernels' records (``train_call_bytes``)."""
    n_full, n_local = flashed_layers(cfg, shape.seq_len)
    if n_full + n_local == 0 or shape.kind not in ("prefill", "train"):
        return 0.0
    b = max(shape.global_batch // n_dp, 1)
    h = cfg.n_heads if cfg.n_heads % n_model else cfg.n_heads // n_model
    kv = tp.kv_heads(cfg.n_heads, cfg.n_kv_heads, n_model, 0)[1]
    s, d = shape.seq_len, cfg.hd
    if shape.kind == "train":
        mb = max(b // n_micro, 1)
        return float(n_micro * (
            n_full * train_call_bytes(mb, h, kv, s, d, None)
            + n_local * train_call_bytes(mb, h, kv, s, d, cfg.window)))
    return float(n_full * call_traffic_bytes(b, h, kv, s, d, None)
                 + n_local * call_traffic_bytes(b, h, kv, s, d, cfg.window))
