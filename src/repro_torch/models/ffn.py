"""Feed-forward layers: the SwiGLU of the dense blocks, the GELU MLP of
the ``bidir`` and ``selfcross`` blocks (whisper) and the capacity-based
MoE of the ``moe`` block.

The port of ``repro/models/ffn.py``. The GELU is the tanh form, the
default of ``jax.nn.gelu``, and its biases are fp32, added to the bf16
product in fp32 and rounded back to bf16 as the reference does. MoE
dispatch is sort-based, with
static shapes: each token is routed to its top_k experts, the routed
copies are stably sorted by expert id and written into a per-expert
capacity buffer (a copy past an expert's capacity goes to an overflow row
that is dropped, GShard's semantics), the experts run as batched matrix
products, and each token sums its gated expert outputs. The sum runs in
bf16 in ascending expert order, the order in which the reference's
scatter-add meets a token's copies, as a gather and a loop over top_k,
not an atomic scatter-add: the card's sums do not depend on a launch's
timing. Nothing in the layer waits for the card (no ``bincount``, no
data-dependent shape).

Under tensor parallelism (``model``, the mesh's model axis, given when
the caller's weights are this rank's cut of the ff dim) w1 and w3 (the
GELU MLP's w1 and b1) are ``tp.column`` products and the product that
contracts the cut ff dim (w2) is summed over the axis straight after it
(``tp.row``); the GELU MLP's b2, which is whole, is added once after
that sum. In the MoE the
router and the dispatch run whole on every rank, the experts' w1 and w3
take the capacity buffer, and their w2 output is summed straight after
its ``bmm``, before the gates and the bf16 slot sum, where GSPMD puts the
reference's sum.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import dense_init
from repro_torch.sharding import tp


def init_swiglu(gen, d: int, ff: int, *, lead: tuple = (),
                device="cpu") -> dict:
    return {"w1": dense_init(gen, lead + (d, ff), fan_in=d, device=device),
            "w3": dense_init(gen, lead + (d, ff), fan_in=d, device=device),
            "w2": dense_init(gen, lead + (ff, d), fan_in=ff, device=device)}


def swiglu(p: dict, x: torch.Tensor, model=None) -> torch.Tensor:
    h = F.silu(tp.column(tp.MATMUL, x, p["w1"], model)) \
        * tp.column(tp.MATMUL, x, p["w3"], model)
    return tp.row(tp.MATMUL, h, p["w2"], model)


def init_gelu_mlp(gen, d: int, ff: int, *, lead: tuple = (),
                  device="cpu") -> dict:
    """bf16 weights and zero fp32 biases, with ``lead`` (the layer dim)
    in front."""
    return {"w1": dense_init(gen, lead + (d, ff), fan_in=d, device=device),
            "b1": torch.zeros(lead + (ff,), dtype=torch.float32,
                              device=device),
            "w2": dense_init(gen, lead + (ff, d), fan_in=ff, device=device),
            "b2": torch.zeros(lead + (d,), dtype=torch.float32,
                              device=device)}


def gelu_mlp(p: dict, x: torch.Tensor, model=None) -> torch.Tensor:
    """With ``model`` (w1, b1 and w2 cut on ff) b2, which is whole, is
    added once, after the sum over the axis: the one-rank rounding."""
    h = F.gelu((tp.column(tp.MATMUL, x, p["w1"], model) + p["b1"])
               .to(x.dtype), approximate="tanh")
    return (tp.row(tp.MATMUL, h, p["w2"], model) + p["b2"]).to(x.dtype)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def init_moe(gen, d: int, ff: int, n_experts: int, *, lead: tuple = (),
             device="cpu") -> dict:
    """The router (fp32, drawn as bf16 as the reference does) and the
    experts' SwiGLU weights (bf16), with ``lead`` (the layer dim) in
    front."""
    e = n_experts
    return {
        "router": dense_init(gen, lead + (d, e), fan_in=d,
                             device=device).float(),
        "experts": {
            "w1": dense_init(gen, lead + (e, d, ff), fan_in=d, device=device),
            "w3": dense_init(gen, lead + (e, d, ff), fan_in=d, device=device),
            "w2": dense_init(gen, lead + (e, ff, d), fan_in=ff,
                             device=device),
        },
    }


def moe_capacity(n_tokens: int, n_experts: int, top_k: int,
                 capacity_factor: float) -> int:
    """Slots per expert: the routed tokens' fair share times the factor,
    at least 8 and rounded up to a multiple of 8."""
    c = int(n_tokens * top_k / n_experts * capacity_factor)
    return max(8, -(-c // 8) * 8)


def route(router: torch.Tensor, xf: torch.Tensor, top_k: int):
    """xf: (T, d) -> (probs (T, E) fp32, gates (T, k) fp32 normalised over
    the k, expert ids (T, k)), each token's k slots in ascending expert
    id. The router runs in fp32."""
    probs = torch.softmax(xf.float() @ router, dim=-1)
    gates, ids = torch.topk(probs, top_k, dim=-1)
    gates = gates / gates.sum(dim=-1, keepdim=True)
    ids, by_expert = ids.sort(dim=-1)
    return probs, gates.gather(-1, by_expert), ids


def moe_apply(p: dict, x: torch.Tensor, *, top_k: int,
              capacity_factor: float, model=None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B,S,d) -> (y (B,S,d), the Switch load-balance loss E * sum_e
    f_e * mean_prob_e, fp32). ``model`` as in the module's docstring."""
    b, s, d = x.shape
    e = p["router"].shape[-1]
    t = b * s
    xf = x.reshape(t, d)
    probs, gates, ids = route(p["router"], xf, top_k)
    e_flat = ids.reshape(-1)                                 # (T*k,)
    # copies an expert takes (a scatter: bincount would wait for the card)
    counts = torch.zeros(e, dtype=torch.long, device=x.device).scatter_add_(
        0, e_flat, torch.ones_like(e_flat))
    f = counts.float() / (t * top_k)
    aux = e * torch.sum(f * probs.mean(dim=0))

    # sort-based dispatch: the stable sort orders each expert's copies by
    # token, which decides the copies past its capacity
    cap = moe_capacity(t, e, top_k, capacity_factor)
    copy = torch.arange(t * top_k, device=x.device)
    order = torch.argsort(e_flat, stable=True)
    e_s, tok_s = e_flat[order], (copy // top_k)[order]
    start = torch.cumsum(counts, 0) - counts
    rank = copy - start[e_s]
    dest = torch.where(rank < cap, e_s * cap + rank, e * cap)  # overflow row

    buf = x.new_zeros((e * cap + 1, d)).index_put((dest,), xf[tok_s])
    buf = buf[:-1].reshape(e, cap, d)
    w = p["experts"]
    h = F.silu(tp.column(tp.BMM, buf, w["w1"], model)) \
        * tp.column(tp.BMM, buf, w["w3"], model)
    out = tp.row(tp.BMM, h, w["w2"], model).reshape(e * cap, d)
    out = torch.cat([out, out.new_zeros((1, d))])            # dropped: 0
    y_s = out[dest] * gates.reshape(-1)[order][:, None].to(x.dtype)

    # each token's k outputs back in its slot order (ascending expert id),
    # summed in bf16 one slot at a time
    y_tk = y_s[torch.argsort(order)].reshape(t, top_k, d)
    y = y_tk[:, 0]
    for i in range(1, top_k):
        y = y + y_tk[:, i]
    return y.reshape(b, s, d), aux
