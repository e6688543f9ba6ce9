"""RG-LRU temporal-mixing block (Griffin / RecurrentGemma, arXiv:2402.19427).

h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t),
a_t = exp(-c * softplus(Lambda) * r_t),  r/i input-dependent sigmoid gates.

The port of ``repro/models/rglru.py``. Training and prefill run the linear
recurrence as a log-depth scan over the sequence (Hillis-Steele doubling:
log2(S) rounds of whole-tensor operations, where the reference calls
``jax.lax.associative_scan``); its fp32 sums associate differently from
XLA's, so ``h`` matches the reference within fp32 rounding, not bit for
bit. Decode is the O(1) single-step recurrence. The r/i gate projections
are block-diagonal, as in Griffin.

Dtypes follow the reference: ``w_in_a``, ``w_in_b``, ``wr``, ``wi`` and
``w_out`` are bf16; ``conv_w``, ``conv_b``, ``br``, ``bi`` and ``lam``
fp32; the gates, the recurrence and its state are fp32.

Under tensor parallelism (``model``, the mesh's model axis, given when
the caller's leaves are this rank's cut of the RG-LRU width) w_in_a and
w_in_b are ``tp.column`` products and w_out's output is summed over the
axis (``tp.row``); the conv, the gates' blocks and the scan run on the
rank's channels with no collective. The decode cache's conv tail stays
whole, as the reference's: a decode step gathers the new input's
channels over the axis before the window and convolves the rank's.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import compat
from repro_torch.models.common import dense_init, draw
from repro_torch.models.ssm import causal_conv1d, conv1d_step
from repro_torch.sharding import tp

_C = 8.0
N_GATE_BLOCKS = 16


def init_rglru(gen, d_model: int, rnn_width: int, d_conv: int = 4, *,
               lead: tuple = (), device="cpu") -> dict:
    """One mixer's parameters, every leaf with ``lead`` (the layer dim) in
    front."""
    u = 0.9 + 0.099 * draw(gen, lead + (rnn_width,), device, torch.rand)
    # Lambda chosen so a = u at r = 1 (softplus^-1 of -log(u)/c)
    lam = torch.log(torch.expm1(-torch.log(u) / _C))
    nb = N_GATE_BLOCKS if rnn_width % N_GATE_BLOCKS == 0 else 1
    c = rnn_width // nb

    def bd():
        return (draw(gen, lead + (nb, c, c), device, torch.randn)
                * (c ** -0.5)).to(torch.bfloat16)

    def zeros():
        return torch.zeros(lead + (rnn_width,), dtype=torch.float32,
                           device=device)
    return {
        "w_in_a": dense_init(gen, lead + (d_model, rnn_width),
                             fan_in=d_model, device=device),
        "w_in_b": dense_init(gen, lead + (d_model, rnn_width),
                             fan_in=d_model, device=device),
        "conv_w": draw(gen, lead + (d_conv, rnn_width), device,
                        torch.randn) * (d_conv ** -0.5),
        "conv_b": zeros(),
        "wr": bd(),
        "br": zeros(),
        "wi": bd(),
        "bi": zeros(),
        "lam": lam,
        "w_out": dense_init(gen, lead + (rnn_width, d_model),
                            fan_in=rnn_width, device=device),
    }


def _block_diag(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (..., rnn), w: (nb, c, c) block-diagonal -> (..., rnn), in x's
    dtype (bf16 x bf16 here)."""
    nb, c, _ = w.shape
    xb = x.reshape(*x.shape[:-1], nb, c)
    y = torch.einsum("...nc,ncd->...nd", xb, w)
    return y.reshape(x.shape)


def _gates(p: dict, xa: torch.Tensor):
    """(a, gated): the recurrence's decay and input, fp32."""
    r = torch.sigmoid(_block_diag(xa, p["wr"]).float() + p["br"])
    i = torch.sigmoid(_block_diag(xa, p["wi"]).float() + p["bi"])
    log_a = -_C * F.softplus(p["lam"]) * r
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    gated = beta * i * xa.float()
    return a, gated


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t from h_{-1} = 0, over dim 1, in log2(S)
    rounds: after the round of stride d, (a_t, b_t) compose the steps
    t-2d+1..t. Out of place, so autograd can run through it."""
    s, d = a.shape[1], 1
    while d < s:
        b = torch.cat([b[:, :d], b[:, d:] + a[:, d:] * b[:, :-d]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def rglru_train(p: dict, x: torch.Tensor, model=None):
    """x: (B,S,d_model) -> (y (B,S,d_model), final_state (B,rnn) fp32,
    conv_tail (B,K-1,rnn)): the tail is the pre-conv inputs of the last
    K-1 positions, the decode conv window's start. With ``model`` the
    state and the tail are this rank's channels."""
    xin = tp.column(tp.MATMUL, x, p["w_in_a"], model)
    xa = F.silu(causal_conv1d(xin, p["conv_w"], p["conv_b"])).to(x.dtype)
    a, gated = _gates(p, xa)
    h = linear_scan(a, gated)
    xb = F.gelu(tp.column(tp.MATMUL, x, p["w_in_b"], model).float(),
                approximate="tanh")
    y = tp.row(tp.MATMUL, (h * xb).to(x.dtype), p["w_out"], model)
    k = p["conv_w"].shape[0]
    return y, h[:, -1, :], xin[:, -(k - 1):, :]


def rglru_decode(p: dict, x1: torch.Tensor, state: torch.Tensor,
                 conv_state: torch.Tensor, model=None):
    """x1: (B,1,d_model); state: (B,rnn) fp32; conv_state: (B,K-1,rnn).
    Returns (y (B,1,d_model), new state, new conv_state), new tensors.
    With ``model`` the state is this rank's channels and the conv tail
    whole."""
    xa_in = tp.gather_model(
        tp.column(tp.MATMUL, x1, p["w_in_a"], model)[:, 0], -1, model)
    window = torch.cat([conv_state, xa_in[:, None, :].to(conv_state.dtype)],
                       dim=1)
    mine = window
    if tp.active(model) is not None:
        c = state.shape[-1]
        mine = window.narrow(-1, compat.axis_index(model) * c, c)
    xa = F.silu(conv1d_step(mine, p["conv_w"], p["conv_b"])).to(x1.dtype)
    conv_state = window[:, 1:]
    a, gated = _gates(p, xa)
    state = a * state + gated
    xb = F.gelu(tp.column(tp.MATMUL, x1[:, 0], p["w_in_b"], model).float(),
                approximate="tanh")
    y = tp.row(tp.MATMUL, (state * xb).to(x1.dtype), p["w_out"], model)
    return y[:, None, :], state, conv_state
