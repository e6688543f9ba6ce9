"""Mamba-2 mixer with the SSD (state-space duality) chunked algorithm,
and the causal depthwise convolution it shares with the RG-LRU mixer.

The port of ``repro/models/ssm.py`` (the minimal SSD formulation of
arXiv:2405.21060): the sequence is split into chunks; the within-chunk
terms are masked, decay-weighted matrix products (the "dual" attention
form), and the chunk states pass through a sequential recurrence, a
Python loop over the chunks where the reference calls ``lax.scan``. All
decay arithmetic is fp32. The input projection keeps one leaf per
component (z, x, B, C, dt), as the reference stores it.

Decode is the recurrent form: an O(1) state update a token,
h <- exp(dt*A) h + dt * x B^T, y = C h + D x. ``causal_conv1d`` and
``conv1d_step`` compute in fp32; ``models/rglru.py`` uses them too.

Under tensor parallelism (``model``, the mesh's model axis, given when
the caller's leaves are this rank's cut of the heads and ``d_inner``)
each rank runs the SSD of its own heads: w_z, w_x and w_dt are
``tp.column`` products and w_out's output is summed over the axis
(``tp.row``); w_B and w_C and their convs stay whole, and B and C enter
the rank's heads through ``tp.to_model``, so their gradients are whole
on every rank. The gated RMS norm runs over the rank's columns of
``d_inner``: its sum of squares is summed over the axis both ways
(``tp.sum_model``) and divided by the whole ``d_inner``. The decode
cache's conv tail (x|B|C) stays whole, as the reference's: a decode step
gathers the new x columns over the axis before the window and convolves
the rank's.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import compat
from repro_torch.models.common import dense_init, draw, rms_norm
from repro_torch.sharding import tp

SSD_CHUNK = 256


def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x: (B,S,C), w: (K,C) -> (B,S,C), fp32. The
    K terms are summed in the reference's order (tap 0 first)."""
    k, s = w.shape[0], x.shape[1]
    xp = F.pad(x.float(), (0, 0, k - 1, 0))
    y = w[0] * xp[:, 0:s]
    for j in range(1, k):
        y = y + w[j] * xp[:, j:j + s]
    return y + b


def conv1d_step(window: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """window: (B,K,C) (oldest first, newest = current input) -> (B,C)."""
    return torch.einsum("bkc,kc->bc", window.float(), w) + b


# ---------------------------------------------------------------------------
# Mamba-2
# ---------------------------------------------------------------------------

def init_mamba2(gen, d_model: int, n_heads: int, head_dim: int,
                d_state: int, d_conv: int, *, lead: tuple = (),
                device="cpu") -> dict:
    """One mixer's parameters, every leaf with ``lead`` (the layer dim) in
    front: the projections bf16, the conv taps N(0, 1/K) and the rest fp32
    (A = -exp(A_log) = -1, D = 1, zero biases and norm scale)."""
    d_inner = n_heads * head_dim

    def proj(n_in, n_out):
        return dense_init(gen, lead + (n_in, n_out), fan_in=n_in,
                          device=device)

    def taps(c):
        return draw(gen, lead + (d_conv, c), device, torch.randn) \
            * (d_conv ** -0.5)

    def const(n, value):
        return torch.full(lead + (n,), value, dtype=torch.float32,
                          device=device)
    return {
        "w_z": proj(d_model, d_inner),
        "w_x": proj(d_model, d_inner),
        "w_B": proj(d_model, d_state),
        "w_C": proj(d_model, d_state),
        "w_dt": proj(d_model, n_heads),
        "conv_x": taps(d_inner),
        "conv_B": taps(d_state),
        "conv_C": taps(d_state),
        "conv_bx": const(d_inner, 0.0),
        "conv_bB": const(d_state, 0.0),
        "conv_bC": const(d_state, 0.0),
        "dt_bias": const(n_heads, 0.0),
        "A_log": const(n_heads, 0.0),
        "D": const(n_heads, 1.0),
        "norm": const(d_inner, 0.0),
        "w_out": proj(d_inner, d_model),
    }


def ssd_chunked(x_h: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                bmat: torch.Tensor, cmat: torch.Tensor, chunk: int):
    """SSD over chunks of ``min(chunk, S)`` positions, which must divide S.

    x_h: (B,S,H,P) values; dt: (B,S,H) fp32 step sizes; a: (H,) negative;
    bmat/cmat: (B,S,N), one group shared by the heads. Returns (y
    (B,S,H,P) fp32, the final state (B,H,P,N) fp32)."""
    b, s, h, p = x_h.shape
    n = bmat.shape[-1]
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"SSD: a sequence of {s} positions is not a "
                         f"multiple of the chunk of {chunk}")
    nc = s // chunk

    x_dt = (x_h.float() * dt[..., None]).reshape(b, nc, chunk, h, p)
    adt = (a * dt).reshape(b, nc, chunk, h)                  # <= 0
    cums = torch.cumsum(adt, dim=2)                          # (b,c,l,h)
    b_c = bmat.float().reshape(b, nc, chunk, n)
    c_c = cmat.float().reshape(b, nc, chunk, n)

    # within-chunk ("attention-like") term
    cb = torch.einsum("bcln,bcsn->bcls", c_c, b_c)           # (b,c,l,l)
    ct = cums.movedim(-1, 2)                                 # (b,c,h,l)
    diff = ct[..., :, None] - ct[..., None, :]               # (b,c,h,l,l)
    li = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                               device=x_h.device))
    # masked before the exp (the reference takes where(li, exp(diff), 0)):
    # above the diagonal diff passes 88 on a long chunk, and exp's inf
    # there gives a NaN gradient through a where; exp(-inf) is 0
    decay = torch.exp(diff.masked_fill(~li, -torch.inf))
    y_diag = torch.einsum("bchls,bcls,bcshp->bclhp", decay, cb, x_dt)

    # chunk states, then the sequential inter-chunk recurrence, which
    # hands each chunk the state from before it
    decay_states = torch.exp(cums[:, :, -1:, :] - cums)      # (b,c,l,h)
    states = torch.einsum("bcln,bclh,bclhp->bchpn", b_c, decay_states,
                          x_dt)
    chunk_decay = torch.exp(cums[:, :, -1, :])               # (b,c,h)
    state = torch.zeros((b, h, p, n), dtype=torch.float32,
                        device=x_h.device)
    before = []
    for c in range(nc):
        before.append(state)
        state = state * chunk_decay[:, c, :, None, None] + states[:, c]
    states_prev = torch.stack(before, dim=1)                 # (b,c,h,p,n)

    out_decay = torch.exp(cums)                              # (b,c,l,h)
    y_off = torch.einsum("bcln,bchpn,bclh->bclhp", c_c, states_prev,
                         out_decay)
    return (y_diag + y_off).reshape(b, s, h, p), state


def _project(p: dict, x: torch.Tensor, model=None):
    def cut(w):
        return tp.column(tp.MATMUL, x, p[w], model)
    return cut("w_z"), cut("w_x"), x @ p["w_B"], x @ p["w_C"], cut("w_dt")


def _gated_norm(y: torch.Tensor, scale: torch.Tensor, eps: float,
                model=None) -> torch.Tensor:
    """``rms_norm`` of (B, S, d_inner); with ``model`` over the rank's
    columns of ``d_inner``, the fp32 sum of squares summed over the axis
    and divided by the whole width."""
    if tp.active(model) is None:
        return rms_norm(y, scale, eps)
    x32 = y.float()
    ss = tp.sum_model(x32.square().sum(dim=-1, keepdim=True), model)
    var = ss / (y.shape[-1] * compat.axis_size(model))
    return (x32 * torch.rsqrt(var + eps) * (1.0 + scale.float())
            ).to(y.dtype)


def mamba2_train(p: dict, x: torch.Tensor, *, n_heads: int, head_dim: int,
                 d_state: int, norm_eps: float, chunk: int = SSD_CHUNK,
                 model=None):
    """x: (B,S,d_model) -> (y (B,S,d_model), final state (B,H,P,N) fp32,
    conv tail (B,K-1,d_inner+2N)): the tail is the pre-conv x|B|C inputs
    of the last K-1 positions, the decode conv window's start. With
    ``model``, ``n_heads`` is the rank's count, and the state and the
    tail's x columns are the rank's."""
    d_inner = n_heads * head_dim
    z, xc_in, b_in, c_in, dt = _project(p, x, model)
    xc = F.silu(causal_conv1d(xc_in, p["conv_x"], p["conv_bx"]))
    bmat = tp.to_model(F.silu(causal_conv1d(b_in, p["conv_B"],
                                            p["conv_bB"])), model)
    cmat = tp.to_model(F.silu(causal_conv1d(c_in, p["conv_C"],
                                            p["conv_bC"])), model)
    dtp = F.softplus(dt.float() + p["dt_bias"])
    a = -torch.exp(p["A_log"])
    x_h = xc.reshape(*xc.shape[:2], n_heads, head_dim)
    y, final = ssd_chunked(x_h, dtp, a, bmat, cmat, chunk)
    y = y + p["D"][None, None, :, None] * x_h
    y = y.reshape(*x.shape[:2], d_inner).to(x.dtype)
    y = _gated_norm(y * F.silu(z), p["norm"], norm_eps, model)
    k = p["conv_x"].shape[0]
    conv_tail = torch.cat([xc_in, b_in, c_in], dim=-1)[:, -(k - 1):, :]
    return tp.row(tp.MATMUL, y, p["w_out"], model), final, conv_tail


def mamba2_decode(p: dict, x1: torch.Tensor, ssm_state: torch.Tensor,
                  conv_state: torch.Tensor, *, n_heads: int, head_dim: int,
                  d_state: int, norm_eps: float, model=None):
    """x1: (B,1,d_model); ssm_state: (B,H,P,N) fp32; conv_state:
    (B,K-1,d_inner+2N), the pre-conv x|B|C inputs. Returns (y
    (B,1,d_model), new state, new conv_state), new tensors. With
    ``model``, ``n_heads`` and the state are the rank's and the conv
    tail is whole."""
    d_inner = n_heads * head_dim
    z, xc_in, b_in, c_in, dt = _project(p, x1[:, 0], model)
    new_in = torch.cat([tp.gather_model(xc_in, -1, model), b_in, c_in],
                       dim=-1)
    window = torch.cat([conv_state, new_in[:, None, :].to(conv_state.dtype)],
                       dim=1)
    conv_state = window[:, 1:]
    whole = window.shape[-1] - 2 * d_state
    first = 0 if tp.active(model) is None else \
        compat.axis_index(model) * d_inner
    wx = window[..., first:first + d_inner]
    wb = window[..., whole:whole + d_state]
    wc = window[..., whole + d_state:]
    xc = F.silu(conv1d_step(wx, p["conv_x"], p["conv_bx"]))
    bvec = F.silu(conv1d_step(wb, p["conv_B"], p["conv_bB"]))
    cvec = F.silu(conv1d_step(wc, p["conv_C"], p["conv_bC"]))
    dtp = F.softplus(dt.float() + p["dt_bias"])                  # (B,H)
    a = -torch.exp(p["A_log"])
    da = torch.exp(dtp * a)
    x_h = xc.reshape(-1, n_heads, head_dim).float()
    ssm_state = (ssm_state * da[..., None, None]
                 + torch.einsum("bh,bhp,bn->bhpn", dtp, x_h, bvec))
    y = torch.einsum("bhpn,bn->bhp", ssm_state, cvec)
    y = y + p["D"][None, :, None] * x_h
    y = y.reshape(-1, 1, d_inner).to(x1.dtype)
    y = _gated_norm(y * F.silu(z[:, None, :]), p["norm"], norm_eps, model)
    return tp.row(tp.MATMUL, y, p["w_out"], model), ssm_state, conv_state
