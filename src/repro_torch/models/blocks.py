"""Block-level dispatch: init/train/prefill/decode of one layer.

The port of ``repro/models/blocks.py`` for every block type, each a
pre-norm residual layer:

  global     causal full attention, then SwiGLU;
             cache {"k", "v"}: (B, S, KV, hd) bf16
  local      causal sliding-window attention, then SwiGLU;
             cache {"k", "v"}: (B, min(W, S), KV, hd) bf16, a ring by slot
  moe        causal full attention (the ``global`` kind), then the
             capacity-based MoE (``models/ffn.py``); cache as ``global``
  ssd        the Mamba-2 mixer (``models/ssm.py``) alone, no FFN;
             cache {"state"}: (B, H, P, N) fp32, {"conv"}: (B, K-1,
             d_inner + 2N) bf16
  rglru      the RG-LRU mixer (``models/rglru.py``), then SwiGLU;
             cache {"state"}: (B, rnn) fp32, {"conv"}: (B, K-1, rnn) bf16
  cross      cross-attention to the memory (``Ctx.memory``) scaled by
             tanh of a learned fp32 gate (zero at init), then SwiGLU;
             cache {"mk", "mv"}: (B, M, KV, hd) bf16, the memory's K/V
  selfcross  causal self-attention (the ``global`` kind, roped), then
             cross-attention to the memory, then the GELU MLP (whisper's
             decoder); cache {"k", "v"} as ``global`` but NOT roped (the
             reference's prefill stores them before rope and its decode
             ropes nothing), and {"mk", "mv"}
  bidir      non-causal rope-free self-attention, then the GELU MLP
             (whisper's encoder, ``api.encode``); no cache

M is ``cfg.frontend_tokens``. ``block_decode`` updates the cache entry IN
PLACE and returns it (the reference returns a new one).

Tensor parallelism (``Ctx.model``, the mesh's model axis) runs every
block type (``TP_BLOCKS``): each rank holds its cut of every leaf that
``rules.tp_dim`` cuts, and the attention (self and cross), the FFN and
the recurrent mixers place the model axis' collectives
(``sharding/tp.py``) where their leaves are cut. Whether a sub-layer is
cut is read from its leaves' shapes: the attention when wq's heads are
(wo's are then too), the SwiGLU and the GELU MLP when w1's ff is, the
MoE when its experts' ff is, the RG-LRU when w_in_a's width is, the SSD
when w_x's ``d_inner`` is (its heads with it: the rank's head count is
w_dt's). A sub-layer that is not cut runs whole on every rank, with no
collective. When the query heads are cut and the KV heads are not, the
rank projects only the KV heads its query heads read (``tp.kv_heads``),
from the whole wk and wv through ``tp.to_model``: the self-attention's
K/V, and a cross layer's of the memory. The recurrent caches keep their
conv tails whole, as the reference does: ``block_prefill`` gathers the
rank's tail channels over the axis (the train path, which drops the
tail, gathers none).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch import compat
from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import ffn
from repro_torch.models.common import COMPUTE_DTYPE, rms_norm, rms_norm_init
from repro_torch.models.rglru import init_rglru, rglru_decode, rglru_train
from repro_torch.models.ssm import init_mamba2, mamba2_decode, mamba2_train
from repro_torch.sharding import tp

# block types that run under a model axis above 1: all of them
TP_BLOCKS = ("global", "local", "moe", "ssd", "rglru", "cross", "selfcross",
             "bidir")


@dataclass(frozen=True)
class Ctx:
    """Everything a block needs besides params and activations.

    ``flash`` is the reference's ``REPRO_FLASH_ATTN`` switch, carried
    explicitly: the causal attention of a prefill or a train step through
    the flash kernel (kernel 11; in a train step under autograd, with its
    backward kernels) rather than dense masked attention."""
    cfg: ArchConfig
    positions: torch.Tensor | None = None     # (S,) for train/prefill
    memory: torch.Tensor | None = None        # (B,M,d) cross-attn memory
    flash: bool = False
    # data-parallel mesh axes the decode's global K/V are sharded over
    # along the sequence (``attention.KVLayout``), or None
    seq_axes: tuple | None = None
    # FSDP hook: (scope, group_idx, one layer's params) -> gathered
    # params. Applied inside the layer loop (under the layer's
    # checkpoint), so only one layer's params are ever materialized; its
    # backward is the INC reduce-scatter (see launch/steps.py).
    param_gather: object = None
    # the mesh's "model" axis (``compat.Axis``) when it holds more than
    # one rank: tensor parallelism; the params are this rank's cut
    model: object = None

    def gather(self, scope: str, gi: int, pslice):
        if self.param_gather is None:
            return pslice
        return self.param_gather(scope, gi, pslice)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_block(gen, bt: str, cfg: ArchConfig, *, lead: tuple = (),
               device="cpu") -> dict:
    """One block's parameters, every leaf with ``lead`` (the layer dim)
    in front."""
    d = cfg.d_model
    kw = dict(lead=lead, device=device)
    p = {"n1": rms_norm_init(d, **kw)}
    if bt == "ssd":
        p["mix"] = init_mamba2(gen, d, cfg.ssm_heads, cfg.ssm_head_dim,
                               cfg.ssm_state, cfg.ssm_conv, **kw)
        return p
    p["n2"] = rms_norm_init(d, **kw)
    heads = (d, cfg.n_heads, cfg.n_kv_heads, cfg.hd)
    if bt == "rglru":
        p["mix"] = init_rglru(gen, d, cfg.rnn_width or d, **kw)
    elif bt == "cross":
        p["xattn"] = attn.init_attn(gen, *heads, **kw)
        p["gate"] = torch.zeros(lead, dtype=torch.float32, device=device)
    elif bt in ("selfcross", "bidir"):          # no QKV bias
        p["attn"] = attn.init_attn(gen, *heads, **kw)
        if bt == "selfcross":
            p["n3"] = rms_norm_init(d, **kw)
            p["xattn"] = attn.init_attn(gen, *heads, **kw)
    else:
        p["attn"] = attn.init_attn(gen, *heads, cfg.qkv_bias, **kw)
    if bt == "moe":
        p["moe"] = ffn.init_moe(gen, d, cfg.d_ff, cfg.n_experts, **kw)
    elif bt in ("selfcross", "bidir"):
        p["mlp"] = ffn.init_gelu_mlp(gen, d, cfg.d_ff, **kw)
    else:
        p["mlp"] = ffn.init_swiglu(gen, d, cfg.d_ff, **kw)
    return p


# ---------------------------------------------------------------------------
# train / prefill (full sequence)
# ---------------------------------------------------------------------------

def _tp_attn(p: dict, ctx: Ctx) -> tuple[dict, object]:
    """(the attention params this rank computes with, the model axis when
    wq's heads are cut, else None). With wq cut and wk/wv whole, the K/V
    projections (and their biases) are narrowed to the KV heads this
    rank's query heads read, after ``tp.to_model``: each rank's gradient
    of the whole leaf is then summed over the axis."""
    cfg, ax = ctx.cfg, ctx.model
    if ax is None or p["wq"].shape[-2] == cfg.n_heads:
        return p, None
    if p["wk"].shape[-2] == cfg.n_kv_heads:
        first, count = tp.kv_heads(cfg.n_heads, cfg.n_kv_heads,
                                   compat.axis_size(ax),
                                   compat.axis_index(ax))
        p = dict(p)
        for name in ("wk", "wv", "bk", "bv"):
            if name in p:
                p[name] = tp.to_model(p[name], ax).narrow(-2, first, count)
    return p, ax


def _attn_kwargs(bt: str, ctx: Ctx, p: dict) -> dict:
    """The self-attention of a block: ``local``'s window, ``bidir``'s own
    kind, ``global`` for the rest (moe, selfcross); the KV heads are those
    of ``p``, the params the rank computes with."""
    cfg = ctx.cfg
    kind = bt if bt in ("local", "bidir") else "global"
    # the reference caches a selfcross layer's self K before rope (whisper's
    # decoder has sinusoidal positions), though its prefill attends roped
    return {"n_kv": p["wk"].shape[-2], "kind": kind,
            "theta": cfg.rope_theta,
            "positions": ctx.positions, "window": cfg.window,
            "flash": ctx.flash, "k_roped": bt != "selfcross"}


def _cross(p: dict, x: torch.Tensor, ctx: Ctx):
    """Cross-attention of ``x`` (normed) to the memory: (y, its K/V, the
    rank's KV heads under a model axis)."""
    pa, model = _tp_attn(p, ctx)
    return attn.attn_prefill(pa, x, n_kv=pa["wk"].shape[-2], kind="cross",
                             theta=ctx.cfg.rope_theta,
                             positions=ctx.positions, memory=ctx.memory,
                             model=model)


def _ring_pack(k: torch.Tensor, window: int) -> torch.Tensor:
    """Last ``window`` positions of (B,S,KV,hd) arranged by ring slot
    (slot j holds the latest position p with p % W == j)."""
    s = k.shape[1]
    if s <= window:
        return F.pad(k, (0, 0, 0, 0, 0, window - s))
    if s % window == 0:
        return k[:, -window:]          # identity arrangement
    tail = k[:, -window:]
    slots = torch.arange(s - window, s, device=k.device) % window
    out = torch.zeros_like(tail)
    out[:, slots] = tail
    return out


def _mix_model(p: dict, bt: str, ctx: Ctx):
    """The model axis when a recurrent mixer's leaves are cut (w_in_a's
    RG-LRU width, w_x's ``d_inner``), else None."""
    cfg = ctx.cfg
    whole = (cfg.rnn_width or cfg.d_model) if bt == "rglru" else \
        cfg.ssm_heads * cfg.ssm_head_dim
    w = p["mix"]["w_in_a" if bt == "rglru" else "w_x"]
    return tp.cut(w.shape[-1], whole, ctx.model)


def _ssd_kwargs(p: dict, ctx: Ctx) -> dict:
    """The SSD mixer's sizes; the head count is the rank's (w_dt's)."""
    cfg = ctx.cfg
    return {"n_heads": p["mix"]["w_dt"].shape[-1],
            "head_dim": cfg.ssm_head_dim, "d_state": cfg.ssm_state,
            "norm_eps": cfg.norm_eps, "model": _mix_model(p, "ssd", ctx)}


def _whole_tail(bt: str, conv: torch.Tensor, ctx: Ctx, model
                ) -> torch.Tensor:
    """A recurrent mixer's conv tail (B, K-1, C) with this rank's channels
    gathered whole over ``model``: the RG-LRU's all of them, the SSD's x
    columns (B and C are whole)."""
    if model is None:
        return conv
    if bt == "rglru":
        return tp.gather_model(conv, -1, model)
    bc = 2 * ctx.cfg.ssm_state
    x = conv[..., :conv.shape[-1] - bc]
    return torch.cat([tp.gather_model(x, -1, model), conv[..., x.shape[-1]:]],
                     dim=-1)


def _mixer(p: dict, bt: str, x: torch.Tensor, ctx: Ctx):
    """The block's attention or recurrent half, residual included: (x,
    cache entry; a recurrent conv tail holds the rank's channels)."""
    eps = ctx.cfg.norm_eps
    xn = rms_norm(x, p["n1"], eps)
    if bt == "rglru":
        y, state, conv = rglru_train(p["mix"], xn,
                                     _mix_model(p, "rglru", ctx))
        return x + y, {"state": state, "conv": conv}
    if bt == "ssd":
        y, state, conv = mamba2_train(p["mix"], xn, **_ssd_kwargs(p, ctx))
        return x + y, {"state": state, "conv": conv}
    if bt == "cross":
        y, mk, mv = _cross(p["xattn"], xn, ctx)
        return x + _gated(p, y), {"mk": mk, "mv": mv}
    pa, model = _tp_attn(p["attn"], ctx)
    y, k, v = attn.attn_prefill(pa, xn, model=model,
                                **_attn_kwargs(bt, ctx, pa))
    x = x + y
    if bt == "local":
        return x, {"k": _ring_pack(k, ctx.cfg.window),
                   "v": _ring_pack(v, ctx.cfg.window)}
    if bt == "selfcross":
        y, mk, mv = _cross(p["xattn"], rms_norm(x, p["n2"], eps), ctx)
        return x + y, {"k": k, "v": v, "mk": mk, "mv": mv}
    if bt == "bidir":
        return x, {}
    return x, {"k": k, "v": v}


def _gated(p: dict, y: torch.Tensor) -> torch.Tensor:
    """A ``cross`` block's attention output times tanh(gate), in bf16."""
    return torch.tanh(p["gate"]).to(y.dtype) * y


def _ff_model(w1: torch.Tensor, ctx: Ctx):
    """The model axis when ``w1``'s ff dim (last) is cut, else None."""
    return tp.cut(w1.shape[-1], ctx.cfg.d_ff, ctx.model)


def _ffn(p: dict, bt: str, x: torch.Tensor, ctx: Ctx):
    """The block's second half, residual included: (x, the MoE aux loss,
    None for the other types)."""
    cfg = ctx.cfg
    if bt == "ssd":
        return x, None
    xn = rms_norm(x, p["n3" if bt == "selfcross" else "n2"], cfg.norm_eps)
    if bt == "moe":
        y, aux = ffn.moe_apply(
            p["moe"], xn, top_k=cfg.top_k,
            capacity_factor=cfg.capacity_factor,
            model=_ff_model(p["moe"]["experts"]["w1"], ctx))
        return x + y, aux
    if bt in ("selfcross", "bidir"):
        return x + ffn.gelu_mlp(p["mlp"], xn,
                                _ff_model(p["mlp"]["w1"], ctx)), None
    return x + ffn.swiglu(p["mlp"], xn, _ff_model(p["mlp"]["w1"], ctx)), None


def _block(p: dict, bt: str, x: torch.Tensor, ctx: Ctx):
    x, entry = _mixer(p, bt, x, ctx)
    x, aux = _ffn(p, bt, x, ctx)
    return x, entry, aux


def block_prefill(p: dict, bt: str, x: torch.Tensor, ctx: Ctx
                  ) -> tuple[torch.Tensor, dict]:
    """Returns (x_out, cache_entry): the roped K/V of the normed input (a
    ring for ``local``, un-roped for ``selfcross``), the memory's K/V, or
    the recurrent state and conv tail (under a model axis the rank's
    state and the whole tail)."""
    x, entry, _ = _block(p, bt, x, ctx)
    if bt in ("rglru", "ssd"):
        entry["conv"] = _whole_tail(bt, entry["conv"], ctx,
                                    _mix_model(p, bt, ctx))
    return x, entry


def block_train(p: dict, bt: str, x: torch.Tensor, ctx: Ctx
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (x_out, aux): aux is the MoE load-balance loss (0 for the
    other types)."""
    x, _, aux = _block(p, bt, x, ctx)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, aux


# ---------------------------------------------------------------------------
# decode (one token, cache update)
# ---------------------------------------------------------------------------

def block_decode(p: dict, bt: str, x1: torch.Tensor, cache: dict, pos: int,
                 ctx: Ctx) -> tuple[torch.Tensor, dict]:
    """One token through the block; the cache entry is updated in place
    and returned (a memory's K/V are only read)."""
    cfg = ctx.cfg
    xn = rms_norm(x1, p["n1"], cfg.norm_eps)
    if bt in ("rglru", "ssd"):
        if bt == "rglru":
            y, state, conv = rglru_decode(p["mix"], xn, cache["state"],
                                          cache["conv"],
                                          _mix_model(p, "rglru", ctx))
        else:
            y, state, conv = mamba2_decode(p["mix"], xn, cache["state"],
                                           cache["conv"],
                                           **_ssd_kwargs(p, ctx))
        # new tensors (the window was built by torch.cat): no overlap
        cache["state"].copy_(state)
        cache["conv"].copy_(conv)
        x1 = x1 + y
    elif bt == "cross":
        x1 = x1 + _gated(p, _decode_cross(p["xattn"], xn, cache, ctx))
    else:
        # a local layer's ring is never sharded; the others' K/V (global,
        # moe, selfcross's self-attention) follow ``ctx.seq_axes``
        local = bt == "local"
        pa, model = _tp_attn(p["attn"], ctx)
        y, _, _ = attn.decode_attn(
            pa, xn, cache["k"], cache["v"], pos,
            n_kv=pa["wk"].shape[-2], theta=cfg.rope_theta,
            layout=attn.KVLayout(cache["k"].shape[1],
                                 None if local else ctx.seq_axes),
            window=cfg.window if local else None,
            rope=bt != "selfcross", model=model)
        x1 = x1 + y
        if bt == "selfcross":
            x1 = x1 + _decode_cross(p["xattn"],
                                    rms_norm(x1, p["n2"], cfg.norm_eps),
                                    cache, ctx)
    x1, _ = _ffn(p, bt, x1, ctx)
    return x1, cache


def _decode_cross(p: dict, xn: torch.Tensor, cache: dict, ctx: Ctx
                  ) -> torch.Tensor:
    """One token's cross-attention to the memory's cached K/V (the rank's
    KV heads under a model axis)."""
    pa, model = _tp_attn(p, ctx)
    return attn.decode_cross_attn(pa, xn, cache["mk"], cache["mv"],
                                  cache["mk"].shape[-2], model)


# ---------------------------------------------------------------------------
# cache specs
# ---------------------------------------------------------------------------

def cache_entry_shape(bt: str, cfg: ArchConfig, batch: int, seq_len: int
                      ) -> dict:
    """One block's decode cache as meta tensors (shape and dtype only)."""
    def meta(shape, dtype=COMPUTE_DTYPE):
        return torch.empty(shape, dtype=dtype, device="meta")
    if bt == "ssd":
        d_inner = cfg.ssm_heads * cfg.ssm_head_dim
        return {"state": meta((batch, cfg.ssm_heads, cfg.ssm_head_dim,
                               cfg.ssm_state), torch.float32),
                "conv": meta((batch, cfg.ssm_conv - 1,
                              d_inner + 2 * cfg.ssm_state))}
    if bt == "rglru":
        rnn = cfg.rnn_width or cfg.d_model
        return {"state": meta((batch, rnn), torch.float32),
                "conv": meta((batch, 3, rnn))}
    mem = (batch, cfg.frontend_tokens, cfg.n_kv_heads, cfg.hd)
    if bt == "cross":
        return {"mk": meta(mem), "mv": meta(mem)}
    length = min(cfg.window, seq_len) if bt == "local" else seq_len
    shape = (batch, length, cfg.n_kv_heads, cfg.hd)
    if bt == "selfcross":
        return {"k": meta(shape), "v": meta(shape), "mk": meta(mem),
                "mv": meta(mem)}
    return {"k": meta(shape), "v": meta(shape)}
