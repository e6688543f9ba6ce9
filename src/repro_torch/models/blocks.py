"""Block-level dispatch: init/train/prefill/decode of one layer.

The port of ``repro/models/blocks.py`` for five block types, each a
pre-norm residual layer:

  global  causal full attention, then SwiGLU;
          cache {"k", "v"}: (B, S, KV, hd) bf16
  local   causal sliding-window attention, then SwiGLU;
          cache {"k", "v"}: (B, min(W, S), KV, hd) bf16, a ring by slot
  moe     causal full attention (the ``global`` kind), then the
          capacity-based MoE (``models/ffn.py``); cache as ``global``
  ssd     the Mamba-2 mixer (``models/ssm.py``) alone, no FFN;
          cache {"state"}: (B, H, P, N) fp32, {"conv"}: (B, K-1,
          d_inner + 2N) bf16
  rglru   the RG-LRU mixer (``models/rglru.py``), then SwiGLU;
          cache {"state"}: (B, rnn) fp32, {"conv"}: (B, K-1, rnn) bf16

``block_decode`` updates the cache entry IN PLACE and returns it (the
reference returns a new one). The other block types (``cross``,
``selfcross``, ``bidir``) raise ``NotImplementedError`` until a later
slice of the port brings them (ROADMAP).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import ffn
from repro_torch.models.common import COMPUTE_DTYPE, rms_norm, rms_norm_init
from repro_torch.models.rglru import init_rglru, rglru_decode, rglru_train
from repro_torch.models.ssm import init_mamba2, mamba2_decode, mamba2_train

PORTED = ("global", "local", "moe", "ssd", "rglru")


@dataclass(frozen=True)
class Ctx:
    """Everything a block needs besides params and activations.

    ``flash`` is the reference's ``REPRO_FLASH_ATTN`` switch, carried
    explicitly: prefill attention through the flash kernel (kernel 11)
    rather than dense masked attention."""
    cfg: ArchConfig
    positions: torch.Tensor | None = None     # (S,) for train/prefill
    flash: bool = False


def _ported(bt: str) -> None:
    if bt not in PORTED:
        raise attn._not_ported(f"block type {bt!r}")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_block(gen, bt: str, cfg: ArchConfig, *, lead: tuple = (),
               device="cpu") -> dict:
    """One block's parameters, every leaf with ``lead`` (the layer dim)
    in front."""
    _ported(bt)
    d = cfg.d_model
    p = {"n1": rms_norm_init(d, lead=lead, device=device)}
    if bt == "ssd":
        p["mix"] = init_mamba2(gen, d, cfg.ssm_heads, cfg.ssm_head_dim,
                               cfg.ssm_state, cfg.ssm_conv, lead=lead,
                               device=device)
        return p
    p["n2"] = rms_norm_init(d, lead=lead, device=device)
    if bt == "rglru":
        p["mix"] = init_rglru(gen, d, cfg.rnn_width or d, lead=lead,
                              device=device)
    else:
        p["attn"] = attn.init_attn(gen, d, cfg.n_heads, cfg.n_kv_heads,
                                   cfg.hd, cfg.qkv_bias, lead=lead,
                                   device=device)
    if bt == "moe":
        p["moe"] = ffn.init_moe(gen, d, cfg.d_ff, cfg.n_experts, lead=lead,
                                device=device)
    else:
        p["mlp"] = ffn.init_swiglu(gen, d, cfg.d_ff, lead=lead,
                                   device=device)
    return p


# ---------------------------------------------------------------------------
# train / prefill (full sequence)
# ---------------------------------------------------------------------------

def _attn_kwargs(bt: str, ctx: Ctx) -> dict:
    cfg = ctx.cfg
    kind = "local" if bt == "local" else "global"     # moe: global
    return {"n_kv": cfg.n_kv_heads, "kind": kind, "theta": cfg.rope_theta,
            "positions": ctx.positions, "window": cfg.window,
            "flash": ctx.flash}


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


def _ssd_kwargs(cfg: ArchConfig) -> dict:
    return {"n_heads": cfg.ssm_heads, "head_dim": cfg.ssm_head_dim,
            "d_state": cfg.ssm_state, "norm_eps": cfg.norm_eps}


def _mixer(p: dict, bt: str, x: torch.Tensor, ctx: Ctx):
    """The block's first half on the normed input: (y, cache entry)."""
    xn = rms_norm(x, p["n1"], ctx.cfg.norm_eps)
    if bt == "rglru":
        y, state, conv = rglru_train(p["mix"], xn)
        return y, {"state": state, "conv": conv}
    if bt == "ssd":
        y, state, conv = mamba2_train(p["mix"], xn, **_ssd_kwargs(ctx.cfg))
        return y, {"state": state, "conv": conv}
    y, k, v = attn.attn_prefill(p["attn"], xn, **_attn_kwargs(bt, ctx))
    if bt == "local":
        k, v = _ring_pack(k, ctx.cfg.window), _ring_pack(v, ctx.cfg.window)
    return y, {"k": k, "v": v}


def _ffn(p: dict, bt: str, x: torch.Tensor, cfg: ArchConfig):
    """The block's second half, residual included: (x, the MoE aux loss,
    None for the other types)."""
    if bt == "ssd":
        return x, None
    xn = rms_norm(x, p["n2"], cfg.norm_eps)
    if bt == "moe":
        y, aux = ffn.moe_apply(p["moe"], xn, top_k=cfg.top_k,
                               capacity_factor=cfg.capacity_factor)
        return x + y, aux
    return x + ffn.swiglu(p["mlp"], xn), None


def _block(p: dict, bt: str, x: torch.Tensor, ctx: Ctx):
    _ported(bt)
    y, entry = _mixer(p, bt, x, ctx)
    x, aux = _ffn(p, bt, x + y, ctx.cfg)
    return x, entry, aux


def block_prefill(p: dict, bt: str, x: torch.Tensor, ctx: Ctx
                  ) -> tuple[torch.Tensor, dict]:
    """Returns (x_out, cache_entry): the roped K/V of the normed input
    (a ring for ``local``), or the recurrent state and conv tail."""
    x, entry, _ = _block(p, bt, x, ctx)
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
    and returned."""
    _ported(bt)
    cfg = ctx.cfg
    xn = rms_norm(x1, p["n1"], cfg.norm_eps)
    if bt in ("rglru", "ssd"):
        if bt == "rglru":
            y, state, conv = rglru_decode(p["mix"], xn, cache["state"],
                                          cache["conv"])
        else:
            y, state, conv = mamba2_decode(p["mix"], xn, cache["state"],
                                           cache["conv"], **_ssd_kwargs(cfg))
        # new tensors (the window was built by torch.cat): no overlap
        cache["state"].copy_(state)
        cache["conv"].copy_(conv)
    else:
        y, _, _ = attn.decode_attn(
            p["attn"], xn, cache["k"], cache["v"], pos,
            n_kv=cfg.n_kv_heads, theta=cfg.rope_theta,
            layout=attn.KVLayout(cache["k"].shape[1]),
            window=cfg.window if bt == "local" else None)
    x1, _ = _ffn(p, bt, x1 + y, cfg)
    return x1, cache


# ---------------------------------------------------------------------------
# cache specs
# ---------------------------------------------------------------------------

def cache_entry_shape(bt: str, cfg: ArchConfig, batch: int, seq_len: int
                      ) -> dict:
    """One block's decode cache as meta tensors (shape and dtype only)."""
    _ported(bt)

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
    length = min(cfg.window, seq_len) if bt == "local" else seq_len
    shape = (batch, length, cfg.n_kv_heads, cfg.hd)
    return {"k": meta(shape), "v": meta(shape)}
