"""Block-level dispatch: init/train/prefill/decode of one layer.

The port of ``repro/models/blocks.py`` for three block types, each a
pre-norm residual layer:

  global  causal full attention, then SwiGLU;
          cache {"k", "v"}: (B, S, KV, hd) bf16
  local   causal sliding-window attention, then SwiGLU;
          cache {"k", "v"}: (B, min(W, S), KV, hd) bf16, a ring by slot
  rglru   the RG-LRU mixer (``models/rglru.py``), then SwiGLU;
          cache {"state"}: (B, rnn) fp32, {"conv"}: (B, K-1, rnn) bf16

``block_decode`` updates the cache entry IN PLACE and returns it (the
reference returns a new one). The other block types (``ssd``, ``moe``,
``cross``, ``selfcross``, ``bidir``) raise ``NotImplementedError`` until
a later slice of the port brings them (ROADMAP).
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

PORTED = ("global", "local", "rglru")


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
    p = {"n1": rms_norm_init(d, lead=lead, device=device),
         "n2": rms_norm_init(d, lead=lead, device=device)}
    if bt == "rglru":
        p["mix"] = init_rglru(gen, d, cfg.rnn_width or d, lead=lead,
                              device=device)
    else:
        p["attn"] = attn.init_attn(gen, d, cfg.n_heads, cfg.n_kv_heads,
                                   cfg.hd, cfg.qkv_bias, lead=lead,
                                   device=device)
    p["mlp"] = ffn.init_swiglu(gen, d, cfg.d_ff, lead=lead, device=device)
    return p


# ---------------------------------------------------------------------------
# train / prefill (full sequence)
# ---------------------------------------------------------------------------

def _attn_kwargs(bt: str, ctx: Ctx) -> dict:
    cfg = ctx.cfg
    return {"n_kv": cfg.n_kv_heads, "kind": bt, "theta": cfg.rope_theta,
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


def _mixer(p: dict, bt: str, x: torch.Tensor, ctx: Ctx):
    """The block's first half on the normed input: (y, cache entry)."""
    xn = rms_norm(x, p["n1"], ctx.cfg.norm_eps)
    if bt == "rglru":
        y, state, conv = rglru_train(p["mix"], xn)
        return y, {"state": state, "conv": conv}
    y, k, v = attn.attn_prefill(p["attn"], xn, **_attn_kwargs(bt, ctx))
    if bt == "local":
        k, v = _ring_pack(k, ctx.cfg.window), _ring_pack(v, ctx.cfg.window)
    return y, {"k": k, "v": v}


def block_prefill(p: dict, bt: str, x: torch.Tensor, ctx: Ctx
                  ) -> tuple[torch.Tensor, dict]:
    """Returns (x_out, cache_entry): the roped K/V of the normed input
    (a ring for ``local``), or the recurrent state and conv tail."""
    _ported(bt)
    y, entry = _mixer(p, bt, x, ctx)
    x = x + y
    x = x + ffn.swiglu(p["mlp"], rms_norm(x, p["n2"], ctx.cfg.norm_eps))
    return x, entry


def block_train(p: dict, bt: str, x: torch.Tensor, ctx: Ctx
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (x_out, aux); aux is the MoE load-balance loss, 0 here."""
    x, _ = block_prefill(p, bt, x, ctx)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


# ---------------------------------------------------------------------------
# decode (one token, cache update)
# ---------------------------------------------------------------------------

def block_decode(p: dict, bt: str, x1: torch.Tensor, cache: dict, pos: int,
                 ctx: Ctx) -> tuple[torch.Tensor, dict]:
    """One token through the block; the cache entry is updated in place
    and returned."""
    _ported(bt)
    cfg = ctx.cfg
    eps = cfg.norm_eps
    xn = rms_norm(x1, p["n1"], eps)
    if bt == "rglru":
        y, state, conv = rglru_decode(p["mix"], xn, cache["state"],
                                      cache["conv"])
        cache["state"].copy_(state)
        cache["conv"].copy_(conv)
    else:
        y, _, _ = attn.decode_attn(
            p["attn"], xn, cache["k"], cache["v"], pos,
            n_kv=cfg.n_kv_heads, theta=cfg.rope_theta,
            layout=attn.KVLayout(cache["k"].shape[1]),
            window=cfg.window if bt == "local" else None)
    x1 = x1 + y
    x1 = x1 + ffn.swiglu(p["mlp"], rms_norm(x1, p["n2"], eps))
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
    if bt == "rglru":
        rnn = cfg.rnn_width or cfg.d_model
        return {"state": meta((batch, rnn), torch.float32),
                "conv": meta((batch, 3, rnn))}
    length = min(cfg.window, seq_len) if bt == "local" else seq_len
    shape = (batch, length, cfg.n_kv_heads, cfg.hd)
    return {"k": meta(shape), "v": meta(shape)}
