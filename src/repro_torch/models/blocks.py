"""Block-level dispatch: init/train/prefill/decode of one layer.

The port of ``repro/models/blocks.py`` for the ``global`` block (pre-norm
residual: causal full attention, then SwiGLU). Its decode cache entry is
``{"k", "v"}``: (B, S, KV, hd) bf16. The other block types raise
``NotImplementedError`` until a later slice of the port brings them
(ROADMAP).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import ffn
from repro_torch.models.common import COMPUTE_DTYPE, rms_norm, rms_norm_init


@dataclass(frozen=True)
class Ctx:
    """Everything a block needs besides params and activations.

    ``flash`` is the reference's ``REPRO_FLASH_ATTN`` switch, carried
    explicitly: prefill attention through the flash kernel (kernel 11)
    rather than dense masked attention."""
    cfg: ArchConfig
    positions: torch.Tensor | None = None     # (S,) for train/prefill
    flash: bool = False


def _global_only(bt: str) -> None:
    if bt != "global":
        raise attn._not_ported(f"block type {bt!r}")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_block(gen, bt: str, cfg: ArchConfig, *, lead: tuple = (),
               device="cpu") -> dict:
    """One block's parameters, every leaf with ``lead`` (the layer dim)
    in front."""
    _global_only(bt)
    d = cfg.d_model
    return {"n1": rms_norm_init(d, lead=lead, device=device),
            "n2": rms_norm_init(d, lead=lead, device=device),
            "attn": attn.init_attn(gen, d, cfg.n_heads, cfg.n_kv_heads,
                                   cfg.hd, cfg.qkv_bias, lead=lead,
                                   device=device),
            "mlp": ffn.init_swiglu(gen, d, cfg.d_ff, lead=lead,
                                   device=device)}


# ---------------------------------------------------------------------------
# train / prefill (full sequence)
# ---------------------------------------------------------------------------

def _attn_kwargs(ctx: Ctx) -> dict:
    cfg = ctx.cfg
    return {"n_kv": cfg.n_kv_heads, "kind": "global",
            "theta": cfg.rope_theta, "positions": ctx.positions,
            "flash": ctx.flash}


def block_train(p: dict, bt: str, x: torch.Tensor, ctx: Ctx
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (x_out, aux); aux is the MoE load-balance loss, 0 here."""
    _global_only(bt)
    eps = ctx.cfg.norm_eps
    x = x + attn.attn_train(p["attn"], rms_norm(x, p["n1"], eps),
                            **_attn_kwargs(ctx))
    x = x + ffn.swiglu(p["mlp"], rms_norm(x, p["n2"], eps))
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def block_prefill(p: dict, bt: str, x: torch.Tensor, ctx: Ctx
                  ) -> tuple[torch.Tensor, dict]:
    """Returns (x_out, cache_entry): the roped K/V of the normed input."""
    _global_only(bt)
    eps = ctx.cfg.norm_eps
    y, k, v = attn.attn_prefill(p["attn"], rms_norm(x, p["n1"], eps),
                                **_attn_kwargs(ctx))
    x = x + y
    x = x + ffn.swiglu(p["mlp"], rms_norm(x, p["n2"], eps))
    return x, {"k": k, "v": v}


# ---------------------------------------------------------------------------
# decode (one token, cache update)
# ---------------------------------------------------------------------------

def block_decode(p: dict, bt: str, x1: torch.Tensor, cache: dict, pos: int,
                 ctx: Ctx) -> tuple[torch.Tensor, dict]:
    """One token through the block; the cache entry is updated in place
    and returned."""
    _global_only(bt)
    cfg = ctx.cfg
    eps = cfg.norm_eps
    layout = attn.KVLayout(cache["k"].shape[1])
    y, k, v = attn.decode_attn(p["attn"], rms_norm(x1, p["n1"], eps),
                               cache["k"], cache["v"], pos,
                               n_kv=cfg.n_kv_heads, theta=cfg.rope_theta,
                               layout=layout)
    x1 = x1 + y
    x1 = x1 + ffn.swiglu(p["mlp"], rms_norm(x1, p["n2"], eps))
    return x1, {"k": k, "v": v}


# ---------------------------------------------------------------------------
# cache specs
# ---------------------------------------------------------------------------

def cache_entry_shape(bt: str, cfg: ArchConfig, batch: int, seq_len: int
                      ) -> dict:
    """One block's decode cache as meta tensors (shape and dtype only)."""
    _global_only(bt)
    shape = (batch, seq_len, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.empty(shape, dtype=COMPUTE_DTYPE, device="meta"),
            "v": torch.empty(shape, dtype=COMPUTE_DTYPE, device="meta")}
