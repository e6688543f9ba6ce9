"""GQA attention: train/prefill over a full sequence and decode against a
KV cache, for the four kinds of the reference: ``global`` (causal full
attention), ``local`` (causal sliding-window attention), ``bidir``
(non-causal, rope-free: whisper's encoder) and ``cross`` (rope-free
queries of the sequence against the K/V of a memory: the encoder's output
or the projected image patches).

The port of ``repro/models/attention.py``. Einsums run in bf16 and return
bf16, as the reference's do; scores and softmax are fp32. Prefill of the
causal kinds has two lanes, chosen by the caller's ``flash`` flag (the
reference's ``REPRO_FLASH_ATTN`` switch, carried explicitly on
``blocks.Ctx``):

  - ``flash=True``: ``ops.flash_attention``, the hand-written Hopper kernel
    on the card (kernel 11), its plain version on the CPU. A ``local``
    layer takes it, with its window, only when S > window, as in the
    reference;
  - ``flash=False``: dense masked attention (``attn_full``), or query
    chunks above ``CHUNKED_THRESHOLD`` (``attn_causal_chunked``); a
    ``local`` layer the banded ``attn_local``.

``bidir`` and ``cross`` take the dense non-causal ``attn_full`` on both
lanes, as in the reference, which has no kernel for them (and kernel 11
takes no memory longer than the sequence).

Decode has no kernel in the reference and stays einsums: a ``global``
cache by position, a ``local`` one a ring of ``window`` slots, the
rope-free lane of ``selfcross``, and the cross-attention against the
memory's K/V, projected once at prefill (``memory_kv``). A global cache
may be sharded along the sequence over data-parallel mesh axes
(``KVLayout.seq_axes``: a long context at a batch too small to shard);
each rank then attends to its own positions and the ranks combine their
partial softmaxes (a ``pmax`` and two ``psum``s over the axes,
``core/inc_agg.py``'s collectives) instead of gathering the cache.

Under tensor parallelism the caller hands over this rank's heads (its
cut of wq, wk, wv and wo, ``blocks._tp_attn``) and the model axis as
``model``: the projections to the heads are ``tp.column`` products and
the output projection, whose contracting head dim is then cut, is summed
over the axis (``tp.row``). Head counts come from the tensors' shapes.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch import compat
from repro_torch.core import inc_agg
from repro_torch.kernels import ops
from repro_torch.models.common import COMPUTE_DTYPE, apply_rope, dense_init
from repro_torch.sharding import tp

NEG_INF = -1e30
# above this seq len, causal attention loops over query chunks (peak
# transient (B,H,Cq,S) instead of (B,H,S,S))
CHUNKED_THRESHOLD = 2_048
Q_CHUNK = 1_024


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def init_attn(gen, d_model: int, n_heads: int, n_kv: int, head_dim: int,
              qkv_bias: bool = False, *, lead: tuple = (),
              device="cpu") -> dict:
    """Projection weights, with ``lead`` (the layer dim) in front."""
    p = {
        "wq": dense_init(gen, lead + (d_model, n_heads, head_dim),
                         fan_in=d_model, device=device),
        "wk": dense_init(gen, lead + (d_model, n_kv, head_dim),
                         fan_in=d_model, device=device),
        "wv": dense_init(gen, lead + (d_model, n_kv, head_dim),
                         fan_in=d_model, device=device),
        "wo": dense_init(gen, lead + (n_heads, head_dim, d_model),
                         fan_in=n_heads * head_dim, device=device),
    }
    if qkv_bias:
        for name, heads in (("bq", n_heads), ("bk", n_kv), ("bv", n_kv)):
            p[name] = torch.zeros(lead + (heads, head_dim),
                                  dtype=COMPUTE_DTYPE, device=device)
    return p


def qkv(p: dict, x: torch.Tensor, x_kv: torch.Tensor | None = None,
        model=None):
    """x: (B,S,d) -> q (B,S,H,hd), k/v (B,Skv,KV,hd) of ``x_kv`` (a
    memory (B,Skv,d)), or of ``x`` when it is None."""
    k, v = memory_kv(p, x if x_kv is None else x_kv, model)
    return query(p, x, model), k, v


_PROJ = tp.einsum("bsd,dhk->bshk")


def query(p: dict, x: torch.Tensor, model=None) -> torch.Tensor:
    """x: (B,S,d) -> q (B,S,H,hd)."""
    q = tp.column(_PROJ, x, p["wq"], model)
    return q + p["bq"] if "bq" in p else q


def memory_kv(p: dict, memory: torch.Tensor, model=None):
    """K/V (B,M,KV,hd) of a memory (B,M,d): a cross-attention layer's,
    projected once at prefill for the decode cache."""
    k = tp.column(_PROJ, memory, p["wk"], model)
    v = tp.column(_PROJ, memory, p["wv"], model)
    if "bk" in p:
        k = k + p["bk"]
        v = v + p["bv"]
    return k, v


def out_proj(p: dict, o: torch.Tensor, model=None) -> torch.Tensor:
    """o (B,S,H,hd) -> (B,S,d); with ``model`` (wo's heads cut over that
    axis) the partial products summed over it."""
    return tp.row(tp.einsum("bshk,hkd->bsd"), o, p["wo"], model)


# ---------------------------------------------------------------------------
# core attention math (grouped heads)
# ---------------------------------------------------------------------------

def _group(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """(B,S,H,hd) -> (B,S,KV,G,hd)."""
    b, s, h, hd = q.shape
    if h % n_kv:
        raise ValueError(f"{h} query heads do not group over {n_kv} KV heads")
    return q.reshape(b, s, n_kv, h // n_kv, hd)


def _attend(q, k, v, mask) -> torch.Tensor:
    """q: (B,Sq,KV,G,hd), k/v: (B,Sk,KV,hd), mask: boolean broadcastable
    to (B,KV,G,Sq,Sk) (True = attend). Returns (B,Sq,KV,G,hd)."""
    hd = q.shape[-1]
    scores = torch.einsum("bqkgh,bskh->bkgqs", q, k).float() * (hd ** -0.5)
    if mask is not None:
        scores = scores.masked_fill(~mask, NEG_INF)
    # fp32 softmax, guarding fully-masked rows
    m = scores.amax(dim=-1, keepdim=True)
    e = torch.exp(scores - m.clamp(min=NEG_INF / 2))
    if mask is not None:
        e = e.masked_fill(~mask, 0.0)
    den = e.sum(dim=-1, keepdim=True)
    w = (e / den.clamp(min=1e-30)).to(v.dtype)
    return torch.einsum("bkgqs,bskh->bqkgh", w, v)


def _merge(o: torch.Tensor) -> torch.Tensor:
    b, s, kv, g, hd = o.shape
    return o.reshape(b, s, kv * g, hd)


# ---------------------------------------------------------------------------
# train / prefill attention
# ---------------------------------------------------------------------------

def attn_full(q, k, v, n_kv: int, causal: bool) -> torch.Tensor:
    """Single-shot attention; used when S is small enough."""
    sq, sk = q.shape[1], k.shape[1]
    mask = None
    if causal:
        mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device).tril()
    return _merge(_attend(_group(q, n_kv), k, v, mask))


def attn_causal_chunked(q, k, v, n_kv: int, q_chunk: int = Q_CHUNK
                        ) -> torch.Tensor:
    """Memory-bounded causal attention: a loop over query chunks, each
    attending to the full (masked) KV. Peak transient is (B,H,Cq,S)."""
    s = q.shape[1]
    if s % q_chunk:
        raise ValueError(f"sequence {s} is not a multiple of {q_chunk}")
    qg = _group(q, n_kv)
    kpos = torch.arange(s, device=q.device)
    outs = []
    for i in range(s // q_chunk):
        qpos = i * q_chunk + torch.arange(q_chunk, device=q.device)
        mask = kpos[None, :] <= qpos[:, None]
        outs.append(_attend(qg[:, i * q_chunk:(i + 1) * q_chunk], k, v,
                            mask))
    return _merge(torch.cat(outs, dim=1))


def attn_local(q, k, v, n_kv: int, window: int) -> torch.Tensor:
    """Exact sliding-window causal attention, O(S*W): query chunk i (chunk
    size == window) attends KV chunks i-1 and i with a band mask. Ragged
    tails are padded to a window multiple (padded keys sit at positions
    beyond every real query, so the causal band masks them out)."""
    s, w = q.shape[1], window
    if s <= w:
        return attn_full(q, k, v, n_kv, causal=True)
    pad = (-s) % w
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        return attn_local(q, k, v, n_kv, window)[:, :s]
    qg = _group(q, n_kv)
    outs = []
    for i in range(s // w):
        start = max(i - 1, 0) * w              # i=0 re-reads chunk 0
        qpos = i * w + torch.arange(w, device=q.device)
        kpos = start + torch.arange(2 * w, device=q.device)
        mask = ((kpos[None, :] <= qpos[:, None])
                & (kpos[None, :] > qpos[:, None] - w))
        outs.append(_attend(qg[:, i * w:(i + 1) * w],
                            k[:, start:start + 2 * w],
                            v[:, start:start + 2 * w], mask))
    return _merge(torch.cat(outs, dim=1))


def attn_train(p: dict, x: torch.Tensor, *, n_kv: int, kind: str,
               theta: float, positions: torch.Tensor,
               window: int | None = None, flash: bool = False,
               memory: torch.Tensor | None = None, model=None
               ) -> torch.Tensor:
    """One attention sub-layer over a full sequence (``kind`` "global",
    "local", "bidir" or "cross"; ``window`` is the local kind's, ``memory``
    (B,M,d) the cross kind's). ``flash`` routes the causal kinds through
    ``ops.flash_attention`` (kernel 11); ``model`` as in the module's
    docstring."""
    return attn_prefill(p, x, n_kv=n_kv, kind=kind, theta=theta,
                        positions=positions, window=window, flash=flash,
                        memory=memory, model=model)[0]


def attn_prefill(p: dict, x: torch.Tensor, *, n_kv: int, kind: str,
                 theta: float, positions: torch.Tensor,
                 window: int | None = None, flash: bool = False,
                 memory: torch.Tensor | None = None, k_roped: bool = True,
                 model=None):
    """``attn_train`` that also returns the K and V it attended to (roped
    for the causal kinds unless ``k_roped`` is False, the memory's for
    ``cross``): the decode cache entry, which the reference projects a
    second time (``blocks._roped_kv``, ``memory_kv``) from the same input.
    With ``model`` they are this rank's KV heads."""
    if kind not in ("global", "local", "bidir", "cross"):
        raise ValueError(f"attention kind {kind!r}")
    if kind == "local" and not window:
        raise ValueError("local attention needs a window")
    if kind == "cross" and memory is None:
        raise ValueError("cross attention needs a memory")
    q, k, v = qkv(p, x, memory if kind == "cross" else None, model)
    if kind in ("bidir", "cross"):
        return out_proj(p, attn_full(q, k, v, n_kv, causal=False),
                        model), k, v
    q = apply_rope(q, positions, theta)
    k, k_raw = apply_rope(k, positions, theta), k
    if kind == "local":
        # the reference's routing: the kernel only when the window bites
        if flash and x.shape[1] > window:
            o = ops.flash_attention(q, k, v, causal=True, window=window)
        else:
            o = attn_local(q, k, v, n_kv, window)
    elif flash:
        o = ops.flash_attention(q, k, v, causal=True)
    elif x.shape[1] > CHUNKED_THRESHOLD:
        o = attn_causal_chunked(q, k, v, n_kv)
    else:
        o = attn_full(q, k, v, n_kv, causal=True)
    return out_proj(p, o, model), k if k_roped else k_raw, v


# ---------------------------------------------------------------------------
# decode attention (one new token against a KV cache)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class KVLayout:
    """How the decode KV cache is laid out across the data-parallel mesh
    axes. ``seq_axes=None``: every rank holds the full ``length`` positions
    of its batch rows. ``seq_axes=(...)`` (``compat.Axis`` objects): the
    cache's positions are cut over those axes, this rank holding
    ``length`` of them from ``offset()``, and attention combines the
    ranks' partial softmaxes."""
    length: int                  # positions this rank holds
    seq_axes: tuple | None = None

    def offset(self) -> int:
        """The first position this rank holds: its index over
        ``seq_axes`` (the first axis major, as ``rules.shard_of`` cuts)
        times ``length``."""
        idx = 0
        for ax in self.seq_axes or ():
            idx = idx * compat.axis_size(ax) + compat.axis_index(ax)
        return idx * self.length


def decode_attn(p: dict, x1: torch.Tensor, k_cache: torch.Tensor,
                v_cache: torch.Tensor, pos: int, *, n_kv: int, theta: float,
                layout: KVLayout, window: int | None = None,
                rope: bool = True, model=None):
    """x1: (B,1,d); caches (B,L,KV,hd). Returns (out (B,1,d), k_cache,
    v_cache). The new token's K/V, roped unless ``rope`` is False (a
    ``selfcross`` layer), are written into the caches IN PLACE (the
    reference returns updated copies):

      window=None: a global cache, slot ``pos - offset`` when ``0 <= pos -
      offset < L`` (only the rank that holds ``pos``, when the cache is
      sequence-sharded), positions ``offset .. offset + L - 1``;
      window=W: a ring of W slots (L == W, never sharded), slot ``pos %
      W``; slot j then holds position ``pos - ((pos - j) % W)``, valid
      when that is >= 0 and within the window.

    With ``model`` the caches hold this rank's KV heads (``tp.kv_heads``)
    and the output is summed over that axis."""
    pos = int(pos)
    q, k, v = qkv(p, x1, model=model)
    if rope:
        posb = torch.full((x1.shape[0], 1), pos, device=x1.device)
        q = apply_rope(q, posb, theta)
        k = apply_rope(k, posb, theta)
    if window is not None:
        if k_cache.shape[1] != window:
            raise ValueError(f"a ring cache of {k_cache.shape[1]} slots for "
                             f"a window of {window}")
        slot = pos % window
        k_cache[:, slot] = k[:, 0]
        v_cache[:, slot] = v[:, 0]
        idx = torch.arange(window, device=x1.device)
        p_j = pos - torch.remainder(pos - idx, window)
        valid = (p_j >= 0) & (p_j > pos - window)
        out = _decode_attend(q, k_cache, v_cache, valid, n_kv)
        return out_proj(p, out, model), k_cache, v_cache
    off = layout.offset()
    if 0 <= pos - off < layout.length:
        k_cache[:, pos - off] = k[:, 0]
        v_cache[:, pos - off] = v[:, 0]
    valid = off + torch.arange(layout.length, device=x1.device) <= pos
    out = _decode_attend(q, k_cache, v_cache, valid, n_kv, layout.seq_axes)
    return out_proj(p, out, model), k_cache, v_cache


def _decode_attend(q, k_cache, v_cache, valid, n_kv: int,
                   seq_axes: tuple | None = None) -> torch.Tensor:
    """q: (B,1,H,hd); cache: (B,L,KV,hd); valid: (L,) bool. With
    ``seq_axes`` the cache is this rank's positions, and the ranks
    combine their partial softmaxes: the max of the scores by ``pmax``
    (taken before the clamp, so a rank with no valid position takes the
    others' max), the denominators and the fp32 outputs by ``psum``."""
    b, _, h, hd = q.shape
    qg = _group(q, n_kv)[:, 0]                        # (B,KV,G,hd)
    s = torch.einsum("bkgh,bskh->bkgs", qg, k_cache).float() * (hd ** -0.5)
    s = s.masked_fill(~valid, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)                  # (B,KV,G,1)
    if seq_axes is not None:
        m = inc_agg._pmax(m, seq_axes)
    e = torch.exp(s - m.clamp(min=NEG_INF / 2))
    e = e.masked_fill(~valid, 0.0)
    den = e.sum(dim=-1)                               # (B,KV,G)
    o = torch.einsum("bkgs,bskh->bkgh", e.to(v_cache.dtype), v_cache).float()
    if seq_axes is not None:
        den = inc_agg._psum(den, seq_axes)
        o = inc_agg._psum(o, seq_axes)
    o = o / den[..., None].clamp(min=1e-30)
    return o.reshape(b, 1, h, hd).to(v_cache.dtype)


def decode_cross_attn(p: dict, x1: torch.Tensor, k_mem: torch.Tensor,
                      v_mem: torch.Tensor, n_kv: int, model=None
                      ) -> torch.Tensor:
    """x1: (B,1,d) against the memory's K/V (B,M,KV,hd), every position
    valid; no rope. Returns (B,1,d). With ``model`` the K/V hold this
    rank's KV heads and the output is summed over that axis."""
    valid = torch.ones(k_mem.shape[1], dtype=torch.bool, device=x1.device)
    return out_proj(p, _decode_attend(query(p, x1, model), k_mem, v_mem,
                                      valid, n_kv), model)
