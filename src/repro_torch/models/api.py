"""Uniform model API: the port of ``repro/models/api.py`` for stacks of
any block types of ``models/blocks.py``, in any pattern of groups, with
the encoder-decoder (whisper: a ``bidir`` encoder over stub frames, its
output the memory of the ``selfcross`` decoder) and the VLM (stub image
patches through ``mproj``, the memory of the ``cross`` layers) families.

  init_params(seed, cfg, device)           -> Tree (bf16 leaves)
  forward(params, cfg, batch, remat)       -> (logits, aux)
  train_loss(params, cfg, batch, remat)    -> (loss, metrics)
  prefill(params, cfg, batch, flash=..., param_gather=...)
                                           -> (last_logits, cache)
  encode(params, cfg, frames)              -> the encoder's memory
  decode_step(params, cfg, token, pos, cache, seq_axes, param_gather)
                                           -> (logits, cache)
  cache_specs(cfg, batch, seq_len)         -> cache of meta tensors
  input_specs(cfg, shape)                  -> dict of meta tensors
  param_shapes(cfg) / count_params(cfg, active_only) -> meta Tree / int
  params_from_jax / opt_from_jax / cache_from_jax / cache_to_numpy: the
  JAX package's trees (as numpy) across, for the tests (the first two
  cut to one rank's shard when given specs and a mesh)

Parameters keep the reference's stacked layout, ``groups[gi]["s{i}"]``
with the layer dim first, held in an ``nn.Module`` whose ``state_dict``
keys spell the reference's tree path (``groups.0.s0.attn.wq``). A Python
loop over the layers replaces ``lax.scan``. The cache is a tuple per
pattern group of ``{"s{i}": entry}`` stacked over the layers (an entry is
``{"k", "v"}`` for an attention block, ``{"mk", "mv"}`` (the memory's
K/V) for ``cross`` and both for ``selfcross``, ``{"state", "conv"}`` for
``rglru`` and ``ssd``), and ``decode_step`` updates it in place. A batch
holds ``tokens`` and, for the two families with a memory, ``frames`` or
``patches`` (B, frontend_tokens, d_model), the reference's stubs
(``data/pipeline.py:add_modality_stubs``).

``train_loss`` runs the stack under autograd; ``remat=True`` wraps each
layer in ``torch.utils.checkpoint`` (the counterpart of ``jax.checkpoint``
on the reference's scan body), so only the layer inputs stay alive
between the forward and the backward pass.

``model`` (``forward``, ``train_loss``, ``prefill``, ``decode_step``) is
the mesh's "model" axis under tensor parallelism (``Ctx.model``): the
params are this rank's cut (``rules.tp_dim``). The embedding is then
vocab-parallel: each rank looks up the ids in its rows of the table, the
others' rows masked to zero, and the lookups are summed over the axis
(exact: one term a token is not zero). The logits are this rank's vocab
columns, their pad columns found by their global index, gathered whole
over the axis (``tp.gather_model``), so the loss and the serve programs
see the full logits on every rank: a rank holds (B, S, V) logits, not
its (B, S, V / n) shard. The memory of the cross layers is whole on
every rank: the VLM's ``mproj`` columns are gathered after their
product, and whisper's encoder runs tensor-parallel to a whole output.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import compat
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import blocks
from repro_torch.models.blocks import Ctx
from repro_torch.models.common import (COMPUTE_DTYPE, dense_init, rms_norm,
                                       rms_norm_init, sinusoid_freqs,
                                       sinusoidal_positions)
from repro_torch.sharding import tp


AUX_COEF = 0.01


class Tree(nn.Module):
    """A nested dict (and tuple) of tensors as an ``nn.Module``: tensor
    leaves are frozen parameters, dicts are submodules and tuples module
    lists, so ``state_dict`` keys spell the tree path. ``tree[key]`` and
    ``key in tree`` read it like the dict it came from."""

    def __init__(self, tree: dict):
        super().__init__()
        for key, val in tree.items():
            if isinstance(val, dict):
                self.add_module(key, Tree(val))
            elif isinstance(val, (tuple, list)):
                self.add_module(key, nn.ModuleList(Tree(v) for v in val))
            else:
                self.register_parameter(
                    key, nn.Parameter(val, requires_grad=False))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules


def named_leaves(tree: nn.Module) -> list[tuple[str, torch.Tensor]]:
    """(path, tensor) of every leaf, the path's keys joined by "."
    ("groups.0.s0.attn.wq"), in the order the reference flattens its
    tree: dict keys sorted, tuple entries by index."""
    def key(name: str):
        return tuple(int(k) if k.isdigit() else k for k in name.split("."))
    return sorted(tree.named_parameters(), key=lambda kv: key(kv[0]))


def map_tree(fn, tree: nn.Module) -> "Tree":
    """A new ``Tree`` of the same structure with ``fn`` applied to every
    leaf."""
    return map_named(lambda _, t: fn(t), tree)


def map_named(fn, tree: nn.Module) -> "Tree":
    """A new ``Tree`` of the same structure with ``fn(path, leaf)``
    applied to every leaf, the path's keys joined by "."."""
    return Tree(plain_tree(tree, fn))


def plain_tree(tree: nn.Module, fn=lambda _, t: t, prefix: str = ""):
    """The tree as nested dicts and tuples (a module list is a tuple) of
    ``fn(path, leaf)``; the identity keeps the parameters themselves."""
    if isinstance(tree, nn.ModuleList):
        return tuple(plain_tree(m, fn, f"{prefix}{i}.")
                     for i, m in enumerate(tree))
    out = {k: fn(prefix + k, v) for k, v in tree._parameters.items()}
    out.update({k: plain_tree(m, fn, f"{prefix}{k}.")
                for k, m in tree._modules.items()})
    return out


def shard_tree(tree: nn.Module, specs: dict, mesh) -> "Tree":
    """This rank's shard of every leaf of a full ``tree`` under ``specs``
    ({leaf path: PartitionSpec}) on ``mesh`` (``rules.shard_of``)."""
    from repro_torch.sharding import rules
    return map_named(lambda name, t: rules.shard_of(t.detach(), specs[name],
                                                     mesh), tree)


def _layer(tree, i: int) -> dict:
    """Layer ``i`` of a stacked subtree, as a dict of views."""
    items = tree.items() if isinstance(tree, dict) else \
        list(tree._parameters.items()) + list(tree._modules.items())
    return {k: v[i] if isinstance(v, torch.Tensor) else _layer(v, i)
            for k, v in items}


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_tree(gen, cfg: ArchConfig, device) -> dict:
    p: dict = {"embed": dense_init(gen, (cfg.vocab_padded, cfg.d_model),
                                   fan_in=cfg.d_model, device=device)}
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, (cfg.vocab_padded, cfg.d_model),
                                  fan_in=cfg.d_model, device=device)
    p["final_norm"] = rms_norm_init(cfg.d_model, device=device)
    p["groups"] = tuple(
        {f"s{si}": blocks.init_block(gen, bt, cfg, lead=(n,), device=device)
         for si, bt in enumerate(pat)}
        for pat, n in cfg.pattern_groups)
    if cfg.family == "vlm":
        p["mproj"] = dense_init(gen, (cfg.d_model, cfg.d_model),
                                device=device)
    if cfg.is_encdec:
        p["enc"] = {"blocks": blocks.init_block(gen, "bidir", cfg,
                                                lead=(cfg.enc_layers,),
                                                device=device),
                    "norm": rms_norm_init(cfg.d_model, device=device)}
    return p


def init_params(seed: int, cfg: ArchConfig, device=None) -> Tree:
    """Random parameters from ``seed``, drawn on ``device`` (the card by
    default). The std is d**-0.5, as in the reference: the sqrt(d)-scaled
    input embeddings and the tied-unembed logits start at unit variance."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return Tree(_init_tree(gen, cfg, dev))


def param_shapes(cfg: ArchConfig) -> Tree:
    """The parameter tree's shapes and dtypes, on the meta device."""
    return Tree(_init_tree(None, cfg, torch.device("meta")))


def count_params(cfg: ArchConfig, active_only: bool = False) -> int:
    """Parameter count from the port's own shapes, built on the meta
    device; ``active_only`` counts top_k of the n_experts of each MoE
    layer's expert leaves, as the reference does."""
    total = expert = 0
    for name, t in param_shapes(cfg).named_parameters():
        total += t.numel()
        if "experts" in name.split("."):
            expert += t.numel()
    if active_only and cfg.n_experts:
        total -= expert * (1 - cfg.top_k / cfg.n_experts)
    return int(total)


# ---------------------------------------------------------------------------
# embeddings / memory / logits
# ---------------------------------------------------------------------------

def _vocab_model(w: torch.Tensor, cfg: ArchConfig, model):
    """(the first vocab row this rank holds, the model axis) when the
    vocab rows of ``w`` (V, d) are cut over ``model``, else (0, None)."""
    if model is None or w.shape[0] == cfg.vocab_padded:
        return 0, None
    return compat.axis_index(model) * w.shape[0], model


def _lookup(table: torch.Tensor, tokens: torch.Tensor, cfg: ArchConfig,
            model) -> torch.Tensor:
    """The rows of ``tokens``; with the vocab cut over ``model``, each
    rank's rows of its own ids (the others zero), summed over the axis."""
    first, model = _vocab_model(table, cfg, model)
    if model is None:
        return table[tokens]
    ids = tokens.long() - first
    mine = (ids >= 0) & (ids < table.shape[0])
    rows = table[ids.clamp(0, table.shape[0] - 1)]
    return tp.from_model(rows.masked_fill(~mine[..., None], 0), model)


def _scaled_embed(params: Tree, cfg: ArchConfig, tokens: torch.Tensor,
                  model=None) -> torch.Tensor:
    """Embeddings times sqrt(d) rounded to bf16, as the reference's
    bf16 x bf16 product (a Python scalar, so no copy to the card)."""
    x = _lookup(params["embed"], tokens, cfg, model).to(COMPUTE_DTYPE)
    return x * float(torch.tensor(cfg.d_model ** 0.5, dtype=COMPUTE_DTYPE))


def _embed(params: Tree, cfg: ArchConfig, tokens: torch.Tensor,
           model=None) -> torch.Tensor:
    """(B, S) tokens -> (B, S, d); whisper's decoder adds its absolute
    sinusoidal positions."""
    x = _scaled_embed(params, cfg, tokens, model)
    if cfg.is_encdec:
        x = x + sinusoidal_positions(tokens.shape[1], cfg.d_model,
                                     x.device).to(COMPUTE_DTYPE)
    return x


def _decode_embed(params: Tree, cfg: ArchConfig, token: torch.Tensor,
                  pos: int, model=None) -> torch.Tensor:
    """(B,) tokens at ``pos`` -> (B, 1, d); whisper's position row is
    computed alone, as the reference does."""
    x = _scaled_embed(params, cfg, token[:, None], model)
    if cfg.is_encdec:
        ang = float(pos) * sinusoid_freqs(cfg.d_model, x.device)
        x = x + torch.cat([torch.sin(ang), torch.cos(ang)]).to(COMPUTE_DTYPE)
    return x


def _memory(params: Tree, cfg: ArchConfig, batch: dict,
            param_gather=None, model=None) -> torch.Tensor | None:
    """What the cross-attention attends to: the projected patches (vlm),
    the encoder's output (whisper), else None. With ``mproj``'s output
    dim cut over ``model`` the rank's columns are gathered whole (their
    backward takes the rank's slice of a cotangent that is whole on every
    rank: the cross layers' K/V products sum theirs over the axis)."""
    if cfg.family == "vlm":
        w = params["mproj"]
        cut = tp.cut(w.shape[-1], cfg.d_model, model)
        mem = tp.column(tp.MATMUL, batch["patches"].to(COMPUTE_DTYPE), w,
                        cut)
        return tp.gather_model(mem, -1, cut).to(COMPUTE_DTYPE)
    if cfg.is_encdec:
        return encode(params, cfg, batch["frames"], param_gather, model)
    return None


def encode(params: Tree, cfg: ArchConfig, frames: torch.Tensor,
           param_gather=None, model=None) -> torch.Tensor:
    """Whisper's encoder over stub frame embeddings (B, M, d): sinusoidal
    positions, the ``bidir`` layers (each gathered by ``param_gather``
    under scope "enc" first), then its own final norm. Under ``model``
    the layers run tensor-parallel, and the norm's scale, which
    ``rules.tp_dim`` cuts by its name ("norm", the SSD's), is gathered
    whole first."""
    m = frames.shape[1]
    x = frames.to(COMPUTE_DTYPE) + sinusoidal_positions(
        m, cfg.d_model, frames.device).to(COMPUTE_DTYPE)
    ctx = Ctx(cfg=cfg, positions=torch.arange(m, device=frames.device),
              param_gather=param_gather, model=model)
    for layer in _unbind(params["enc"]["blocks"]):
        x, _ = blocks.block_train(ctx.gather("enc", 0, layer), "bidir", x,
                                  ctx)
    scale = params["enc"]["norm"]
    scale = tp.gather_model(scale, 0, tp.cut(scale.shape[-1], cfg.d_model,
                                             model))
    return rms_norm(x, scale, cfg.norm_eps)


def logits_of(params: Tree, cfg: ArchConfig, x: torch.Tensor,
              model=None) -> torch.Tensor:
    """Logits over the PADDED vocab; padded columns are -1e30, so
    softmax and argmax ignore them. With the vocab rows cut over
    ``model``, this rank's columns (the pad ones found by their global
    index: all of qwen2.5-3b's lie in the last rank's) gathered whole."""
    w = params["lm_head"] if "lm_head" in params else params["embed"]
    first, model = _vocab_model(w, cfg, model)
    logits = tp.column(tp.einsum("bsd,vd->bsv"), x, w, model)
    pad = max(cfg.vocab - first, 0)
    if model is None:
        logits[..., pad:] = -1e30          # in place: the largest tensor
    elif pad < logits.shape[-1]:
        # out of place: autograd forbids writing into a custom Function's
        # output
        cols = torch.arange(logits.shape[-1], device=logits.device)
        logits = logits.masked_fill(cols >= pad, -1e30)
    return tp.gather_model(logits, -1, model)


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------

def _unbind(tree) -> list[dict]:
    """A stacked subtree as one dict of tensors per layer, from ONE
    ``unbind`` per leaf: under autograd the layers' gradients then meet
    in one stack at the end of the backward pass, where ``tree[i]`` per
    layer would add a zero-padded full-size gradient for every layer."""
    items = tree.items() if isinstance(tree, dict) else \
        list(tree._parameters.items()) + list(tree._modules.items())
    per = {k: v.unbind(0) if isinstance(v, torch.Tensor) else _unbind(v)
           for k, v in items}
    n = len(next(iter(per.values())))
    return [{k: v[i] for k, v in per.items()} for i in range(n)]


def _stack_train(params: Tree, cfg: ArchConfig, x: torch.Tensor, ctx: Ctx,
                 remat: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """The layers over a full sequence, one pattern unit at a time (the
    reference's scan body), each under ``checkpoint`` when ``remat``. A
    unit's params pass through ``ctx.gather`` inside the body, so the
    checkpoint's recompute gathers them again and only one unit's
    gathered params are alive at a time."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for gi, (pat, n) in enumerate(cfg.pattern_groups):
        gp = params["groups"][gi]
        slots = [_unbind(gp[f"s{i}"]) for i in range(len(pat))]
        for layer in range(n):
            def body(h, _pat=pat, _gi=gi, _layer_i=layer, _slots=slots):
                pslice = ctx.gather("groups", _gi, {
                    f"s{i}": _slots[i][_layer_i] for i in range(len(_pat))})
                a = torch.zeros((), dtype=torch.float32, device=h.device)
                for i, bt in enumerate(_pat):
                    h, ai = blocks.block_train(pslice[f"s{i}"], bt, h, ctx)
                    a = a + ai
                return h, a
            if remat:
                x, a = checkpoint(body, x, use_reentrant=False)
            else:
                x, a = body(x)
            aux = aux + a
    return x, aux


def forward(params: Tree, cfg: ArchConfig, batch: dict, remat: bool = True,
            param_gather=None, model=None, flash: bool = False
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """batch["tokens"]: (B, S) int -> (logits (B, S, V), aux).
    ``flash`` runs the causal attention through the flash kernel and, under
    autograd, its backward kernels (the reference's train step under
    ``REPRO_FLASH_ATTN=1``); by default the plain attention.
    ``param_gather`` is the fsdp mode's per-layer gather
    (``Ctx.param_gather``), ``model`` the model axis (``Ctx.model``)."""
    tokens = batch["tokens"]
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    ctx = Ctx(cfg=cfg, positions=positions, param_gather=param_gather,
              memory=_memory(params, cfg, batch, param_gather, model),
              flash=flash, model=model)
    x = _embed(params, cfg, tokens, model)
    x, aux = _stack_train(params, cfg, x, ctx, remat)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return logits_of(params, cfg, x, model), aux


def train_loss(params: Tree, cfg: ArchConfig, batch: dict,
               remat: bool = True, param_gather=None, model=None,
               flash: bool = False) -> tuple[torch.Tensor, dict]:
    """batch["tokens"]: (B, S+1) -> next-token cross-entropy (+ MoE aux),
    the log-sum-exp in fp32 over the whole vocab (under ``model`` the
    gathered logits: the same loss on every rank of the axis). ``flash``
    as in ``forward``."""
    tokens = batch["tokens"]
    inp = {**batch, "tokens": tokens[:, :-1]}
    tgt = tokens[:, 1:].long()
    logits, aux = forward(params, cfg, inp, remat, param_gather, model,
                          flash)
    lse = torch.logsumexp(logits.float(), dim=-1)
    tl = torch.gather(logits, -1, tgt[..., None])[..., 0]
    ce = torch.mean(lse - tl.float())
    loss = ce + AUX_COEF * aux
    return loss, {"ce": ce, "aux": aux}


def _unit(gp, ctx: Ctx, gi: int, n_slots: int, layer: int) -> dict:
    """Layer ``layer`` of pattern group ``gi``, one entry a slot of its
    unit, through ``ctx.gather`` (the fsdp serve gather, when given)."""
    return ctx.gather("groups", gi, {f"s{i}": _layer(gp[f"s{i}"], layer)
                                     for i in range(n_slots)})


def prefill(params: Tree, cfg: ArchConfig, batch: dict, *,
            flash: bool = False, param_gather=None, model=None
            ) -> tuple[torch.Tensor, tuple]:
    """batch["tokens"]: (B, S) -> (last-position logits (B, V), cache).
    ``flash`` runs the causal attention through the flash kernel (kernel
    11); the encoder and the cross-attention take the dense lane.
    ``param_gather`` gathers each layer's params before it runs (the fsdp
    serve gather, ``Ctx.param_gather``); under ``model`` the cache holds
    this rank's KV heads (``tp.kv_heads``) and the logits are whole."""
    tokens = batch["tokens"]
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    ctx = Ctx(cfg=cfg, positions=positions, param_gather=param_gather,
              memory=_memory(params, cfg, batch, param_gather, model),
              flash=flash, model=model)
    x = _embed(params, cfg, tokens, model)
    cache = []
    for gi, (pat, n) in enumerate(cfg.pattern_groups):
        gp = params["groups"][gi]
        entries = {f"s{i}": [] for i in range(len(pat))}
        for layer in range(n):
            unit = _unit(gp, ctx, gi, len(pat), layer)
            for i, bt in enumerate(pat):
                x, c = blocks.block_prefill(unit[f"s{i}"], bt, x, ctx)
                entries[f"s{i}"].append(c)
            del unit     # a gathered layer freed before the next is gathered
        cache.append({s: {k: torch.stack([c[k] for c in cs])
                          for k in cs[0]} for s, cs in entries.items()})
    x = rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    return logits_of(params, cfg, x, model)[:, 0], tuple(cache)


def decode_step(params: Tree, cfg: ArchConfig, token: torch.Tensor,
                pos: int, cache: tuple, seq_axes: tuple | None = None,
                param_gather=None, model=None) -> tuple[torch.Tensor, tuple]:
    """token: (B,) int, pos: int -> (logits (B, V), cache). The cache is
    updated in place and returned. ``seq_axes`` (``compat.Axis``
    objects): the global K/V hold this rank's cut of the positions
    (``attention.KVLayout``); ``param_gather`` and ``model`` as in
    ``prefill``."""
    ctx = Ctx(cfg=cfg, seq_axes=seq_axes, param_gather=param_gather,
              model=model)
    x1 = _decode_embed(params, cfg, token, pos, model)
    for gi, (pat, n) in enumerate(cfg.pattern_groups):
        gp, gc = params["groups"][gi], cache[gi]
        for layer in range(n):
            unit = _unit(gp, ctx, gi, len(pat), layer)
            for i, bt in enumerate(pat):
                x1, _ = blocks.block_decode(unit[f"s{i}"], bt, x1,
                                            _layer(gc[f"s{i}"], layer),
                                            pos, ctx)
            del unit     # a gathered layer freed before the next is gathered
    x1 = rms_norm(x1, params["final_norm"], cfg.norm_eps)
    return logits_of(params, cfg, x1, model)[:, 0], cache


def cache_specs(cfg: ArchConfig, batch: int, seq_len: int) -> tuple:
    """The cache's shapes and dtypes, as meta tensors stacked per pattern
    group."""
    out = []
    for pat, n in cfg.pattern_groups:
        g = {}
        for i, bt in enumerate(pat):
            entry = blocks.cache_entry_shape(bt, cfg, batch, seq_len)
            g[f"s{i}"] = {k: torch.empty((n,) + tuple(t.shape),
                                         dtype=t.dtype, device="meta")
                          for k, t in entry.items()}
        out.append(g)
    return tuple(out)


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    """Meta-tensor stand-ins for the model inputs of a shape cell: the
    tokens and the bf16 ``patches`` (vlm) or ``frames`` (whisper); decode:
    token, pos and the cache."""
    b, s = shape.global_batch, shape.seq_len

    def meta(*sh, dtype=torch.int32):
        return torch.empty(sh, dtype=dtype, device="meta")
    extra = {}
    if cfg.family == "vlm":
        extra["patches"] = meta(b, cfg.frontend_tokens, cfg.d_model,
                                dtype=COMPUTE_DTYPE)
    if cfg.is_encdec:
        extra["frames"] = meta(b, cfg.frontend_tokens, cfg.d_model,
                               dtype=COMPUTE_DTYPE)
    if shape.kind == "train":
        return {"tokens": meta(b, s + 1), **extra}
    if shape.kind == "prefill":
        return {"tokens": meta(b, s), **extra}
    return {"token": meta(b), "pos": meta(),
            "cache": cache_specs(cfg, b, s)}


# ---------------------------------------------------------------------------
# the JAX package's trees, as numpy, across
# ---------------------------------------------------------------------------

def _tensor(a, device: torch.device, copy: bool = False) -> torch.Tensor:
    """numpy -> tensor, bit for bit. A JAX bf16 array arrives as an
    ``ml_dtypes`` bfloat16 array, which ``torch.from_numpy`` refuses: its
    bits are viewed as int16 and then as bf16. On the CPU the tensor
    shares the array's memory unless ``copy``."""
    a = np.require(np.asarray(a), requirements=("C", "W"))
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(device, copy=copy)
    return torch.from_numpy(a).to(device, copy=copy)


def _from_numpy(tree, device: torch.device, copy: bool = False):
    if isinstance(tree, dict):
        return {k: _from_numpy(v, device, copy) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_from_numpy(v, device, copy) for v in tree)
    return _tensor(tree, device, copy)


def params_from_jax(np_tree: dict, device=None, *, specs=None,
                    mesh=None) -> Tree:
    """The reference's parameter tree (numpy leaves, e.g.
    ``jax.tree.map(np.asarray, params)``: full arrays) as the port's
    parameters; with ``specs`` ({leaf path: PartitionSpec}, a train
    program's ``meta["param_specs"]``) and ``mesh``, this rank's shard
    of each."""
    tree = Tree(_from_numpy(np_tree, resolve_device(device)))
    return tree if specs is None else shard_tree(tree, specs, mesh)


def opt_from_jax(np_opt: dict, device=None, *, specs=None,
                 mesh=None) -> dict:
    """The reference's optimizer state ``{"master", "m", "v"}`` (numpy
    leaves, full arrays) as the port's: one fp32 ``Tree`` each; with
    ``specs`` (``meta["opt_specs"]``) and ``mesh``, this rank's shard."""
    dev = resolve_device(device)
    return {k: params_from_jax(np_opt[k], dev, specs=specs, mesh=mesh)
            for k in ("master", "m", "v")}


def cache_from_jax(np_cache: tuple, device=None) -> tuple:
    """The reference's decode cache (numpy leaves) as the port's, a copy:
    ``decode_step`` writes the cache in place, and the caller's arrays
    stay as they were."""
    return _from_numpy(np_cache, resolve_device(device), copy=True)


def cache_to_numpy(cache: tuple) -> tuple:
    """The port's cache as numpy, bf16 widened to fp32 (exact), for a
    comparison with the reference's."""
    if isinstance(cache, dict):
        return {k: cache_to_numpy(v) for k, v in cache.items()}
    if isinstance(cache, (tuple, list)):
        return tuple(cache_to_numpy(v) for v in cache)
    t = cache.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
