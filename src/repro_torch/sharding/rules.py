"""Which dim of each parameter leaf is tensor-parallel and which is
data-parallel: the rules of ``repro/sharding/rules.py`` that one rank
needs (kept copies, not imports).

A leaf's path is the tuple of its tree keys, e.g. ``("groups", "0", "s0",
"attn", "wq")`` (a ``state_dict`` key split on "."). TP assignment is
name+shape based: heads dims for attention, d_ff for MLPs and experts,
vocab for embeddings. ``fsdp_dim`` is the dim the gradient is
reduce-scattered along (ZeRO-1) or, for the FSDP models, the dim the
parameters are stored scattered on.
"""
from __future__ import annotations

FSDP_ARCHS = ("grok-1-314b", "llama-3.2-vision-90b")


def _path_names(path) -> list[str]:
    if isinstance(path, str):
        return path.split(".")
    return [str(k) for k in path]


def _leaf_name(path) -> str:
    return _path_names(path)[-1]


def _is_stacked(path) -> bool:
    names = _path_names(path)
    return ("groups" in names) or ("blocks" in names)


# TP dim by leaf name, counted from the END of the shape (stacked leaves
# have an extra leading layer dim, so negative indexing is uniform).
_TP_DIM_FROM_END = {
    # attention
    "wq": 2, "wk": 2, "wv": 2,            # (..., d, H, hd) -> H
    "wo": 3,                              # (..., H, hd, d) -> H
    "bq": 2, "bk": 2, "bv": 2,            # (..., H, hd)    -> H
    # dense mlp
    "w1": 1, "w3": 1,                     # (..., d, ff)    -> ff
    "w2": 2,                              # (..., ff, d)    -> ff
    "b1": 1,
    # ssm
    "w_z": 1, "w_x": 1, "w_dt": 1,        # (..., d, d_inner|H)
    "conv_x": 1, "conv_bx": 1,
    "dt_bias": 1, "A_log": 1, "D": 1,     # (..., H)
    "norm": 1,                            # (..., d_inner)
    "w_out": 2,                           # (..., d_inner|rnn, d)
    # rglru
    "w_in_a": 1, "w_in_b": 1,
    "conv_w": 1, "conv_b": 1,
    "wr": 3, "wi": 3,                     # (..., nb, c, c) -> nb
    "br": 1, "bi": 1, "lam": 1,
    # embeddings
    "embed": 2, "lm_head": 2,             # (V, d) -> V
    "mproj": 1,
}

# expert leaves: under an "experts" subtree the ff dim moves one inward
_TP_DIM_EXPERTS = {"w1": 1, "w3": 1, "w2": 2}


def tp_dim(path, shape, n_model: int) -> int | None:
    names = _path_names(path)
    name = names[-1]
    if "experts" in names:
        d = _TP_DIM_EXPERTS.get(name)
    else:
        d = _TP_DIM_FROM_END.get(name)
    if d is None or d > len(shape):
        return None
    dim = len(shape) - d
    if shape[dim] % n_model != 0 or shape[dim] < n_model:
        return None
    return dim


def fsdp_dim(path, shape, n_dp: int, taken: int | None) -> int | None:
    start = 1 if _is_stacked(path) else 0
    best = None
    for i in range(start, len(shape)):
        if i == taken:
            continue
        if shape[i] % n_dp == 0 and shape[i] >= n_dp:
            if best is None or shape[i] > shape[best]:
                best = i
    return best


def mode_for(arch_name: str) -> str:
    return "fsdp" if arch_name in FSDP_ARCHS else "zero1"
