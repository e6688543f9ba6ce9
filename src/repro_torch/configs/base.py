"""Architecture + shape configuration system (a copy of the JAX
package's ``repro/configs/base.py``; the port keeps its own).

Every assigned architecture is a frozen `ArchConfig`; the four input shapes
are `ShapeConfig`s. A (arch, shape) pair fully determines the program the
launcher lowers (train_step / prefill / serve_step) and its input specs.

Block pattern: the layer stack is a sequence of *pattern groups*, each a
repeating unit of block types scanned `n` times (scan-over-layers keeps the
HLO small enough that all 80 dry-run compiles stay cheap). E.g. gemma3-27b
is `[("local",)*5 + ("global",)] * 10 + [("local",)*2]`:

    pattern_groups = ((("local","local","local","local","local","global"), 10),
                      (("local","local"), 1))
"""
from __future__ import annotations

from dataclasses import dataclass, replace

BLOCK_TYPES = (
    "global",     # causal full attention + FFN
    "local",      # causal sliding-window attention + FFN
    "bidir",      # bidirectional attention + FFN (encoder)
    "selfcross",  # causal self-attn + cross-attn + FFN (decoder w/ memory)
    "cross",      # cross-attention (to stub modality tokens) + FFN
    "moe",        # causal full attention + MoE FFN
    "ssd",        # Mamba-2 SSD mixer (attention-free, no separate FFN)
    "rglru",      # RG-LRU temporal block + FFN (Griffin/RecurrentGemma)
)

FAMILIES = ("dense", "moe", "vlm", "hybrid", "ssm", "audio")


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    # pattern groups: tuple of (block-type tuple, n_repeats)
    pattern_groups: tuple = ()
    head_dim: int = 0                  # 0 -> d_model // n_heads
    window: int = 1024                 # local-attention window
    qkv_bias: bool = False
    tie_embeddings: bool = True
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # SSM (mamba2)
    ssm_state: int = 0
    ssm_heads: int = 0                 # mamba2 value heads
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_expand: int = 2
    # RG-LRU (recurrentgemma)
    rnn_width: int = 0                 # 0 -> d_model
    # encoder (whisper) / modality frontend (vlm, audio) stubs
    enc_layers: int = 0                # whisper encoder depth
    frontend_tokens: int = 0           # stub memory length (frames / patches)
    # source provenance
    source: str = ""

    def __post_init__(self):
        assert self.family in FAMILIES, self.family
        n = sum(len(p) * r for p, r in self.pattern_groups)
        assert n == self.n_layers, (self.name, n, self.n_layers)
        for pat, _ in self.pattern_groups:
            for b in pat:
                assert b in BLOCK_TYPES, b

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up to a multiple of 256 so the embedding/logits
        shard over a 16-way 'model' axis (Megatron-style vocab padding;
        whisper's 51865 and mamba2's 50280 are not 16-divisible, which
        would otherwise replicate multi-GB logit tensors per device).
        Padded rows are masked to -inf in the loss."""
        return -(-self.vocab // 256) * 256

    @property
    def is_encdec(self) -> bool:
        return self.enc_layers > 0

    @property
    def attention_free(self) -> bool:
        return all(b == "ssd" for p, _ in self.pattern_groups for b in p)

    @property
    def subquadratic(self) -> bool:
        """True if no block needs O(S^2) attention at full context (SSM /
        local-only / mostly-local hybrids) -> long_500k is runnable.
        'global', 'moe' and 'selfcross' blocks carry full-context causal
        attention; gemma3 is grandfathered in (only 10/62 layers are
        global, with seq-sharded KV)."""
        kinds = {b for p, _ in self.pattern_groups for b in p}
        full_ctx = kinds & {"global", "moe", "selfcross"}
        return not full_ctx or self.name.startswith("gemma3")

    def n_params(self) -> int:
        """Total parameter count (embedding included once if tied), from
        the port's own parameter shapes, built on the meta device."""
        from repro_torch.models.api import count_params  # no import cycle
        return count_params(self)

    def n_active_params(self) -> int:
        """Parameters a token runs through: an MoE layer's experts count
        top_k of n_experts."""
        from repro_torch.models.api import count_params
        return count_params(self, active_only=True)

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        groups = []
        for pat, r in self.pattern_groups:
            groups.append((pat, 1))        # one repeat of each pattern unit
        # keep the q:kv grouping representative but tiny
        kv = 1 if self.n_kv_heads <= 1 else 2
        ratio = self.n_heads // max(self.n_kv_heads, 1)
        heads = kv * max(1, min(2, ratio))
        return replace(
            self,
            n_layers=sum(len(p) for p, _ in groups),
            d_model=64, n_heads=heads, n_kv_heads=kv,
            head_dim=32,
            d_ff=128 if self.d_ff else 0,
            vocab=512,
            pattern_groups=tuple(groups),
            window=32,
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            ssm_state=min(self.ssm_state, 16),
            ssm_heads=min(self.ssm_heads, 4) if self.ssm_heads else 0,
            ssm_head_dim=16 if self.ssm_heads else 64,
            rnn_width=64 if self.rnn_width else 0,
            enc_layers=min(self.enc_layers, 2),
            frontend_tokens=min(self.frontend_tokens, 16),
        )


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                          # "train" | "prefill" | "decode"

    @property
    def is_train(self) -> bool:
        return self.kind == "train"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(arch: ArchConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Per the assignment: long_500k only for sub-quadratic archs; whisper's
    context is architecturally bounded (30 s of audio)."""
    if shape.name == "long_500k":
        if arch.name == "whisper-medium":
            return False, ("enc-dec audio: decoder context is bounded by the "
                           "30s encoder window; 524K decode has no semantics")
        if not arch.subquadratic:
            return False, ("pure full-attention arch: O(S) full-KV decode at "
                           "524K is out of scope per the assignment")
    return True, ""


_REGISTRY: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    assert cfg.name not in _REGISTRY, cfg.name
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    import repro_torch.configs.all  # noqa: F401  (populate registry)
    return _REGISTRY[name]


def list_archs() -> list[str]:
    import repro_torch.configs.all  # noqa: F401
    return sorted(_REGISTRY)
