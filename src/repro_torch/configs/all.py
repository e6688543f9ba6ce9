"""Import all assigned architecture configs (populates the registry)."""
from repro_torch.configs import (  # noqa: F401
    gemma3_27b,
    grok_1_314b,
    llama_3_2_vision_90b,
    mamba2_780m,
    moonshot_v1_16b_a3b,
    phi4_mini_3_8b,
    qwen2_5_3b,
    recurrentgemma_9b,
    stablelm_1_6b,
    whisper_medium,
)

ALL_ARCHS = (
    "moonshot-v1-16b-a3b",
    "grok-1-314b",
    "gemma3-27b",
    "phi4-mini-3.8b",
    "stablelm-1.6b",
    "qwen2.5-3b",
    "llama-3.2-vision-90b",
    "recurrentgemma-9b",
    "mamba2-780m",
    "whisper-medium",
)
