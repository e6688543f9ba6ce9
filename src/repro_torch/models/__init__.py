"""The model stack on PyTorch: norms, RoPE, attention, SwiGLU, blocks and
the prefill/decode API."""
