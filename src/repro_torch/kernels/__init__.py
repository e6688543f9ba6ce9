"""The INC kernel family of the port: plain PyTorch versions (ref.py) and
hand-written CUDA kernels for Hopper (csrc/), dispatched by ops.py."""
