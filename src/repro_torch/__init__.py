"""repro_torch — NetRPC's in-network-computation RPC on PyTorch and CUDA.

The PyTorch port of the ``repro`` package: the same typed INC RPC round
trip, with the switch register file as int32 tensors on an NVIDIA H100
and its data-plane verbs as hand-written Hopper kernels. Entry points
run on the card unless given ``device="cpu"``.
"""
