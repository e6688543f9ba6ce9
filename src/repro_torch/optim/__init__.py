"""The optimizer: AdamW on fp32 master copies."""
