"""Llama-3-8B [arXiv:2407.21783] — dense GQA, 128k vocab.

A copy of the reference package's ``configs/llama3_8b.py``.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama3-8b",
    family="dense",
    citation="arXiv:2407.21783",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    rope_theta=500000.0,
)
