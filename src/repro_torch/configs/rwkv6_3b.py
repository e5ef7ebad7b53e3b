"""RWKV-6 (Finch) 3B [arXiv:2404.05892] — attention-free, data-dependent decay.

A copy of the reference package's ``configs/rwkv6_3b.py``.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-3b",
    family="ssm",
    citation="arXiv:2404.05892",
    num_layers=32,
    d_model=2560,
    num_heads=0,
    num_kv_heads=0,
    d_ff=8960,
    vocab_size=65536,
    attention_free=True,
    rwkv_head_dim=64,
)
