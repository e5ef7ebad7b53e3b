"""Jamba-v0.1-52B [arXiv:2403.19887] — Mamba+attention 1:7 interleave, MoE 16e top-2.

A copy of the reference package's ``configs/jamba_v0_1_52b.py``: 32
layers in 4 blocks of 8; one attention layer per block (position 7), the
rest Mamba; MoE MLP every other layer (period 2).
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    citation="arXiv:2403.19887",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    moe=MoEConfig(num_experts=16, experts_per_token=2),
    attn_period=8,
    moe_period=2,
    mamba_d_state=16,
    mamba_d_conv=4,
    mamba_expand=2,
)
