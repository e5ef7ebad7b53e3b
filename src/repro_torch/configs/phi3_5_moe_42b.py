"""Phi-3.5-MoE-42B-A6.6B [hf:microsoft/Phi-3.5-MoE-instruct] — 16 experts top-2.

A copy of the reference package's ``configs/phi3_5_moe_42b.py``.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    citation="hf:microsoft/Phi-3.5-MoE-instruct",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=6400,
    vocab_size=32064,
    moe=MoEConfig(num_experts=16, experts_per_token=2),
    moe_period=1,
)
