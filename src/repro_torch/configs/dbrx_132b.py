"""DBRX-132B [hf:databricks/dbrx-base] — 16 experts top-4, fine-grained MoE.

A copy of the reference package's ``configs/dbrx_132b.py``.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="dbrx-132b",
    family="moe",
    citation="hf:databricks/dbrx-base",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=10752,
    vocab_size=100352,
    moe=MoEConfig(num_experts=16, experts_per_token=4),
    moe_period=1,
)
