"""Granite-20B-Code [arXiv:2405.04324] — llama-arch, code; GQA with 1 KV head (MQA).

A copy of the reference package's ``configs/granite_20b.py``.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-20b",
    family="dense",
    citation="arXiv:2405.04324",
    num_layers=52,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    mlp_style="gelu",   # GPT-BigCode-style 2-matrix MLP (d_ff = 4*d_model)
)
