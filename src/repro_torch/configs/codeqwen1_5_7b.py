"""CodeQwen1.5-7B [hf:Qwen/CodeQwen1.5-7B] — qwen1.5-arch (MHA, kv=32).

A copy of the reference package's ``configs/codeqwen1_5_7b.py``.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="codeqwen1.5-7b",
    family="dense",
    citation="hf:Qwen/CodeQwen1.5-7B",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    d_ff=13440,
    vocab_size=92416,
    rope_theta=1000000.0,
)
