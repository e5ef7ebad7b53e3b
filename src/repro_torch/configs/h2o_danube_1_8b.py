"""H2O-Danube-1.8B [arXiv:2401.16818] — llama+mistral mix with sliding-window attention.

A copy of the reference package's ``configs/h2o_danube_1_8b.py``.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-1.8b",
    family="dense",
    citation="arXiv:2401.16818",
    num_layers=24,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    d_ff=6912,
    vocab_size=32000,
    sliding_window=4096,
)
