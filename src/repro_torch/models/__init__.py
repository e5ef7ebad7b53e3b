"""The model stack, for the families ported so far (RWKV-6 and the dense
attention decoders).

  layers.py      — dense_init, rms_norm, RoPE, attention (SDPA on the
                   card, the reference's blocked softmax as the plain
                   version), the SwiGLU / GELU MLPs, the LM-head loss
  rwkv.py        — RWKV-6 time and channel mixing (wkv6 kernel at prefill)
  transformer.py — the layer stack: prefill forward and one-token decode
  model.py       — build_model -> Model(init, prefill, init_cache,
                   decode_step, grow_cache)
"""
from repro_torch.models.model import LMParams, Model, build_model, make_batch

__all__ = ["LMParams", "Model", "build_model", "make_batch"]
