"""Architecture configuration system of the model stack.

A copy of the reference package's ``configs/base.py`` (the port imports
nothing of it): every architecture gets one ``<id>.py`` module exporting
CONFIG, an :class:`ArchConfig` with the exact published hyper-parameters
(source cited in ``citation``).  ``reduced()`` derives the CPU-smoke-test
variant (2 layers, d_model<=512, <=4 experts) of the same family.

Input shapes are global (pre-sharding).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    experts_per_token: int
    # DBRX-style fine-grained experts keep d_ff per expert; router is top-k.
    router_jitter: float = 0.0
    load_balance_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """One architecture from the assigned pool.

    ``family`` in {dense, moe, ssm, hybrid, encdec_audio, vlm}.
    For encdec/vlm/audio the *frontend* is a stub: inputs arrive as
    precomputed frame/patch embeddings (see DESIGN.md carve-out).
    """

    name: str
    family: str
    citation: str

    num_layers: int
    d_model: int
    num_heads: int           # 0 for attention-free (rwkv)
    num_kv_heads: int        # GQA kv heads; == num_heads for MHA
    d_ff: int
    vocab_size: int

    head_dim: Optional[int] = None          # default d_model // num_heads
    moe: Optional[MoEConfig] = None
    sliding_window: Optional[int] = None    # SWA window (h2o-danube)
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    mlp_style: str = "swiglu"   # 'swiglu' (3 mats) | 'gelu' (2 mats, GPT-style)

    # --- hybrid (jamba) ---
    attn_period: int = 0        # 1 attention layer every `attn_period` layers
    moe_period: int = 0         # MoE MLP every `moe_period` layers (else dense)
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2

    # --- rwkv6 ---
    attention_free: bool = False
    rwkv_head_dim: int = 64

    # --- encoder-decoder (seamless) ---
    encoder_layers: int = 0

    # --- modality frontend stub ---
    frontend: Optional[str] = None   # 'audio' | 'vision' | None
    frontend_tokens: int = 0         # number of embedding tokens the stub emits

    def __post_init__(self):
        if self.head_dim is None and self.num_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    # ------------------------------------------------------------------ #
    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks), for roofline."""
        d, L, V = self.d_model, self.num_layers, self.vocab_size
        emb = V * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        for i in range(L):
            per_layer += self._layer_params(i)
        enc = 0
        if self.encoder_layers:
            for i in range(self.encoder_layers):
                enc += self._attn_params() + self._dense_mlp_params() + 2 * d
        return emb + per_layer + enc + d  # final norm

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only routed experts)."""
        d, L, V = self.d_model, self.num_layers, self.vocab_size
        emb = V * d * (1 if self.tie_embeddings else 2)
        total = emb + d
        for i in range(L):
            total += self._layer_params(i, active_only=True)
        if self.encoder_layers:
            for i in range(self.encoder_layers):
                total += self._attn_params() + self._dense_mlp_params() + 2 * d
        return total

    # -- helpers ------------------------------------------------------- #
    def _attn_params(self) -> int:
        hd = self.head_dim or (self.d_model // max(self.num_heads, 1))
        q = self.d_model * self.num_heads * hd
        kv = 2 * self.d_model * self.num_kv_heads * hd
        o = self.num_heads * hd * self.d_model
        return q + kv + o

    def _dense_mlp_params(self) -> int:
        mats = 3 if self.mlp_style == "swiglu" else 2
        return mats * self.d_model * self.d_ff

    def _mamba_params(self) -> int:
        d_inner = self.mamba_expand * self.d_model
        return (
            2 * self.d_model * d_inner            # in_proj (x, z)
            + d_inner * self.mamba_d_conv         # conv
            + d_inner * (2 * self.mamba_d_state + 1 + self.mamba_d_state)  # x->B,C,dt + A
            + d_inner * self.d_model              # out_proj
        )

    def _rwkv_params(self) -> int:
        d = self.d_model
        return 4 * d * d + 2 * d * self.d_ff + 10 * d  # r,k,v,o + ffn + mixes/decay

    def _layer_params(self, i: int, active_only: bool = False) -> int:
        d = self.d_model
        norms = 2 * d
        if self.attention_free:
            return self._rwkv_params() + norms
        if self.attn_period > 0:  # jamba-style hybrid
            mixer = self._attn_params() if (i % self.attn_period == self.attn_period - 1) else self._mamba_params()
        else:
            mixer = self._attn_params()
        if self.moe is not None and (self.moe_period == 0 or i % self.moe_period == self.moe_period - 1):
            n_e = self.moe.experts_per_token if active_only else self.moe.num_experts
            mlp = n_e * self._dense_mlp_params() + d * self.moe.num_experts
        else:
            mlp = self._dense_mlp_params()
        return mixer + mlp + norms

    # ------------------------------------------------------------------ #
    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: same family, 2 layers, d_model<=512, <=4 experts."""
        d = min(self.d_model, 256)
        heads = 0 if self.attention_free else max(2, min(self.num_heads, 4))
        kv = 0 if self.attention_free else max(1, min(self.num_kv_heads, heads))
        hd = 0 if self.attention_free else d // heads
        moe = None
        if self.moe is not None:
            moe = MoEConfig(num_experts=4, experts_per_token=min(2, self.moe.experts_per_token))
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            num_layers=2 if self.attn_period == 0 else self.attn_period,  # keep 1 hybrid block
            d_model=d,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=hd if heads else None,
            d_ff=min(self.d_ff, 512),
            vocab_size=min(self.vocab_size, 1024),
            moe=moe,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else None,
            encoder_layers=2 if self.encoder_layers else 0,
            frontend_tokens=min(self.frontend_tokens, 16) if self.frontend_tokens else 0,
        )


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


INPUT_SHAPES: Tuple[InputShape, ...] = (
    InputShape("train_4k", 4096, 256, "train"),
    InputShape("prefill_32k", 32768, 32, "prefill"),
    InputShape("decode_32k", 32768, 128, "decode"),
    InputShape("long_500k", 524288, 1, "decode"),
)
