"""The shared building blocks of the port's model stack (the reference's
``models/layers.py``): the initializer, RMSNorm with the reference's
custom backward, RoPE, attention (prefill, decode and the layer), the
dense MLPs and the chunked LM-head loss.  ``layer_norm`` and
cross-attention wait for the encoder-decoder (ROADMAP A11).

Attention.  The reference computes it outside any Pallas kernel, as a
blocked online softmax in plain JAX (``flash_attention``); here
:func:`flash_attention` calls ``scaled_dot_product_attention`` (SDPA) and
:func:`flash_attention_ref` is the reference's blocked online softmax in
torch operations, the plain version the tests and ``chip_smoke.py`` hold
it against.  On the card each call names its SDPA backend through
``torch.nn.attention.sdpa_kernel``, so a backend that cannot run raises
instead of dropping to the math backend:

* causal, the window not binding (S ≤ window): ``flash`` (bf16 / fp16)
  with ``is_causal``, or ``efficient`` for f32, which flash does not take;
* a binding window (S > window): ``efficient+band`` — query blocks of
  ``min(1024, window)`` tokens, each against its key band
  ``[start − window, end)`` under a boolean band mask, so no (S, S) score
  tensor is ever formed;
* decode (one query a sequence): the valid cache slots as keys, the
  G = H / Hkv query heads of a KV head as G query rows, no mask
  (``decode:flash`` / ``decode:efficient``).

On the CPU the same calls run with SDPA's own backend choice.  The layout
at the public functions is the reference's: (B, S, H, Dh), weights
(d, H·Dh).  Precision follows the reference: scores and softmax in f32,
probabilities cast to v's dtype before P·V, the output in q's dtype.
:data:`SDPA_BACKENDS` counts the calls by path.
"""
from __future__ import annotations

import collections
from typing import Mapping, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

_F32 = torch.float32


def dense_init(gen: torch.Generator, shape: Sequence[int], dtype: torch.dtype,
               scale: float = 1.0) -> torch.Tensor:
    """normal(shape) · scale/√fan_in with fan_in = shape[0], drawn in f32
    from ``gen`` on its device, then cast to ``dtype``.  Not the
    reference's bits (its threefry normals); weights cross between the
    packages through :mod:`repro_torch.bridge`."""
    std = scale / (shape[0] ** 0.5)
    return (torch.randn(tuple(shape), generator=gen, device=gen.device)
            * std).to(dtype)


def _rms_norm(x: torch.Tensor, weight: torch.Tensor,
              eps: float) -> torch.Tensor:
    x32 = x.to(_F32)
    var = x32.square().mean(-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * weight.to(_F32)).to(x.dtype)


class _RMSNorm(torch.autograd.Function):
    """The reference's ``_rms_norm_bwd``: the backward in f32, dx cast to
    x's dtype and dw to the weight's, so a bf16 residual stream keeps a
    bf16 cotangent."""

    @staticmethod
    def forward(ctx, x, weight, eps):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return _rms_norm(x, weight, eps)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        x32, dy32, w32 = x.to(_F32), dy.to(_F32), weight.to(_F32)
        s = torch.rsqrt(x32.square().mean(-1, keepdim=True) + ctx.eps)
        wdy = w32 * dy32
        dx = s * wdy - (s * s * s) * x32 * (x32 * wdy).sum(
            -1, keepdim=True) / x.shape[-1]
        dw = ((x32 * s) * dy32).sum(dim=tuple(range(x.dim() - 1)))
        return dx.to(x.dtype), dw.to(weight.dtype), None


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm over the last axis, computed in f32 and cast back to x's
    dtype, with the reference's custom backward."""
    return _RMSNorm.apply(x, weight, eps)


def _chunk_ce(xb: torch.Tensor, emb_out: torch.Tensor, lb: torch.Tensor,
              mb: torch.Tensor) -> torch.Tensor:
    logits = (xb @ emb_out).to(_F32)                       # (B, chunk, V)
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, lb[..., None])[..., 0]
    return ((logz - gold) * mb).sum()


def lm_head_loss(x: torch.Tensor, emb_out: torch.Tensor, labels: torch.Tensor,
                 mask: torch.Tensor, *, chunk: int = 2048) -> torch.Tensor:
    """Mean next-token cross entropy: x (B, S, d) final hidden states,
    emb_out (d, V), labels (B, S) integer, mask (B, S) {0, 1}.  Softmax CE
    over sequence chunks of min(``chunk``, S) tokens (a ragged S takes one
    chunk), each recomputed in the backward (non-reentrant checkpoint), so
    at most one chunk's (B, chunk, V) f32 logits are alive; the sum over
    max(mask.sum(), 1)."""
    S = x.shape[1]
    chunk = min(chunk, S)
    if S % chunk:
        chunk = S
    total = torch.zeros((), dtype=_F32, device=x.device)
    for c0 in range(0, S, chunk):
        sl = slice(c0, c0 + chunk)
        total = total + checkpoint(_chunk_ce, x[:, sl], emb_out, labels[:, sl],
                                   mask[:, sl], use_reentrant=False)
    return total / torch.clamp(mask.sum().to(_F32), min=1.0)


# --------------------------------------------------------------------- #
# RoPE
# --------------------------------------------------------------------- #


def rope_freqs(head_dim: int, theta: float,
               device: Optional[torch.device] = None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=_F32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, Dh); positions: (..., S) integer.  Rotates the two
    halves of the head (not interleaved pairs), in f32, cast back to x's
    dtype."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)          # (Dh/2,)
    angles = positions[..., None].to(_F32) * freqs            # (..., S, Dh/2)
    cos = torch.cos(angles)[..., None, :]                     # (..., S, 1, Dh/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.to(_F32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------- #
# attention
# --------------------------------------------------------------------- #

_NEG_INF = -1e30
#: query rows a block of the banded (binding-window) path
BAND_Q_BLOCK = 1024
#: SDPA calls by path since the last :func:`reset_sdpa_backends`
SDPA_BACKENDS: collections.Counter = collections.Counter()


def reset_sdpa_backends() -> None:
    SDPA_BACKENDS.clear()


def _sdpa(q, k, v, *, path: str, causal: bool = False, mask=None,
          scale: float) -> torch.Tensor:
    """SDPA over (B, H, Sq, Dh) q and (B, H, Skv, Dh) k, v.  On the card
    only the backend ``path`` names (its first word before ``+``; a
    ``decode:`` prefix is dropped) may run; on the CPU SDPA picks."""
    if q.device.type == "cuda":
        from torch.nn.attention import SDPBackend, sdpa_kernel
        name = path.split(":")[-1].split("+")[0]
        backend = {"flash": SDPBackend.FLASH_ATTENTION,
                   "efficient": SDPBackend.EFFICIENT_ATTENTION}[name]
        with sdpa_kernel([backend]):
            out = F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, is_causal=causal, scale=scale)
    else:
        path = "cpu:" + path
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                             is_causal=causal, scale=scale)
    SDPA_BACKENDS[path] += 1
    return out


def _dense_backend(dtype: torch.dtype) -> str:
    return "flash" if dtype in (torch.bfloat16, torch.float16) else "efficient"


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """Attention of q (B, S, H, Dh) over k, v (B, S, Hkv, Dh), H % Hkv == 0
    (GQA): causal, and limited to ``window`` keys (qpos − kpos < window)
    where given; (B, S, H, Dh) in q's dtype.  K and V are repeated to the
    H query heads (one copy a call).  See the module docstring for the
    backend each case takes."""
    B, S, H, Dh = q.shape
    Hkv = k.shape[2]
    if H % Hkv or k.shape[1] != S:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)}: "
                         "need H % Hkv == 0 and one sequence length")
    if window is not None and not causal:
        raise ValueError("a window needs causal attention")
    G = H // Hkv
    scale = Dh ** -0.5

    def heads(t):                                  # (B, S, Hkv, Dh) -> (B, H, S, Dh)
        if G > 1:
            t = t[:, :, :, None].expand(B, S, Hkv, G, Dh).reshape(B, S, H, Dh)
        return t.transpose(1, 2)

    qh, kh, vh = q.transpose(1, 2), heads(k), heads(v)
    if window is None or S <= window:
        out = _sdpa(qh, kh, vh, path=_dense_backend(q.dtype), causal=causal,
                    scale=scale)
    else:
        blk = min(BAND_Q_BLOCK, window)
        outs = []
        for s0 in range(0, S, blk):
            s1 = min(s0 + blk, S)
            k0 = max(0, s0 - window)
            qpos = torch.arange(s0, s1, device=q.device)[:, None]
            kpos = torch.arange(k0, s1, device=q.device)[None, :]
            band = (qpos >= kpos) & (qpos - kpos < window)
            outs.append(_sdpa(qh[:, :, s0:s1], kh[:, :, k0:s1],
                              vh[:, :, k0:s1], path="efficient+band",
                              mask=band, scale=scale))
        out = torch.cat(outs, dim=2)
    return out.transpose(1, 2).to(q.dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: Optional[int] = None,
                        q_block: int = 512, kv_block: int = 512,
                        q_offset: int = 0) -> torch.Tensor:
    """The reference's blocked online-softmax attention in torch
    operations: q (B, Sq, H, Dh), k, v (B, Skv, Hkv, Dh) -> (B, Sq, H, Dh)
    in q's dtype; scores, the running max, denominator and accumulator in
    f32, probabilities cast to v's dtype before P·V.  Key blocks that the
    mask leaves empty for a whole query block are skipped: in the
    reference they change nothing (their p is 0, or is wiped by the next
    block's correction exp(−1e30 − m) = 0)."""
    B, Sq, H, Dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = Dh ** -0.5
    q_block, kv_block = min(q_block, Sq), min(kv_block, Skv)
    if Sq % q_block or Skv % kv_block:
        raise ValueError(f"seq lens ({Sq},{Skv}) must divide blocks "
                         f"({q_block},{kv_block})")
    dev = q.device
    qg = q.reshape(B, Sq, Hkv, G, Dh).to(_F32)
    out = torch.empty((B, Sq, Hkv, G, Dh), dtype=_F32, device=dev)
    for q0 in range(0, Sq, q_block):
        qb = qg[:, q0:q0 + q_block]
        qpos = q_offset + q0 + torch.arange(q_block, device=dev)
        acc = torch.zeros((B, Hkv, G, q_block, Dh), dtype=_F32, device=dev)
        m = torch.full((B, Hkv, G, q_block), _NEG_INF, dtype=_F32, device=dev)
        l = torch.zeros((B, Hkv, G, q_block), dtype=_F32, device=dev)
        for k0 in range(0, Skv, kv_block):
            kpos = k0 + torch.arange(kv_block, device=dev)
            mask = torch.ones((q_block, kv_block), dtype=torch.bool,
                              device=dev)
            if causal:
                mask &= qpos[:, None] >= kpos[None, :]
            if window is not None:
                mask &= qpos[:, None] - kpos[None, :] < window
            if not bool(mask.any()):
                continue
            kb = k[:, k0:k0 + kv_block].to(_F32)
            vb = v[:, k0:k0 + kv_block]
            s = torch.einsum("bqhgd,bkhd->bhgqk", qb, kb) * scale
            s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(vb.dtype).to(_F32),
                              vb.to(_F32))
            acc = acc * corr[..., None] + pv
            m = m_new
        o = acc / torch.clamp(l[..., None], min=1e-30)      # (B,Hkv,G,Qb,Dh)
        out[:, q0:q0 + q_block] = o.permute(0, 3, 1, 2, 4)
    return out.reshape(B, Sq, H, Dh).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, n_valid: int, *,
                     window: Optional[int] = None) -> torch.Tensor:
    """One query token q (B, 1, H, Dh) against a cache (B, Smax, Hkv, Dh)
    whose slots 0..n_valid−1 are valid (and, with ``window``, only the
    last ``window`` of them count): (B, 1, H, Dh) in q's dtype.  The
    valid slots are a contiguous slice, so SDPA sees them as its keys with
    no mask, and each KV head's G query heads as G query rows."""
    B, _, H, Dh = q.shape
    Hkv = k_cache.shape[2]
    G = H // Hkv
    lo = 0 if window is None else max(0, n_valid - window)
    qg = q.reshape(B, Hkv, G, Dh)
    kv = [c[:, lo:n_valid].transpose(1, 2) for c in (k_cache, v_cache)]
    out = _sdpa(qg, *kv, path="decode:" + _dense_backend(q.dtype),
                scale=Dh ** -0.5)
    return out.reshape(B, 1, H, Dh).to(q.dtype)


def init_attention(gen: torch.Generator, cfg,
                   dtype: torch.dtype) -> dict:
    """wq, wk, wv, wo, drawn in that order from ``gen``."""
    d, H, Hkv, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {"wq": dense_init(gen, (d, H * Dh), dtype),
            "wk": dense_init(gen, (d, Hkv * Dh), dtype),
            "wv": dense_init(gen, (d, Hkv * Dh), dtype),
            "wo": dense_init(gen, (H * Dh, d), dtype)}


def attention_fwd(params: Mapping[str, torch.Tensor], x: torch.Tensor, cfg,
                  positions: torch.Tensor
                  ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Full-sequence (train / prefill) attention of x (B, S, d) at
    ``positions`` ((S,) or (B, S)), under the config's window:
    (out (B, S, d), (k, v)) with the RoPE'd k and v (B, S, Hkv, Dh) for
    the cache."""
    B, S, _ = x.shape
    H, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = (x @ params["wq"]).reshape(B, S, H, Dh)
    k = (x @ params["wk"]).reshape(B, S, Hkv, Dh)
    v = (x @ params["wv"]).reshape(B, S, Hkv, Dh)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    o = flash_attention(q, k, v, causal=True, window=cfg.sliding_window)
    return o.reshape(B, S, H * Dh) @ params["wo"], (k, v)


def attention_decode(params: Mapping[str, torch.Tensor], x: torch.Tensor,
                     cfg, cache_k: torch.Tensor, cache_v: torch.Tensor,
                     cur_len: int, *, slot: int, n_valid: int):
    """One-token decode of x (B, 1, d) at position ``cur_len``: writes its
    RoPE'd k and its v **in place** into ``cache_k`` / ``cache_v``
    (B, Smax, Hkv, Dh) at ``slot`` and attends to slots 0..n_valid−1 with
    no window (a window's ring holds exactly its keys).  Returns
    (out, cache_k, cache_v)."""
    B = x.shape[0]
    H, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if not 0 <= slot < cache_k.shape[1]:
        raise ValueError(f"slot {slot} is outside the cache's "
                         f"{cache_k.shape[1]} slots: grow the cache first")
    pos = torch.full((B, 1), cur_len, dtype=torch.int64, device=x.device)
    q = apply_rope((x @ params["wq"]).reshape(B, 1, H, Dh), pos,
                   cfg.rope_theta)
    k = apply_rope((x @ params["wk"]).reshape(B, 1, Hkv, Dh), pos,
                   cfg.rope_theta)
    v = (x @ params["wv"]).reshape(B, 1, Hkv, Dh)
    cache_k[:, slot] = k[:, 0].to(cache_k.dtype)
    cache_v[:, slot] = v[:, 0].to(cache_v.dtype)
    o = decode_attention(q, cache_k, cache_v, n_valid)
    return o.reshape(B, 1, H * Dh) @ params["wo"], cache_k, cache_v


# --------------------------------------------------------------------- #
# MLPs
# --------------------------------------------------------------------- #


def init_mlp(gen: torch.Generator, cfg, dtype: torch.dtype,
             d_ff: Optional[int] = None) -> dict:
    """SwiGLU: w_gate, w_up, w_down; GELU: w_up, w_down; drawn in that
    order from ``gen``."""
    d, f = cfg.d_model, d_ff or cfg.d_ff
    names = (("w_gate", "w_up") if cfg.mlp_style == "swiglu" else ("w_up",))
    p = {n: dense_init(gen, (d, f), dtype) for n in names}
    p["w_down"] = dense_init(gen, (f, d), dtype)
    return p


def mlp_fwd(params: Mapping[str, torch.Tensor], x: torch.Tensor,
            cfg) -> torch.Tensor:
    """SwiGLU: silu(x·W_gate) ⊙ (x·W_up) · W_down; GELU (tanh form, as
    ``jax.nn.gelu``): gelu(x·W_up) · W_down."""
    if cfg.mlp_style == "swiglu":
        return (F.silu(x @ params["w_gate"]) * (x @ params["w_up"])) \
            @ params["w_down"]
    return F.gelu(x @ params["w_up"], approximate="tanh") @ params["w_down"]
