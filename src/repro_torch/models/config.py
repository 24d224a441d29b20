"""Model configuration (port of ``repro.models.config``).

The port's own copy of the reference's ``ModelConfig``, field for field,
with ``padded_vocab``, ``layer_kinds`` and ``param_count``.  The port runs
every family of the reference: dense, MoE, hybrid (Griffin: 'rglru' and
sliding-window 'local_attn' layers), ssm (xLSTM: 'mlstm' and 'slstm'),
vlm (the embeddings frontend with M-RoPE) and audio (the embeddings
frontend with per-codebook heads).  :func:`validate_config` raises
``ValueError`` for what the reference itself rejects: an unknown remat
policy or layer kind.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

__all__ = ["ModelConfig", "validate_config"]

REMAT_POLICIES = ("nothing", "dots", "full")
LAYER_KINDS = ("attn", "local_attn", "rglru", "mlstm", "slstm")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture description (one instance per configs/<arch>.py).

    ``block_pattern`` is the repeating unit of layer kinds; the layer stack is
    pattern tiled to ``n_layers`` (remainder layers get their own params —
    see blocks.py).  Kinds: 'attn' (global), 'local_attn' (sliding window),
    'mlstm', 'slstm', 'rglru'.  Every layer kind is followed by an FFN unless
    ``d_ff == 0`` (xLSTM: projections live inside the cell).
    """

    name: str
    family: str  # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0  # 0 → d_model // n_heads
    block_pattern: tuple[str, ...] = ("attn",)
    # attention details
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    window: int | None = None  # for 'local_attn' layers
    mrope_sections: tuple[int, int, int] | None = None
    # ffn
    activation: str = "silu"
    gated_ffn: bool = True
    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    # recurrent
    d_rnn: int = 0  # rg-lru width (0 → d_model)
    conv_width: int = 4
    mlstm_chunk: int = 256
    # frontend / heads
    frontend: Literal["tokens", "embeddings"] = "tokens"
    n_codebooks: int = 1  # musicgen: parallel output heads
    tie_embeddings: bool = False
    # norm
    norm: Literal["rmsnorm", "layernorm"] = "rmsnorm"
    norm_eps: float = 1e-6
    # training-time details
    scan_layers: bool = True  # reference only: the port always runs per-layer
    remat_policy: str = "nothing"  # nothing | dots | full
    blockwise_threshold: int = 8192
    attn_chunk_q: int = 1024
    attn_chunk_kv: int = 1024
    logit_chunk: int = 1024  # chunked CE vocab-matmul chunk (sequence dim)
    # citation provenance
    source: str = ""

    vocab_pad_multiple: int = 128  # pad vocab for clean model-axis sharding

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def layer_kinds(self) -> tuple[str, ...]:
        reps = -(-self.n_layers // len(self.block_pattern))  # ceil
        return (self.block_pattern * reps)[: self.n_layers]

    @property
    def is_subquadratic(self) -> bool:
        """True if no layer is global full attention (long_500k eligible)."""
        return all(k != "attn" for k in self.layer_kinds)

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks + heads)."""
        d, hd = self.d_model, self.head_dim
        total = 0
        if self.frontend == "tokens":
            total += self.vocab_size * d
        total += self.n_codebooks * d * self.vocab_size  # unembed head(s)
        for kind in self.layer_kinds:
            if kind in ("attn", "local_attn"):
                total += d * hd * (self.n_heads + 2 * self.n_kv_heads)
                total += self.n_heads * hd * d
                if self.qkv_bias:
                    total += hd * (self.n_heads + 2 * self.n_kv_heads)
                if self.qk_norm:
                    total += 2 * hd
            elif kind == "rglru":
                r = self.d_rnn or d
                total += 3 * d * r + 2 * r * r + self.conv_width * r
            elif kind == "mlstm":
                di = self.n_heads * hd
                total += d * 2 * di + di * d + 3 * di * di + di * 2 * self.n_heads
            elif kind == "slstm":
                di = self.n_heads * hd
                total += d * 4 * di + 4 * self.n_heads * hd * hd + di * d
            if self.d_ff and kind not in ("mlstm", "slstm"):
                if self.n_experts:
                    total += d * self.n_experts  # router
                    per = d * (2 if self.gated_ffn else 1) * self.d_ff + self.d_ff * d
                    total += self.n_experts * per
                    total += self.n_shared_experts * per
                else:
                    total += d * (2 if self.gated_ffn else 1) * self.d_ff
                    total += self.d_ff * d
            total += 2 * d  # the two pre-norms
        total += d  # final norm
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k + shared experts only)."""
        if not self.n_experts:
            return self.param_count()
        d = self.d_model
        per = d * (2 if self.gated_ffn else 1) * self.d_ff + self.d_ff * d
        inactive = (self.n_experts - self.top_k) * per * sum(
            1 for k in self.layer_kinds
        )
        return self.param_count() - inactive


def validate_config(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` where the reference rejects ``cfg``: a remat
    policy other than 'nothing', 'dots' or 'full'
    (``repro.models.blocks._remat_policy``), or a layer kind it has no
    mixer for (``repro.models.blocks._init_layer``)."""
    if cfg.remat_policy not in REMAT_POLICIES:
        raise ValueError(f"{cfg.name}: unknown remat policy {cfg.remat_policy!r}")
    bad = sorted(set(cfg.layer_kinds) - set(LAYER_KINDS))
    if bad:
        raise ValueError(f"{cfg.name}: unknown layer kinds {bad}")
