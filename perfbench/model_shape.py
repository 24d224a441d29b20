"""A configuration file's sizes, as both the program and the reference read
them.

The files under ``configs/`` hold the published ``config.json`` keys of a
dense decoder (``hidden_size``, ``num_hidden_layers``, …): a key cut to fit
the card (``reduced``) holds the value run, and ``as_run`` holds the
port's departures from the published architecture, which both the program
and the reference run (an untied head, no scalar multipliers).
:class:`Shape` is the view as run; the train runner turns it into the
port's ``ModelConfig`` and the reference reads it directly.  A multiplier
the port's plain block does not run is refused.
"""
from __future__ import annotations

import dataclasses

__all__ = ["Shape", "VOCAB_PAD"]

VOCAB_PAD = 128  # the port stores vocabulary tables at a multiple of 128 rows


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    qkv_bias: bool
    tied: bool
    rope_theta: float
    norm_eps: float
    compute_dtype: str

    @classmethod
    def from_config(cls, name: str, published: dict) -> "Shape":
        c = {**published, **published.get("as_run", {})}
        if c.get("hidden_act", "silu") != "silu" or c.get("model_family", "dense") != "dense":
            raise ValueError(f"{name}: only dense SwiGLU decoders are described by this file "
                             f"format (hidden_act {c.get('hidden_act')!r})")
        heads = int(c["num_attention_heads"])
        head_dim = int(c.get("head_dim") or int(c["hidden_size"]) // heads)
        plain = {"embedding_multiplier": 1.0, "residual_multiplier": 1.0, "logits_scaling": 1.0,
                 "attention_multiplier": head_dim ** -0.5}
        odd = {k: c[k] for k, v in plain.items() if k in c and abs(c[k] - v) > 1e-12 * v}
        if odd:
            raise ValueError(f"{name}: the port's dense block runs no multiplier {odd}")
        return cls(
            name=name,
            n_layers=int(c["num_hidden_layers"]),
            d_model=int(c["hidden_size"]),
            n_heads=heads,
            n_kv_heads=int(c["num_key_value_heads"]),
            head_dim=head_dim,
            d_ff=int(c["intermediate_size"]),
            vocab_size=int(c["vocab_size"]),
            qkv_bias=bool(c.get("qkv_bias", False)),
            tied=bool(c.get("tie_word_embeddings", False)),
            rope_theta=float(c["rope_theta"]),
            norm_eps=float(c["rms_norm_eps"]),
            compute_dtype=str(c["compute_dtype"]),
        )

    @property
    def padded_vocab(self) -> int:
        return -(-self.vocab_size // VOCAB_PAD) * VOCAB_PAD

    def leaves(self) -> list[tuple[str, tuple[int, ...], str, int]]:
        """Every parameter in the port's layout: (name, shape, init, fan),
        init 'normal' (scaled by 1/√fan), 'ones' or 'zeros'."""
        d, H, KV, hd, ff = self.d_model, self.n_heads, self.n_kv_heads, self.head_dim, self.d_ff
        out = []
        for i in range(self.n_layers):
            p = f"layers.{i}."
            out += [(p + "norm1.scale", (d,), "ones", 0),
                    (p + "mixer.wq", (d, H, hd), "normal", d),
                    (p + "mixer.wk", (d, KV, hd), "normal", d),
                    (p + "mixer.wv", (d, KV, hd), "normal", d),
                    (p + "mixer.wo", (H, hd, d), "normal", H * hd)]
            if self.qkv_bias:
                out += [(p + "mixer.bq", (H, hd), "zeros", 0),
                        (p + "mixer.bk", (KV, hd), "zeros", 0),
                        (p + "mixer.bv", (KV, hd), "zeros", 0)]
            out += [(p + "norm2.scale", (d,), "ones", 0),
                    (p + "ffn.w_in", (d, 2 * ff), "normal", d),
                    (p + "ffn.w_out", (ff, d), "normal", ff)]
        out.append(("embed", (self.padded_vocab, d), "normal", d))
        out.append(("final_norm.scale", (d,), "ones", 0))
        if not self.tied:
            out.append(("unembed", (self.padded_vocab, d), "normal", d))
        return out

    def group_of(self, name: str) -> str:
        """The weight group a leaf is drawn in: one per layer, the
        embedding, the head."""
        return ".".join(name.split(".")[:2]) if name.startswith("layers.") else name

    def matmul_params(self, head: bool) -> int:
        """Parameters that enter a matrix product once a token: every
        projection and FFN weight, and with ``head`` the unembedding at the
        real vocabulary (the embedding is a lookup)."""
        d, H, KV, hd, ff = self.d_model, self.n_heads, self.n_kv_heads, self.head_dim, self.d_ff
        layer = d * hd * (H + 2 * KV) + H * hd * d + 3 * d * ff
        return self.n_layers * layer + (self.vocab_size * d if head else 0)
