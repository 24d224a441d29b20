"""Assigned input-shape set (port of ``repro.configs.shapes``).

``decode_*`` / ``long_*`` lower a serve step (one new token against a KV
cache of length seq_len), NOT a train step (``serve.make_serve_step``).
``long_500k`` requires sub-quadratic attention.  ``launch/dryrun.py``
reckons every arch × shape cell (and the CRAIG ``select_pool`` cell).
"""
from __future__ import annotations

import dataclasses

__all__ = ["ShapeSpec", "SHAPES"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def tokens_per_step(self) -> int:
        if self.kind == "decode":
            return self.global_batch  # one new token per sequence
        return self.global_batch * self.seq_len


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}
