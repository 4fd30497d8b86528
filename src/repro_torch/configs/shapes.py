"""The four assigned input shapes.

``train_*`` shapes lower ``train_step``; ``decode_*`` shapes lower
``serve_step`` (one new token against a KV/SSM cache of ``seq_len``).
``long_500k`` requires sub-quadratic attention: SSM/hybrid archs run it
natively; pure-attention archs run a sliding-window variant (window 8192)
so the KV cache stays bounded.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


TRAIN_4K = InputShape("train_4k", 4_096, 256, "train")
PREFILL_32K = InputShape("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = InputShape("decode_32k", 32_768, 128, "decode")
LONG_500K = InputShape("long_500k", 524_288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}

# Sliding window applied to pure-attention architectures for long_500k.
LONG_CONTEXT_WINDOW = 8_192
