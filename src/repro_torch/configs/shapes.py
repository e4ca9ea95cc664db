"""The four assigned input shapes, per LM architecture.

  train_4k     seq_len=4096    global_batch=256   (training;    train_step)
  prefill_32k  seq_len=32768   global_batch=32    (inference;   prefill_step)
  decode_32k   seq_len=32768   global_batch=128   (decode: one new token with
                                                   a KV cache of seq_len)
  long_500k    seq_len=524288  global_batch=1     (long-context decode; only
                                                   sub-quadratic archs)

``applicable()`` implements the assignment's skip rules: long_500k requires
sub-quadratic attention (SSM/hybrid/linear); full-attention archs skip it
(documented in DESIGN.md §Arch-applicability).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from .base import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def is_subquadratic(cfg: ModelConfig) -> bool:
    if cfg.family == "ssm":
        return True
    if cfg.family == "hybrid" and cfg.sliding_window > 0:
        return True
    return False


def applicable(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """(runs?, reason-if-skipped)."""
    if shape.name == "long_500k" and not is_subquadratic(cfg):
        return False, "SKIP(full-attn): quadratic attention at 524k context"
    return True, ""


def all_cells() -> List[Tuple[str, str]]:
    from .base import ARCH_IDS
    return [(a, s) for a in ARCH_IDS for s in SHAPE_ORDER]
