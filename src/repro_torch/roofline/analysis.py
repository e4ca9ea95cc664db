"""Roofline terms of a step on the card, and the port's counters that feed
them: the JAX package's ``roofline/analysis.py`` for PyTorch and the H100.

Three terms per (arch x shape x mesh), in seconds:

    compute    = flops / (chips * peak operations/s)
    memory     = bytes / (chips * memory bytes/s)
    collective = collective bytes / link bytes/s

``RooflineTerms`` and ``model_flops_for`` keep the reference's fields,
properties and arithmetic; the peaks are an input (``peaks_for`` of the
card that runs, known only at run time), and the port holds no number of
another chip.  The flops and bytes are the analytic model's
(``roofline/analytic.py``).

The reference's three XLA parsers have no PyTorch counterpart, since no
compiled artifact exists to read: ``cost_analysis_dict`` gives way to
``count_flops`` (``torch.utils.flop_counter`` over one call of the plain
path on the CPU), and ``collective_bytes`` / ``collective_bytes_while_aware``
(which sum the output buffers of the collectives in XLA's optimized HLO) to
``collective_bytes``, which reads the same quantity, by the same five kind
names, from what the port's collectives recorded as they ran
(``parallel/collectives.py``: ``OUT_BYTES``).

Imports neither torch nor the models until a function needs them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

# Published peaks of the H100 (dense, no sparsity), by part: memory
# bytes/s; operations/s by input type ("float32" outside the tensor cores);
# "link": the bytes/s one card sends to another in each direction.
#   SXM5 (NVIDIA H100 Tensor Core GPU data sheet, "H100 SXM" column): HBM3
#   3.35 TB/s, BF16 989 TFLOPS, FP32 67 TFLOPS, NVLink 900 GB/s (both
#   directions together: 450 GB/s each way).
#   PCIe (the same data sheet, "H100 PCIe" column): HBM2e 2.0 TB/s, BF16
#   756 TFLOPS, FP32 51 TFLOPS; without an NVLink bridge its link to another
#   card is PCIe Gen5 x16, 128 GB/s both directions together (64 GB/s each
#   way).
H100_PEAKS: Dict[str, Dict[str, float]] = {
    "H100 SXM": {"bytes": 3.35e12, "bfloat16": 989e12, "float32": 67e12,
                 "link": 450e9},
    "H100 PCIe": {"bytes": 2.0e12, "bfloat16": 756e12, "float32": 51e12,
                  "link": 64e9},
}

# ``torch.cuda.get_device_name()`` of each part
DEVICE_PARTS = {"NVIDIA H100 80GB HBM3": "H100 SXM",
                "NVIDIA H100 PCIe": "H100 PCIe"}

# the reference's collective kinds (HLO op names), in its order
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


def part_for(device_name: str) -> str:
    """The H100 part of ``torch.cuda.get_device_name()``; raises on a card
    this table does not know (no default: another card's peaks would make
    every bound wrong)."""
    part = DEVICE_PARTS.get(device_name.strip())
    if part is None:
        raise ValueError(f"no peaks for the card {device_name!r}: known are "
                         f"{sorted(DEVICE_PARTS)}")
    return part


def peaks_for(device_name: str) -> Dict[str, float]:
    """The peaks (``H100_PEAKS``) of the card named ``device_name``."""
    return dict(H100_PEAKS[part_for(device_name)])


@dataclasses.dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float            # whole-step FLOPs (all chips)
    hlo_bytes: float            # whole-step memory bytes (all chips)
    coll_bytes: float           # per-chip collective bytes
    coll_breakdown: Dict[str, int]
    model_flops: float          # 6*N*D (or 6*N_active*D) convention
    peak_flops: float           # operations/s per chip
    mem_bw: float               # memory bytes/s per chip
    link_bw: float              # bytes/s per link

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / (self.chips * self.peak_flops)

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / (self.chips * self.mem_bw)

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / self.link_bw

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def step_time(self) -> float:
        """Optimistic overlap model: step >= max(terms)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / max(self.hlo_flops, 1.0)

    @property
    def mfu(self) -> float:
        """Model FLOPs / (chips * peak * step_time) under the overlap model."""
        t = self.step_time
        if t <= 0:
            return 0.0
        return self.model_flops / (self.chips * self.peak_flops * t)

    def as_dict(self) -> Dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "hlo_flops": self.hlo_flops, "hlo_bytes": self.hlo_bytes,
            "coll_bytes": self.coll_bytes,
            "coll_breakdown": self.coll_breakdown,
            "model_flops": self.model_flops,
            "t_compute": self.t_compute, "t_memory": self.t_memory,
            "t_collective": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
            "mfu": self.mfu,
        }


def model_flops_for(cfg, shape, kind: str) -> float:
    """6*N*D convention (N = active params for MoE).

    train: D = global tokens, x3 for fwd+bwd (6*N*D already includes bwd:
    2*N*D fwd + 4*N*D bwd = 6*N*D).  prefill: 2*N*D.  decode: 2*N*B.
    Attention window/quadratic terms are intentionally excluded (the
    convention) — the useful_flops_ratio column surfaces the gap.
    """
    n_active = cfg.active_param_count()
    if kind == "train":
        d_tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * d_tokens
    if kind == "prefill":
        d_tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * d_tokens
    return 2.0 * n_active * shape.global_batch  # decode: one token each


def step_terms(cfg, shape, peaks: Dict[str, float]) -> RooflineTerms:
    """The analytic step of ``cfg`` at ``shape`` on one card of ``peaks``:
    the kernelized FLOPs (the causal half of attention, as K2 runs it) at
    the bf16 rate, the bytes with fp32 moments, and no collective."""
    from .analytic import step_bytes, step_flops
    return RooflineTerms(
        arch=cfg.name, shape=shape.name, mesh="1", chips=1,
        hlo_flops=step_flops(cfg, shape, kernelized=True),
        hlo_bytes=step_bytes(cfg, shape), coll_bytes=0.0,
        coll_breakdown=dict.fromkeys(COLLECTIVES, 0),
        model_flops=model_flops_for(cfg, shape, shape.kind),
        peak_flops=peaks["bfloat16"], mem_bw=peaks["bytes"],
        link_bw=peaks["link"])


def count_flops(fn, *args, **kwargs) -> int:
    """The floating-point operations of one call ``fn(*args, **kwargs)`` as
    ``torch.utils.flop_counter.FlopCounterMode`` counts them: its forward
    and, where the call runs one (a train step), its backward.

    It counts aten ops only.  The port's kernels on the card are bound
    through ctypes, not as aten ops, so a count there would leave K1-K4
    out: the call must run the plain path on the CPU, and any op that
    meets a CUDA tensor (or makes one) raises ``ValueError``."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten
    from torch.utils.flop_counter import FlopCounterMode

    def refuse(where, tree):
        leaves, _ = tree_flatten(tree)
        for t in leaves:
            if isinstance(t, torch.Tensor) and t.device.type == "cuda" or \
                    isinstance(t, torch.device) and t.type == "cuda" or \
                    isinstance(t, str) and t.startswith("cuda"):
                raise ValueError(
                    f"count_flops: {where} meets a CUDA tensor; the card's "
                    "kernels are not aten ops and would go uncounted: count "
                    "the plain path on the CPU")

    class _CPUOnly(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            refuse(str(func), (args, kwargs))
            return func(*args, **kwargs)

    refuse("the call's arguments", (args, kwargs))
    counter = FlopCounterMode(display=False)
    with counter, _CPUOnly():
        fn(*args, **kwargs)
    return int(counter.get_total_flops())


def collective_bytes() -> Dict[str, int]:
    """The output bytes of this rank's collectives since the port's counts
    were last reset (``parallel.collectives.reset_stats``), by the
    reference's kind names: ``all-gather``, ``all-reduce``,
    ``reduce-scatter``, ``all-to-all``, ``collective-permute``.  The
    reference's convention (output buffers, summed), so that a sharded
    step of the port reads against ``collective_bytes_while_aware`` of the
    JAX package's compiled step.  Collectives over an axis of one rank move
    nothing and count nothing, as XLA emits none."""
    from ..parallel import collectives as coll
    return {k: int(coll.OUT_BYTES.get(k, 0)) for k in COLLECTIVES}
