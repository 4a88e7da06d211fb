"""Roofline of a counted step on the NVIDIA H100 (port of
:mod:`repro.analysis.roofline`).

Three terms per (arch × shape) cell, as the reference's:

  compute    = Σ over dtypes of flops / that dtype's peak
  memory     = bytes / HBM rate
  collective = collective bytes / link rate

The flops and bytes are :mod:`.op_cost`'s (``OpCost``): the aten ops a
step dispatches and the kernels' own costs, where the reference reads
XLA's HLO text (``hlo_cost``).  One deliberate change: the compute term
divides each dtype's flops by that dtype's peak.  It equals the
reference's ``flops / PEAK_FLOPS`` when every flop is bf16; the port
keeps the reference's f32 attention einsums and norms, and with TF32
off (``device.ieee_f32``) they run at the IEEE f32 rate, so a single
bf16 peak would give a bound no run could reach.

``parse_collectives`` (the reference's parser of the collectives in HLO
text) has no counterpart: eager PyTorch has no program text, and on one
device there is no collective.

The constants are the H100 SXM5's (they replace the reference's TPU v5e
197 TFLOP/s bf16, 819 GB/s HBM and 50 GB/s a link).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

#: dense bf16 / fp16 on the tensor cores (NVIDIA H100 SXM5 data sheet:
#: 1,979 TFLOP/s with sparsity, half that dense)
PEAK_BF16_FLOPS = 989.4e12
#: IEEE f32 (FP32 on the CUDA cores, data sheet): every f32 product of
#: the port runs here with TF32 off, and so does elementwise work
PEAK_F32_FLOPS = 66.9e12
#: HBM3, 3.35 TB/s (data sheet)
HBM_BW = 3.35e12
#: NVLink 4, 900 GB/s a card in both directions: 450 GB/s each way
LINK_BW = 450e9
#: peak by dtype name (``OpCost.flops_by_dtype``'s keys); any other
#: dtype (integers, bool) at the f32 rate of the CUDA cores
PEAK_FLOPS: Dict[str, float] = {"bfloat16": PEAK_BF16_FLOPS,
                                "float16": PEAK_BF16_FLOPS,
                                "float32": PEAK_F32_FLOPS}


def peak_flops(dtype: str) -> float:
    return PEAK_FLOPS.get(dtype, PEAK_F32_FLOPS)


@dataclass
class Roofline:
    flops: float                 # per-device flops (dots, elementwise, ...)
    hbm_bytes: float             # per-device eager bytes
    collective_bytes: float      # per-device collective operand bytes
    wire_bytes: float
    chips: int
    raw_flops: float = 0.0       # the reference's raw cost_analysis(): none
    raw_bytes: float = 0.0
    unknown_trip_whiles: int = 0
    #: the flops by dtype; empty: all of ``flops`` at the bf16 peak
    flops_by_dtype: Dict[str, float] = field(default_factory=dict)

    @property
    def compute_s(self) -> float:
        if not self.flops_by_dtype:
            return self.flops / PEAK_BF16_FLOPS
        return sum(f / peak_flops(dt) for dt, f in self.flops_by_dtype.items())

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.collective_bytes / LINK_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def roofline_fraction(self) -> float:
        """Fraction of the step the compute term occupies at the binding
        bottleneck (1.0 = perfectly compute-bound at peak)."""
        return self.compute_s / max(self.bound_s, 1e-30)


def build_roofline(cost, chips: int) -> Roofline:
    """The roofline of an :class:`~.op_cost.OpCost` on ``chips`` cards
    (the reference's ``build_roofline(cost, hlo_text, chips)`` without
    the HLO text: the count is already per device)."""
    return Roofline(flops=cost.total_flops, hbm_bytes=cost.bytes_accessed,
                    collective_bytes=cost.collective_bytes,
                    wire_bytes=cost.collective_wire_bytes, chips=chips,
                    unknown_trip_whiles=cost.unknown_trip_whiles,
                    flops_by_dtype=dict(cost.flops_by_dtype))
