"""Floorline-style three-term bound of one step on one card (PyTorch port
of ``repro.core.tpu_floorline``).

The paper's floorline places a neuromorphic workload by (max per-core
synops, max per-core activation computes, NoC traffic).  A training or
serving step is the same shape of machine — units where the slowest term
bounds the step — with the terms:

    compute term    = sum over dtypes of matmul FLOPs per chip / the
                      dtype's peak FLOP/s
    memory term     = HBM bytes per chip    / HBM bandwidth
    collective term = collective bytes per chip / link bandwidth

The counts come from :mod:`repro_torch.core.hlo_cost`, which counts the
aten ops that one eager call dispatches (the port has no HLO).  The
reference's constants are a TPU v5e's; here the chip's peaks are data, by
default an H100 SXM's (NVIDIA's data sheet, dense): 989 TFLOP/s in bf16
and fp16 on the tensor cores, 67 TFLOP/s in float32 outside them (the
port runs float32 products with TF32 off), 3.35 TB/s of HBM3 and 450 GB/s
per direction of NVLink 4.  On one card
the collective term is 0, and it stays a term.  The dominant term is the
step's bottleneck state, as a position on the floorline is;
``recommendation()`` mirrors the paper's (a)/(b)/(c) optimization moves.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional

from repro_torch.core.analytical import Bottleneck

PEAK_FLOPS = 989e12          # bf16 FLOP/s, tensor cores
HBM_BW = 3.35e12             # bytes/s
LINK_BW = 450e9              # bytes/s per direction, NVLink 4
# the card's other rates, for bounds of kernels that run outside bf16:
# float32 outside the tensor cores, TF32 and int8 on them
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_INT8_OPS = 1979e12
# matrix-product peaks by operand dtype, for the compute term
PEAKS_BY_DTYPE = {"bfloat16": PEAK_FLOPS, "float16": PEAK_FLOPS,
                  "float32": PEAK_FP32_FLOPS, "int8": PEAK_INT8_OPS}

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16, "f8e4m3fn": 1, "f8e5m2": 1,
}

_COLL_RE = re.compile(
    r"=\s+(?:\([^)]*\)\s+)?\S*?\s*"
    r"(all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start)?\(")
_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_GROUPS_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")


def _shape_bytes(dtype: str, dims: str) -> int:
    if dtype not in _DTYPE_BYTES:
        return 0
    n = 1
    for d in dims.split(","):
        if d:
            n *= int(d)
    return n * _DTYPE_BYTES[dtype]


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_kind: dict[str, int]
    count_by_kind: dict[str, int]
    ops: list[dict]                      # per-op detail (kind, bytes, groups)

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())


def parse_collectives(hlo_text: str) -> CollectiveStats:
    """Sum operand sizes of every collective in (post-SPMD) HLO text.

    The per-device module's operand shapes are per-shard, so the totals are
    bytes-per-chip.  `-done` ops are skipped (they alias their `-start`).
    """
    bytes_by: dict[str, int] = {}
    count_by: dict[str, int] = {}
    ops: list[dict] = []
    for line in hlo_text.splitlines():
        if "-done(" in line:
            continue
        m = _COLL_RE.search(line)
        if not m:
            continue
        kind = m.group(1)
        # operand shapes: everything inside the call parens
        call = line[m.end() - 1:]
        operand_bytes = sum(_shape_bytes(d, s)
                            for d, s in _SHAPE_RE.findall(
                                call.split("),", 1)[0] + ")"))
        g = _GROUPS_RE.search(line)
        group = int(g.group(2)) if g else None
        bytes_by[kind] = bytes_by.get(kind, 0) + operand_bytes
        count_by[kind] = count_by.get(kind, 0) + 1
        ops.append({"kind": kind, "bytes": operand_bytes, "group": group})
    return CollectiveStats(bytes_by, count_by, ops)


@dataclasses.dataclass
class RooflineTerms:
    """The three floorline terms for one (arch x shape) step on
    ``n_chips`` chips whose peaks are ``peak_flops``, ``hbm_bw`` and
    ``link_bw``.  Given ``flops_by_dtype`` (the products' FLOPs by operand
    dtype), the compute term prices each dtype at its own peak in
    ``PEAKS_BY_DTYPE``; without it, every FLOP at ``peak_flops``."""

    flops_per_chip: float
    hbm_bytes_per_chip: float
    collective_bytes_per_chip: float
    model_flops: float = 0.0             # 6*N*D (dense) / 6*N_active*D (MoE)
    n_chips: int = 1
    label: str = ""
    peak_flops: float = PEAK_FLOPS
    hbm_bw: float = HBM_BW
    link_bw: float = LINK_BW
    flops_by_dtype: Optional[dict] = None

    @property
    def t_compute(self) -> float:
        if self.flops_by_dtype is None:
            return self.flops_per_chip / self.peak_flops
        unknown = set(self.flops_by_dtype) - set(PEAKS_BY_DTYPE)
        if unknown:
            raise ValueError(f"no matrix-product peak for {sorted(unknown)}")
        return sum(f / PEAKS_BY_DTYPE[d]
                   for d, f in self.flops_by_dtype.items())

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes_per_chip / self.hbm_bw

    @property
    def t_collective(self) -> float:
        return self.collective_bytes_per_chip / self.link_bw

    @property
    def bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def dominant(self) -> Bottleneck:
        terms = {Bottleneck.COMPUTE: self.t_compute,
                 Bottleneck.MEMORY: self.t_memory,
                 Bottleneck.TRAFFIC: self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (counted FLOPs x chips): how much counted compute
        is 'useful' — catches remat/redundancy waste (and, when > 1, flops
        the counter does not see, e.g. inside a ctypes-bound kernel)."""
        total = self.flops_per_chip * self.n_chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Achievable fraction of the compute roofline if the program hit
        its bound: useful-compute-time / bound-time."""
        useful_t = (self.model_flops / self.n_chips) / self.peak_flops
        return useful_t / self.bound if self.bound else 0.0

    def recommendation(self) -> str:
        d = self.dominant
        if d == Bottleneck.MEMORY:
            return ("memory-bound: cut HBM traffic — fuse/remat less, "
                    "larger microbatch, bf16/f8 buffers, better layouts")
        if d == Bottleneck.COMPUTE:
            return ("compute-bound: cut redundant FLOPs (remat policy, "
                    "duplicated projections) or accept — at the roofline")
        return ("collective-bound: re-shard to shrink collective bytes "
                "(SP dispatch, reduce-scatter instead of all-reduce, "
                "overlap via microbatch pipelining)")

    def row(self) -> dict:
        return {
            "label": self.label,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bound_s": self.bound,
            "dominant": self.dominant.value,
            "model_flops": self.model_flops,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def model_flops_for(cfg, shape_kind: str, seq_len: int, batch: int,
                    n_new_tokens: int = 1) -> float:
    """6*N*D rule (forward+backward for train; 2*N*D forward-only for
    prefill/decode), N = active params."""
    active = (cfg.active_param_count()
              if hasattr(cfg, "active_param_count") else cfg.param_count())
    if shape_kind == "train":
        return 6.0 * active * seq_len * batch
    if shape_kind == "prefill":
        return 2.0 * active * seq_len * batch
    return 2.0 * active * batch * n_new_tokens


def terms_from_step(count, *, model_flops: float, n_chips: int = 1,
                    label: str = "") -> RooflineTerms:
    """Three terms from :func:`repro_torch.core.hlo_cost.analyze`'s count
    of one step (the reference's ``terms_from_compiled``): every counted
    byte is an HBM byte, since eager mode fuses nothing, and each dtype's
    products are priced at its own peak."""
    return RooflineTerms(
        flops_per_chip=count.flops, hbm_bytes_per_chip=count.hbm_bytes,
        collective_bytes_per_chip=count.collective_bytes,
        model_flops=model_flops, n_chips=n_chips, label=label,
        flops_by_dtype=dict(count.flops_by_dtype))
