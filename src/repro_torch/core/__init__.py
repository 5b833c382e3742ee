"""The paper's primary contribution (PyTorch port): bound-and-bottleneck
analysis, the floorline performance model, and the two-stage optimization
methodology — plus the population-based mapping search built on them."""

from repro_torch.core.analytical import (Bottleneck, LayerConfig, OpCosts,
                                         OpCounts, layer_op_counts,
                                         min_cores_for_layer,
                                         predict_bottleneck)
from repro_torch.core.floorline import (FloorlineModel, OptimizationMove,
                                        WorkloadPoint, fit_floorline,
                                        floorline_curve)
from repro_torch.core.metrics import LoadStats, WorkloadMetrics, proxy_gap

# The optimizer and search layers sit above the simulator (they import
# repro_torch.neuromorphic, whose modules import repro_torch.core.metrics),
# so they are re-exported lazily to keep the imports acyclic.
_LAZY = {name: "repro_torch.core.partitioner" for name in (
    "Evaluator", "OptimizationResult", "OptStep", "SimEvaluator",
    "can_split", "optimize_partitioning")}
_LAZY.update({name: "repro_torch.core.guidance" for name in (
    "LayerGuidance", "floorline_layer_guidance", "floorline_layer_weights")})
_LAZY.update({name: "repro_torch.core.search" for name in (
    "Candidate", "EpsParetoArchive", "MoveTables", "Population",
    "SearchResult", "decode", "decode_population", "encode",
    "encode_population", "evolutionary_search", "greedy_then_evolve",
    "knee_point", "move_tables", "pareto_ranks", "seeded_population")})


def __getattr__(name):
    if name in _LAZY:
        import importlib
        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(
        f"module 'repro_torch.core' has no attribute {name!r}")


__all__ = [
    "Bottleneck", "LayerConfig", "OpCosts", "OpCounts", "layer_op_counts",
    "min_cores_for_layer", "predict_bottleneck",
    "FloorlineModel", "OptimizationMove", "WorkloadPoint", "fit_floorline",
    "floorline_curve",
    "LoadStats", "WorkloadMetrics", "proxy_gap",
    "Evaluator", "OptimizationResult", "OptStep", "SimEvaluator", "can_split",
    "optimize_partitioning",
    "LayerGuidance", "floorline_layer_guidance", "floorline_layer_weights",
    "Candidate", "EpsParetoArchive", "MoveTables", "Population",
    "SearchResult", "decode", "decode_population", "encode",
    "encode_population", "evolutionary_search", "greedy_then_evolve",
    "knee_point", "move_tables", "pareto_ranks", "seeded_population",
]
