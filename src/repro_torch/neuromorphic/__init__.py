"""Neuromorphic chip simulator (PyTorch port): networks, chip profiles,
partitioning, NoC routing, layer-compute backends, the timestep cost
model and the model-zoo frontend."""

from repro_torch.neuromorphic.compute import (DEFAULT_COMPUTE, DenseCompute,
                                              EventCompute, LayerCompute,
                                              get_compute, register_compute)
from repro_torch.neuromorphic.frontend import (AttnSpec, CompiledNetwork,
                                               LayerSpec, attention_probe,
                                               compile_network,
                                               excluded_params, lowering_spec)
from repro_torch.neuromorphic.network import (BatchCounters, CounterMaps,
                                              SimLayer, SimNetwork,
                                              fc_network, make_inputs,
                                              network_from_numpy,
                                              programmed_fc_network)
from repro_torch.neuromorphic.noc import (Mapping, flow_matrix_population,
                                          flow_structures_rows,
                                          incidence_tables, ordered_mapping,
                                          random_mapping, route_batch,
                                          route_step,
                                          router_incidence_population,
                                          strided_mapping)
from repro_torch.neuromorphic.partition import (Partition, minimal_partition,
                                                validate_partition)
from repro_torch.neuromorphic.platform import (NEURON_COST, PROFILES,
                                               ChipProfile, akd1000_like,
                                               loihi2_like, speck_like)
from repro_torch.neuromorphic.timestep import (LayerStageTimes,
                                               PopulationPricer,
                                               PricingCache, SimReport,
                                               layer_stage_times,
                                               precompute_pricing,
                                               price_candidate,
                                               price_population_device,
                                               simulate, simulate_population)

__all__ = [
    "DEFAULT_COMPUTE", "DenseCompute", "EventCompute", "LayerCompute",
    "get_compute", "register_compute",
    "AttnSpec", "CompiledNetwork", "LayerSpec", "attention_probe",
    "compile_network", "excluded_params", "lowering_spec",
    "BatchCounters", "CounterMaps", "SimLayer", "SimNetwork", "fc_network",
    "make_inputs", "network_from_numpy", "programmed_fc_network",
    "Mapping", "flow_matrix_population", "flow_structures_rows",
    "incidence_tables", "ordered_mapping", "random_mapping", "route_batch",
    "route_step", "router_incidence_population", "strided_mapping",
    "Partition", "minimal_partition", "validate_partition",
    "NEURON_COST", "PROFILES", "ChipProfile", "akd1000_like", "loihi2_like",
    "speck_like",
    "LayerStageTimes", "PopulationPricer", "PricingCache", "SimReport",
    "layer_stage_times",
    "precompute_pricing", "price_candidate", "price_population_device",
    "simulate", "simulate_population",
]
