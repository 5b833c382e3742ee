"""Network-on-chip model: router-shared core placement + XY-routed congestion.

Several neurocores share each NoC router tile, so an *ordered* mapping that
places a layer's (equally busy) cores on consecutive slots concentrates its
injection load on a few routers; a *strided* mapping spreads same-layer
cores across router paths (paper §V-F, Fig. 8).

Messages from every core of layer l are duplicated (unicast per
destination) to every core of layer l+1; the last layer's outputs route to
the chip I/O port at router 0.  Router load counts injections, transits and
deliveries under dimension-ordered (X-then-Y) routing.

The routing tables (path incidence, hop counts, per-candidate flow
matrices) are small integer tables kept as host numpy; the per-step
message counts they are applied to are float64 tensors on the device.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.neuromorphic.partition import Partition
from repro_torch.neuromorphic.platform import ChipProfile


@dataclasses.dataclass(frozen=True)
class Mapping:
    """logical core index -> physical core slot."""

    phys: tuple[int, ...]
    name: str = "custom"

    def __post_init__(self):
        if len(set(self.phys)) != len(self.phys):
            raise ValueError("mapping assigns two logical cores to one slot")


def ordered_mapping(part: Partition, profile: ChipProfile) -> Mapping:
    """Sequential placement — the congestion-prone Loihi-1 heuristic."""
    n = part.total_cores
    if n > profile.n_cores:
        raise ValueError("partition exceeds physical cores")
    return Mapping(tuple(range(n)), name="ordered")


def strided_mapping(part: Partition, profile: ChipProfile) -> Mapping:
    """Strided placement: consecutive logical cores land on different
    routers, so same-layer cores use disjoint router paths."""
    n = part.total_cores
    if n > profile.n_cores:
        raise ValueError("partition exceeds physical cores")
    n_routers = n_router_tiles(profile)
    cpr = cores_per_router(profile)
    order = [r + n_routers * s for s in range(cpr) for r in range(n_routers)]
    return Mapping(tuple(int(_router_slot_to_core(o, profile))
                         for o in order[:n]), name="strided")


def random_mapping(part: Partition, profile: ChipProfile,
                   rng: np.random.Generator) -> Mapping:
    """Uniform random placement (numpy RNG, as the reference draws it)."""
    n = part.total_cores
    if n > profile.n_cores:
        raise ValueError("partition exceeds physical cores")
    phys = rng.permutation(profile.n_cores)[:n]
    return Mapping(tuple(int(p) for p in phys), name="random")


def cores_per_router(profile: ChipProfile) -> int:
    rows, cols = profile.grid
    return max(1, profile.n_cores // (rows * cols))


def n_router_tiles(profile: ChipProfile) -> int:
    rows, cols = profile.grid
    return rows * cols


def core_router(core: int, profile: ChipProfile) -> int:
    return core // cores_per_router(profile)


def _router_slot_to_core(order_idx: int, profile: ChipProfile) -> int:
    """order_idx encodes (slot within router, router) -> physical core id."""
    n_routers = n_router_tiles(profile)
    slot, router = order_idx // n_routers, order_idx % n_routers
    return router * cores_per_router(profile) + slot


@functools.lru_cache(maxsize=16)
def _path_incidence(grid: tuple[int, int]) -> np.ndarray:
    """(R*R, R) matrix: entry[(src*R+dst), node] = 1 if the X-then-Y route
    from src to dst touches router ``node`` (inject/transit/deliver)."""
    rows, cols = grid
    R = rows * cols
    inc = np.zeros((R * R, R), np.float32)
    for s in range(R):
        r1, c1 = divmod(s, cols)
        for d in range(R):
            r2, c2 = divmod(d, cols)
            nodes = [s]
            step = 1 if c2 >= c1 else -1
            for c in range(c1 + step, c2 + step, step) if c1 != c2 else []:
                nodes.append(r1 * cols + c)
            step = 1 if r2 >= r1 else -1
            for r in range(r1 + step, r2 + step, step) if r1 != r2 else []:
                nodes.append(r * cols + c2)
            inc[s * R + d, nodes] = 1.0
    return inc


@functools.lru_cache(maxsize=16)
def _pair_hops(grid: tuple[int, int]) -> np.ndarray:
    """(R*R,) Manhattan hop counts between router pairs."""
    rows, cols = grid
    R = rows * cols
    r = np.arange(R)
    rr, cc = r // cols, r % cols
    return (np.abs(rr[:, None] - rr[None, :])
            + np.abs(cc[:, None] - cc[None, :])).astype(np.float32).reshape(-1)


@functools.lru_cache(maxsize=16)
def incidence_tables(grid: tuple[int, int]) -> tuple[np.ndarray, np.ndarray]:
    """Per-grid routing geometry: ``inc3[src, dst, node]`` (R, R, R) path
    incidence and ``hops2[src, dst]`` (R, R) Manhattan hops, float64."""
    rows, cols = grid
    R = rows * cols
    inc3 = _path_incidence(grid).astype(np.float64).reshape(R, R, R)
    hops2 = _pair_hops(grid).astype(np.float64).reshape(R, R)
    return inc3, hops2


def _on(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A host routing table as a float64 tensor beside ``like``."""
    return torch.as_tensor(a, dtype=torch.float64, device=like.device)


@dataclasses.dataclass
class NocTraffic:
    """One timestep's routed traffic (float64 tensors)."""

    router_loads: torch.Tensor    # (R,) packets touching each router
    total_hops: torch.Tensor      # 0-d link traversals (for hop energy)
    inject_per_core: torch.Tensor  # (n_logical,) packets injected

    @property
    def max_router_load(self) -> float:
        return max(float(self.router_loads.max()), 0.0)


@dataclasses.dataclass
class NocTrafficBatch:
    """Routed traffic for ALL timesteps at once (time-major, float64)."""

    router_loads: torch.Tensor    # (T, R)
    total_hops: torch.Tensor      # (T,)
    inject_per_core: torch.Tensor  # (T, n_logical)

    @property
    def max_router_load(self) -> torch.Tensor:
        """(T,) busiest-router load per step."""
        return self.router_loads.amax(dim=1).clamp_min(0.0)


@functools.lru_cache(maxsize=64)
def _flow_matrix(cores: tuple[int, ...], phys: tuple[int, ...],
                 grid: tuple[int, int],
                 n_cores_phys: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-(partition, mapping) routing structure: ``P`` (n_logical, R*R)
    such that ``msgs @ P`` is the flattened router->router flow tensor,
    and ``dup`` the per-core unicast duplication factor."""
    rows, cols = grid
    R = rows * cols
    cpr = max(1, n_cores_phys // R)
    routers = np.asarray([p // cpr for p in phys])
    n_logical = int(sum(cores))
    P = np.zeros((n_logical, R * R), np.float64)
    dup = np.zeros(n_logical, np.float64)
    offsets = np.concatenate([[0], np.cumsum(cores)]).astype(int)
    n_layers = len(cores)
    for l in range(n_layers):
        src_idx = np.arange(offsets[l], offsets[l + 1])
        if l + 1 < n_layers:
            dst_routers = routers[offsets[l + 1]:offsets[l + 2]]
        else:
            dst_routers = np.asarray([0])        # chip I/O port
        dup[src_idx] = len(dst_routers)
        for g in src_idx:
            np.add.at(P[g], routers[g] * R + dst_routers, 1.0)
    return P, dup


def route_batch(part: Partition, mapping: Mapping, msgs_out: torch.Tensor,
                profile: ChipProfile) -> NocTrafficBatch:
    """Route every timestep's messages at once.  ``msgs_out`` is the
    (T, n_logical) per-core message-count matrix in logical core order;
    the flow tensor is one matmul against the cached per-core flow
    incidence, router loads and hops one matmul each against the path
    tables.  Counts are integers in float64, so the results are
    bit-identical to T :func:`route_step` calls."""
    P, dup = _flow_matrix(part.cores, mapping.phys, profile.grid,
                          profile.n_cores)
    m = msgs_out.to(torch.float64)
    flow_flat = m @ _on(P, m)                                   # (T, R*R)
    loads = flow_flat @ _on(_path_incidence(profile.grid), m)   # (T, R)
    hops = flow_flat @ _on(_pair_hops(profile.grid), m)         # (T,)
    return NocTrafficBatch(router_loads=loads, total_hops=hops,
                           inject_per_core=m * _on(dup, m))


def route_step(part: Partition, mapping: Mapping,
               msgs_out_per_core: list[torch.Tensor],
               profile: ChipProfile) -> NocTraffic:
    """Route one timestep's messages.  ``msgs_out_per_core[l]`` holds
    message counts per core of layer l; each message is unicast-duplicated
    to every core of layer l+1; the final layer exits at router 0."""
    grid = profile.grid
    R = n_router_tiles(profile)
    like = msgs_out_per_core[0]
    flow = torch.zeros(R * R, dtype=torch.float64, device=like.device)
    inject = torch.zeros(part.total_cores, dtype=torch.float64,
                         device=like.device)
    offsets = np.concatenate([[0], np.cumsum(part.cores)]).astype(int)
    routers = np.asarray([core_router(p, profile) for p in mapping.phys])
    n_layers = len(part.cores)
    for l in range(n_layers):
        msgs = msgs_out_per_core[l].to(torch.float64)
        if l + 1 < n_layers:
            dst_routers = routers[offsets[l + 1]:offsets[l + 2]]
        else:
            dst_routers = np.asarray([0])        # chip I/O port
        inject[offsets[l]:offsets[l + 1]] += msgs * len(dst_routers)
        flat = (routers[offsets[l]:offsets[l + 1]][:, None] * R
                + dst_routers[None, :]).reshape(-1)
        flow.index_add_(0, torch.as_tensor(flat, device=like.device),
                        msgs[:, None].expand(-1, len(dst_routers))
                        .reshape(-1))
    loads = flow @ _on(_path_incidence(grid), flow)
    hops = flow @ _on(_pair_hops(grid), flow)
    return NocTraffic(router_loads=loads, total_hops=hops,
                      inject_per_core=inject)
