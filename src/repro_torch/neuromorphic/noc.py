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
The population functions build every candidate's routing structures at
once, as batched float64 tensors on the device; every entry is an exact
small-integer count, so they equal the per-candidate tables bit for bit.
A bytes-keyed LRU (:func:`flow_cache_clear`) keeps each candidate's rows:
the evolutionary search carries survivors between generations, so most of
a generation's genomes were routed already and skip the build.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import threading

import numpy as np
import torch

from repro_torch.device import resolve_device
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


def _layer_dest(lid: torch.Tensor, router: torch.Tensor,
                alive: torch.Tensor, last: torch.Tensor, n_layers: int,
                R: int) -> torch.Tensor:
    """(K, n_layers, R) float64 destination-router core counts of a source
    core of each layer: the next layer's live cores per router, and for a
    candidate's last layer (``last`` (K,)) the chip I/O port at router 0.
    ``lid``/``router``/``alive`` are (K, Ncap) per-slot layer ids, router
    ids and float live flags (dead slots carry in-range ids)."""
    K = lid.shape[0]
    cnt = torch.zeros((K, (n_layers + 1) * R), dtype=torch.float64,
                      device=lid.device)
    cnt.scatter_add_(1, lid * R + router, alive)
    nxt = cnt.reshape(K, n_layers + 1, R)[:, 1:]
    io = torch.zeros(R, dtype=torch.float64, device=lid.device)
    io[0] = 1.0
    l = torch.arange(n_layers, device=lid.device)
    return torch.where((l[None, :] == last[:, None])[..., None], io, nxt)


def _fold(lid, router, alive, last, n_layers: int, inc3: torch.Tensor,
          hops2: torch.Tensor):
    """(PL, ph, dup) of padded (K, Ncap) slot rows: each layer's
    destination counts folded through the routing geometry once (L x R x
    R work per candidate, not a per-core gather), then gathered per core.
    Exact in float64: every entry is a small-integer count."""
    K, ncap = lid.shape
    R = inc3.shape[0]
    dest = _layer_dest(lid, router, alive, last, n_layers, R)  # (K, L, R)
    M = torch.einsum("kld,sdr->klsr", dest, inc3)               # (K, L, R, R)
    at = lid * R + router
    PL = M.reshape(K, n_layers * R, R).gather(
        1, at[..., None].expand(K, ncap, R)) * alive[..., None]
    ph = (dest @ hops2.T).reshape(K, -1).gather(1, at) * alive
    dup = dest.sum(dim=2).gather(1, lid) * alive
    return PL, ph, dup


def flow_structures_rows(lid: torch.Tensor, router: torch.Tensor,
                         alive: torch.Tensor, n_layers: int,
                         inc3: torch.Tensor, hops2: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    """Candidates' routing structures, built on their device: given padded
    per-slot layer ids ``lid``, router ids ``router`` and float live flags
    ``alive`` ((K, Ncap), or (Ncap,) for one candidate) of networks with
    ``n_layers`` layers, returns ``(PL, ph, dup)``: per-core router-load
    incidence (router loads are ``msgs @ PL``), per-core hop factors
    (total hops ``msgs @ ph``) and unicast duplication factors, shaped
    (K, Ncap, R) / (K, Ncap) / (K, Ncap), or without K.  ``inc3`` and
    ``hops2`` are :func:`incidence_tables` as float64 tensors.  The
    results equal :func:`router_incidence_population`'s bit for bit; dead
    slots (which must carry in-range ids) get zero rows."""
    one = lid.dim() == 1
    if one:
        lid, router, alive = lid[None], router[None], alive[None]
    last = torch.full((lid.shape[0],), n_layers - 1, device=lid.device)
    PL, ph, dup = _fold(lid, router, alive, last, n_layers, inc3, hops2)
    return (PL[0], ph[0], dup[0]) if one else (PL, ph, dup)


def _genome_slots(cores_rows, phys_rows, grid: tuple[int, int],
                  n_cores_phys: int, n_pad: int, dev: torch.device):
    """Ragged (cores, expressed physical slots) rows -> padded (K, n_pad)
    layer ids, router ids and float live flags, plus each candidate's last
    layer index (K,) and the widest layer count."""
    rows, cols = grid
    cpr = max(1, n_cores_phys // (rows * cols))
    K = len(cores_rows)
    if K != len(phys_rows):
        raise ValueError("cores_rows and phys_rows disagree on K")
    L = max(len(c) for c in cores_rows)
    lid = np.zeros((K, n_pad), np.int64)
    router = np.zeros((K, n_pad), np.int64)
    alive = np.zeros((K, n_pad), np.float64)
    for k, (cores, phys) in enumerate(zip(cores_rows, phys_rows)):
        cores = np.asarray(cores, np.int64)
        n = int(cores.sum())
        lid[k, :n] = np.repeat(np.arange(len(cores)), cores)
        router[k, :n] = np.asarray(phys, np.int64)[:n] // cpr
        alive[k, :n] = 1.0
    last = [len(c) - 1 for c in cores_rows]
    on = lambda a: torch.as_tensor(a, device=dev)
    return on(lid), on(router), on(alive), on(np.asarray(last)), L


#: Bytes-keyed LRU of per-candidate routing rows, keyed by the table's
#: kind, the chip, the device and the genome's bytes (core counts and
#: expressed physical slots), guarded by a lock so population pricing can
#: be driven from worker threads.
_FLOW_CACHE: collections.OrderedDict = collections.OrderedDict()
_FLOW_CACHE_MAX = 4096
_FLOW_CACHE_LOCK = threading.Lock()


def flow_cache_clear() -> None:
    """Drop the population routing cache (tests / memory pressure)."""
    with _FLOW_CACHE_LOCK:
        _FLOW_CACHE.clear()


def _cached_rows(kind: str, build, cores_rows, phys_rows,
                 grid: tuple[int, int], n_cores_phys: int, n_pad: int,
                 dev: torch.device):
    """``build(cores_rows, phys_rows)``'s tensors (each with a leading K
    axis and n_pad rows per candidate) for every candidate, through the
    LRU: hits are pasted from their cached live rows, the misses built in
    one batch and stored."""
    cores_rows = [np.asarray(c, np.int32) for c in cores_rows]
    phys_rows = [np.asarray(p, np.int32) for p in phys_rows]
    if len(cores_rows) != len(phys_rows):
        raise ValueError("cores_rows and phys_rows disagree on K")
    keys = [(kind, grid, n_cores_phys, str(dev), c.tobytes(), p.tobytes())
            for c, p in zip(cores_rows, phys_rows)]
    hits, misses = {}, []
    with _FLOW_CACHE_LOCK:
        for k, key in enumerate(keys):
            hit = _FLOW_CACHE.get(key)
            if hit is None:
                misses.append(k)
            else:
                _FLOW_CACHE.move_to_end(key)
                hits[k] = hit
    built = build([cores_rows[k] for k in misses],
                  [phys_rows[k] for k in misses]) if misses else None
    if misses:
        with _FLOW_CACHE_LOCK:
            for j, k in enumerate(misses):
                _FLOW_CACHE[keys[k]] = tuple(t[j] for t in built)
                _FLOW_CACHE.move_to_end(keys[k])
            while len(_FLOW_CACHE) > _FLOW_CACHE_MAX:
                _FLOW_CACHE.popitem(last=False)
    if not hits:
        return built
    K = len(keys)
    lens = [int(cores_rows[k].sum()) for k in hits]
    at = torch.as_tensor(np.concatenate(
        [k * n_pad + np.arange(n) for k, n in zip(hits, lens)]),
        device=dev)
    outs = []
    for i, like in enumerate(next(iter(hits.values()))):
        out = torch.zeros((K * n_pad,) + tuple(like.shape[1:]),
                          dtype=like.dtype, device=dev)
        out.index_copy_(0, at, torch.cat([h[i][:n] for h, n in
                                          zip(hits.values(), lens)]))
        out = out.reshape((K, n_pad) + tuple(like.shape[1:]))
        if misses:
            out.index_copy_(0, torch.as_tensor(misses, device=dev), built[i])
        outs.append(out)
    return tuple(outs)


def flow_matrix_population(cores_rows, phys_rows, grid: tuple[int, int],
                           n_cores_phys: int, n_pad: int, *,
                           cache: bool = True,
                           device: "str | torch.device" = "cuda"
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched :func:`_flow_matrix`: every candidate's routing structure
    at once.  ``cores_rows`` holds K per-candidate layer core counts (any
    layer count), ``phys_rows`` the K expressed physical slot assignments
    (row k of length ``sum(cores_rows[k])``), ``n_pad`` the logical-core
    padding width.  Returns ``(P, dup)`` on ``device``: (K, n_pad, R*R)
    and (K, n_pad) float64, row k equal to candidate k's ``_flow_matrix``
    and zero beyond its logical cores.  A core's flow row is the one-hot
    of its router times its layer's destination counts, so the whole
    population's misses are one scatter; ``cache=False`` builds them all
    and stores nothing."""
    dev = resolve_device(device)
    R = grid[0] * grid[1]

    def build(cores_rows, phys_rows):
        lid, router, alive, last, L = _genome_slots(
            cores_rows, phys_rows, grid, n_cores_phys, n_pad, dev)
        dest = _layer_dest(lid, router, alive, last, L, R)       # (K, L, R)
        K = lid.shape[0]
        rowd = dest.gather(1, lid[..., None].expand(K, n_pad, R)) \
            * alive[..., None]                                   # (K, n, R)
        P = torch.zeros((K, n_pad, R, R), dtype=torch.float64, device=dev)
        P.scatter_(2, router[..., None, None].expand(K, n_pad, 1, R),
                   rowd[:, :, None, :])
        dup = dest.sum(dim=2).gather(1, lid) * alive
        return P.reshape(K, n_pad, R * R), dup
    if not cache:
        return build(cores_rows, phys_rows)
    return _cached_rows("flow", build, cores_rows, phys_rows, grid,
                        n_cores_phys, n_pad, dev)


def router_incidence_population(cores_rows, phys_rows,
                                grid: tuple[int, int], n_cores_phys: int,
                                n_pad: int, *,
                                device: "str | torch.device" = "cuda"
                                ) -> tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """Path-incidence-folded :func:`flow_matrix_population`: ``(PL, ph,
    dup)`` with ``PL = P @ path_incidence`` (K, n_pad, R) (router loads
    are ``msgs @ PL``; the (T, R*R) flow tensor never materializes),
    ``ph = P @ pair_hops`` (K, n_pad) and the duplication factors, float64
    on ``device``.  Integer counts make the fold exact.  Each candidate's
    folded rows are kept in the LRU."""
    dev = resolve_device(device)

    def build(cores_rows, phys_rows):
        lid, router, alive, last, L = _genome_slots(
            cores_rows, phys_rows, grid, n_cores_phys, n_pad, dev)
        inc3, hops2 = (torch.as_tensor(t, device=dev)
                       for t in incidence_tables(grid))
        return _fold(lid, router, alive, last, L, inc3, hops2)
    return _cached_rows("fold", build, cores_rows, phys_rows, grid,
                        n_cores_phys, n_pad, dev)


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
