"""Model-zoo workload frontend: compile a model config into a priceable
:class:`~repro_torch.neuromorphic.network.SimNetwork`.

Every number the floorline produces is a function of exact event counters
(MACs / weight fetches / NoC messages), so "running a real model" on the
simulator means emitting a layer stack whose *counters* reproduce the
per-token cost arithmetic of the architecture — not its floating-point
function.  :func:`compile_network` takes any
:mod:`repro_torch.configs.registry` arch id (or a raw
:class:`~repro_torch.models.common.ModelCfg` /
:class:`~repro_torch.models.encdec.EncDecCfg`) and lowers it block by
block onto the ``SimLayer`` vocabulary:

**Execution model.**  One simulator timestep = one decoded token at steady
state.  The residual stream (width ``d_model``) is the feed-forward chain
backbone; each block becomes a short chain of ``fc`` layers mapping
``d_model -> ... -> d_model``.  The embedding lookup is the network input
and RMSNorm scales fold into the adjacent projection, so norms and
embeddings appear only in :func:`excluded_params`, the documented
remainder that makes ``sum(param nnz) + excluded_params(cfg) ==
cfg.param_count()`` an identity.

**Attention** lowers through the flash-attention kernel contract
(:mod:`repro_torch.kernels.flash_attn`) into an fc-equivalent counter map
over a steady-state context of ``S = min(window, seq_len)`` positions:

* ``qkv``    ``(d, q+2kv)`` dense — the per-token Q/K/V projections.
* ``scores`` ``(q+2kv, H*S)`` block-sparse — score neuron ``(h, s)`` reads
  exactly its head's ``head_dim`` query lanes: ``H*S*head_dim`` MACs/token.
* ``values`` ``(H*S, q)`` block-sparse — output lane ``(h, j)`` reads its
  head's ``S`` score neurons: ``q*S`` MACs/token.
* ``out``    ``(q, d)`` dense.

The ``scores``/``values`` weights are stand-ins for cache contents (role
``"kv"``, zero parameter nnz); each lowering site is recorded as an
:class:`AttnSpec` so :func:`attention_probe` can run the flash-attention
kernel against its plain version at exactly the lowered (heads, head_dim,
seq) shape (``compile_network(verify_attention=True)`` does this inline).

**SSD / RG-LRU** mixers put their recurrence on the simulator's stateful
neuron models (``"ssm"`` by default, ``recurrent_neuron="sd_relu"`` maps
the state stream onto sigma-delta messaging instead).

**MoE** blocks emit each expert as a contiguous column block plus
``n_experts`` router-logit columns; a static ``msg_gate`` keeps exactly
``top_k + n_shared`` expert blocks messaging, so the down projection's
event-driven MACs are ``(top_k + n_shared) * d_ff * d``.

Weights and gates are numpy draws from ``np.random.default_rng(seed)`` in
the JAX package's order, so a seed gives bit-identical networks in both
packages.  Each layer is built on the host and moved to ``device`` at
once; no host copy of the network is kept.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import trace
from repro_torch.core import prng
from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attn.ops import flash_attention
from repro_torch.kernels.flash_attn.ref import flash_attention_ref
from repro_torch.models.common import ModelCfg, MoECfg, RGLRUCfg, SSDCfg
from repro_torch.models.encdec import EncDecCfg
from repro_torch.neuromorphic.network import SimLayer, SimNetwork, make_inputs

DEFAULT_SEQ_LEN = 16        # steady-state decode context for smoke pricing
_RECURRENT_NEURONS = ("ssm", "sd_relu")
#: Largest |kernel - plain| :func:`compile_network` accepts per probe.
PROBE_ATOL = 2e-4


# ===================================================================== specs

@dataclasses.dataclass(frozen=True)
class AttnSpec:
    """One attention lowering site == one flash_attn kernel instance."""

    name: str
    heads: int
    kv_heads: int
    head_dim: int
    seq: int                        # steady-state context length S
    causal: bool = True
    window: int | None = None
    softcap: float | None = None
    cross: bool = False             # encoder-decoder cross attention


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """Closed-form description of one emitted fc layer.

    ``nnz``/``macs_per_token`` are *arithmetic* (derived from the config,
    not from built weights); compile asserts the built mask reproduces
    them.  ``macs_per_token`` assumes the dense-activity token pipeline
    (every ungated neuron messaging, the compile default).
    """

    name: str
    fanin: int
    width: int
    structure: tuple                # mask family, see _structure_mask
    role: str                       # "param" | "kv" | "state" | "head"
    nnz: int                        # structural nonzero synapses
    param_nnz: int                  # contribution to cfg.param_count()
    macs_per_token: int             # exact MACs per timestep
    neuron_model: str = "relu"
    gate: tuple | None = None       # ("moe", E, shared, top_k, d_ff)


# ----------------------------------------------------------- mask structures

def _structure_nnz(structure: tuple, fanin: int, width: int) -> int:
    kind = structure[0]
    if kind == "dense":
        return fanin * width
    if kind == "first_rows":
        return structure[1] * width
    if kind in ("attn_scores", "attn_values"):
        _, heads, seq, head_dim = structure
        return heads * seq * head_dim
    if kind == "moe_down":
        _, n_experts_total, n_router, d_ff = structure
        return n_experts_total * d_ff * width
    if kind == "ssd_state":
        _, d_inner, head_dim, n_groups, d_state = structure
        return d_inner * (2 * d_state + 2)
    raise ValueError(f"unknown structure {structure!r}")


def _structure_mask(spec: LayerSpec) -> np.ndarray:
    """0/1 synapse mask (fanin, width) realizing ``spec.structure``."""
    kind = spec.structure[0]
    m = np.zeros((spec.fanin, spec.width), np.float32)
    if kind == "dense":
        m[:] = 1.0
    elif kind == "first_rows":
        m[: spec.structure[1], :] = 1.0
    elif kind == "attn_scores":
        # fanin layout [q | k | v]; neuron (h, s) reads head h's query lanes
        _, heads, seq, hd = spec.structure
        for h in range(heads):
            m[h * hd:(h + 1) * hd, h * seq:(h + 1) * seq] = 1.0
    elif kind == "attn_values":
        # fanin = H*S score lanes; output lane (h, j) reads head h's scores
        _, heads, seq, hd = spec.structure
        for h in range(heads):
            m[h * seq:(h + 1) * seq, h * hd:(h + 1) * hd] = 1.0
    elif kind == "moe_down":
        # fanin layout [expert 0 (wi|wg) .. expert n-1 (wi|wg) | router];
        # only the wi half of each expert projects down
        _, n_tot, n_router, f = spec.structure
        for e in range(n_tot):
            m[e * 2 * f: e * 2 * f + f, :] = 1.0
    elif kind == "ssd_state":
        # fanin layout [x (di) | z (di) | B (G*st) | C (G*st) | dt (h)]
        _, di, hd, groups, st = spec.structure
        n_heads = di // hd
        heads_per_group = n_heads // groups
        for j in range(di):
            head = j // hd
            g = head // heads_per_group
            m[j, j] = 1.0                                        # x channel
            m[2 * di + g * st: 2 * di + (g + 1) * st, j] = 1.0   # B taps
            b0 = 2 * di + groups * st
            m[b0 + g * st: b0 + (g + 1) * st, j] = 1.0           # C taps
            m[2 * di + 2 * groups * st + head, j] = 1.0          # dt
    else:
        raise ValueError(f"unknown structure {spec.structure!r}")
    if int(m.sum()) != spec.nnz:
        raise AssertionError(f"{spec.name}: mask nnz {int(m.sum())} != "
                             f"spec nnz {spec.nnz}")
    return m


def _structure_gate(spec: LayerSpec) -> np.ndarray | None:
    """Static per-neuron message gate (MoE expert activation)."""
    if spec.gate is None:
        return None
    tag, n_experts, n_shared, top_k, f = spec.gate
    g = np.zeros(spec.width, np.float32)
    for e in range(top_k):                       # routed experts kept live
        g[e * 2 * f:(e + 1) * 2 * f] = 1.0
    for e in range(n_experts, n_experts + n_shared):   # always-on experts
        g[e * 2 * f:(e + 1) * 2 * f] = 1.0
    g[-n_experts:] = 1.0                         # router logits always emit
    return g


# ================================================================= lowering

class _Lowering:
    """Accumulates LayerSpecs; tracks the previous layer's gate so per-token
    MAC arithmetic stays exact across gated boundaries."""

    def __init__(self, seq_len: int, recurrent_neuron: str):
        if recurrent_neuron not in _RECURRENT_NEURONS:
            raise ValueError(f"recurrent_neuron must be one of "
                             f"{_RECURRENT_NEURONS}, got {recurrent_neuron!r}")
        self.seq_len = seq_len
        self.recurrent_neuron = recurrent_neuron
        self.specs: list[LayerSpec] = []
        self.attn_specs: list[AttnSpec] = []
        self._prev_gate: tuple | None = None

    def add(self, name: str, fanin: int, width: int, structure: tuple,
            role: str, *, param_nnz: int = 0, neuron_model: str = "relu",
            gate: tuple | None = None) -> None:
        nnz = _structure_nnz(structure, fanin, width)
        if self._prev_gate is None:
            macs = nnz                       # dense input activity
        else:
            # Input messages are gated by the previous layer's static MoE
            # gate: only live expert blocks' wi rows reach nonzero weights.
            tag, n_experts, n_shared, top_k, f = self._prev_gate
            if structure[0] != "moe_down":
                raise ValueError("only moe_up -> moe_down gating is lowered")
            macs = (top_k + n_shared) * f * width
        self.specs.append(LayerSpec(
            name=name, fanin=fanin, width=width, structure=structure,
            role=role, nnz=nnz, param_nnz=param_nnz,
            macs_per_token=macs, neuron_model=neuron_model, gate=gate))
        self._prev_gate = gate

    # -------------------------------------------------------------- blocks
    def attn(self, prefix: str, d: int, heads: int, kv_heads: int,
             head_dim: int, *, seq: int, causal: bool = True,
             window: int | None = None, softcap: float | None = None,
             cross: bool = False) -> None:
        q, kv = heads * head_dim, kv_heads * head_dim
        self.add(f"{prefix}.qkv", d, q + 2 * kv, ("dense",), "param",
                 param_nnz=d * (q + 2 * kv))
        self.add(f"{prefix}.scores", q + 2 * kv, heads * seq,
                 ("attn_scores", heads, seq, head_dim), "kv")
        self.add(f"{prefix}.values", heads * seq, q,
                 ("attn_values", heads, seq, head_dim), "kv")
        self.add(f"{prefix}.out", q, d, ("dense",), "param",
                 param_nnz=q * d)
        self.attn_specs.append(AttnSpec(
            name=prefix, heads=heads, kv_heads=kv_heads, head_dim=head_dim,
            seq=seq, causal=causal, window=window, softcap=softcap,
            cross=cross))

    def mlp(self, prefix: str, d: int, d_ff: int) -> None:
        # SwiGLU/GeGLU: wi|wg fused up, gate half carries no down weights
        self.add(f"{prefix}.in", d, 2 * d_ff, ("dense",), "param",
                 param_nnz=2 * d * d_ff)
        self.add(f"{prefix}.out", 2 * d_ff, d, ("first_rows", d_ff),
                 "param", param_nnz=d_ff * d)

    def moe(self, prefix: str, d: int, m: MoECfg) -> None:
        n_tot = m.n_experts + m.n_shared_experts
        f = m.d_ff
        width = n_tot * 2 * f + m.n_experts
        self.add(f"{prefix}.experts_up", d, width, ("dense",), "param",
                 param_nnz=d * width,
                 gate=("moe", m.n_experts, m.n_shared_experts, m.top_k, f))
        self.add(f"{prefix}.experts_down", width, d,
                 ("moe_down", n_tot, m.n_experts, f), "param",
                 param_nnz=n_tot * f * d)

    def ssd(self, prefix: str, d: int, s: SSDCfg) -> None:
        di, st, groups = s.d_inner, s.d_state, s.n_groups
        n_heads = di // s.head_dim
        fan = 2 * di + 2 * groups * st + n_heads
        self.add(f"{prefix}.in", d, fan, ("dense",), "param",
                 param_nnz=d * fan)
        self.add(f"{prefix}.state", fan, di,
                 ("ssd_state", di, s.head_dim, groups, st), "state",
                 neuron_model=self.recurrent_neuron)
        self.add(f"{prefix}.out", di, d, ("dense",), "param",
                 param_nnz=di * d)

    def rglru(self, prefix: str, d: int, r: RGLRUCfg) -> None:
        dr = r.d_rnn
        self.add(f"{prefix}.in", d, 2 * dr, ("dense",), "param",
                 param_nnz=2 * d * dr)
        # r,i gates are two (dr, dr) maps of the x half: lowered as one
        # dense (2dr, dr) recurrence layer — 2*dr^2 params exactly
        self.add(f"{prefix}.gates", 2 * dr, dr, ("dense",), "state",
                 param_nnz=2 * dr * dr, neuron_model=self.recurrent_neuron)
        self.add(f"{prefix}.out", dr, d, ("dense",), "param",
                 param_nnz=dr * d)

    def head(self, d: int, vocab: int) -> None:
        self.add("head", d, vocab, ("dense",), "head", param_nnz=vocab * d)


def _attn_context(window: int | None, seq_len: int) -> int:
    return min(window, seq_len) if window else seq_len


def lowering_spec(cfg, *, seq_len: int = DEFAULT_SEQ_LEN,
                  recurrent_neuron: str = "ssm"
                  ) -> tuple[list[LayerSpec], list[AttnSpec]]:
    """Pure-arithmetic lowering plan for ``cfg`` (no weights built)."""
    lo = _Lowering(seq_len, recurrent_neuron)
    if isinstance(cfg, EncDecCfg):
        d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        for i in range(cfg.n_enc_layers):
            # streaming encoder: one new frame per step, full-frame context
            lo.attn(f"enc{i}.attn", d, H, K, hd, seq=cfg.n_frames,
                    causal=False)
            lo.mlp(f"enc{i}.mlp", d, cfg.d_ff)
        for i in range(cfg.n_dec_layers):
            lo.attn(f"dec{i}.attn", d, H, K, hd, seq=seq_len, causal=True)
            lo.attn(f"dec{i}.xattn", d, H, K, hd, seq=cfg.n_frames,
                    causal=False, cross=True)
            lo.mlp(f"dec{i}.mlp", d, cfg.d_ff)
        lo.head(d, cfg.vocab_size)
        return lo.specs, lo.attn_specs
    if not isinstance(cfg, ModelCfg):
        raise TypeError(f"cannot lower {type(cfg).__name__}; expected "
                        "ModelCfg, EncDecCfg, or a registry arch id")
    d = cfg.d_model
    for bi, blk in enumerate(cfg.all_blocks()):
        prefix = f"b{bi}"
        if blk.kind == "attn":
            lo.attn(f"{prefix}.attn", d, cfg.n_heads, cfg.n_kv_heads,
                    cfg.head_dim, seq=_attn_context(blk.window, seq_len),
                    window=blk.window, softcap=cfg.attn_softcap)
        elif blk.kind == "ssd":
            lo.ssd(f"{prefix}.ssd", d, blk.ssd)
        elif blk.kind == "rglru":
            lo.rglru(f"{prefix}.rglru", d, blk.rglru)
        else:
            raise ValueError(f"unknown block kind {blk.kind!r}")
        if blk.moe is not None:
            lo.moe(f"{prefix}.moe", d, blk.moe)
        elif blk.d_ff:
            lo.mlp(f"{prefix}.mlp", d, blk.d_ff)
    lo.head(d, cfg.vocab_size)
    return lo.specs, lo.attn_specs


def excluded_params(cfg) -> int:
    """Parameters the lowering folds away (norms, convs, scalar gains) or
    absorbs into the network input (untied embeddings).  The frontend
    identity is::

        sum(spec.param_nnz) + excluded_params(cfg) == cfg.param_count()
    """
    d = cfg.d_model
    if isinstance(cfg, EncDecCfg):
        # per-layer norms (enc 2, dec 3) + enc/dec final norms; embeddings
        # are tied to the lowered head
        return cfg.n_enc_layers * 2 * d + cfg.n_dec_layers * 3 * d + 2 * d
    total = d                                       # final norm
    if not cfg.tie_embeddings:
        total += cfg.vocab_size * d                 # input embedding table
    for blk in cfg.all_blocks():
        total += d                                  # mixer pre-norm
        if blk.moe is not None or blk.d_ff:
            total += d                              # mlp pre-norm
        if blk.post_norms:
            total += 2 * d
        if blk.kind == "attn":
            if cfg.qk_norm:
                total += 2 * cfg.head_dim
        elif blk.kind == "ssd":
            s = blk.ssd
            h = s.d_inner // s.head_dim
            total += s.d_conv * (s.d_inner + 2 * s.n_groups * s.d_state)
            total += 3 * h + s.d_inner              # A_log/D/dt_bias + norm
        elif blk.kind == "rglru":
            total += blk.rglru.d_conv * blk.rglru.d_rnn + blk.rglru.d_rnn
    return total


# ================================================================== compile

@dataclasses.dataclass
class CompiledNetwork:
    """A priceable SimNetwork plus the arithmetic it was compiled from."""

    net: SimNetwork
    cfg: object                     # ModelCfg | EncDecCfg
    name: str
    arch_id: str | None
    family: str | None
    seq_len: int
    specs: list[LayerSpec]
    attn_specs: list[AttnSpec]

    @property
    def d_model(self) -> int:
        return self.net.in_size

    def param_layer_nnz(self) -> int:
        """Total parameter-bearing synapses (== param_count - excluded)."""
        return sum(s.param_nnz for s in self.specs)

    def macs_per_token(self) -> int:
        """Exact per-timestep MAC total of the dense-activity pipeline."""
        return sum(s.macs_per_token for s in self.specs)

    def inputs(self, steps: int, *, density: float = 1.0,
               seed: int = 0) -> torch.Tensor:
        """(steps, d_model) embedded-token stream on the network's
        device."""
        return make_inputs(self.net.in_size, density, steps, seed,
                           device=self.net.device)


def _resolve(arch, smoke: bool):
    """(cfg, name, arch_id, family) from an arch id or a raw config."""
    if isinstance(arch, str):
        from repro_torch.configs import registry
        entry = registry.get(arch)
        cfg = entry.smoke() if smoke else entry.config
        return cfg, cfg.name, entry.arch_id, entry.family
    return arch, arch.name, None, None


def _resolve_densities(act_density, n_layers: int) -> list[float | None]:
    """Per-layer message densities from a scalar, a per-layer schedule (any
    length — resampled over normalized depth), or any object with a
    ``densities_for(n_layers)`` method (a trained sparsity profile)."""
    if act_density is None:
        return [None] * n_layers
    if hasattr(act_density, "densities_for"):
        return [float(d) for d in act_density.densities_for(n_layers)]
    if isinstance(act_density, (int, float)):
        return [float(act_density)] * n_layers
    seq = np.asarray(act_density, np.float64)
    if seq.ndim != 1 or seq.size == 0:
        raise ValueError("act_density schedule must be a non-empty 1-D "
                         f"sequence; got shape {seq.shape}")
    if seq.size == n_layers:
        return [float(d) for d in seq]
    if seq.size == 1:
        return [float(seq[0])] * n_layers
    src = np.linspace(0.0, 1.0, seq.size)
    dst = np.linspace(0.0, 1.0, n_layers)
    return [float(d) for d in np.interp(dst, src, seq)]


def _build_layer(spec: LayerSpec, rng: np.random.Generator,
                 act_density: float | None, dev: torch.device) -> SimLayer:
    with trace.span("frontend.draw", layer=spec.name):
        mask = _structure_mask(spec)
        # weight magnitudes bounded away from zero so nnz (hence every
        # counter) is exactly the structural count; scale keeps the
        # forced-active message magnitudes stable across deep stacks
        scale = 0.5 / np.sqrt(max(1.0, spec.nnz / spec.width))
        vals = rng.normal(0.0, 1.0, (spec.fanin, spec.width))
        w = np.where(vals >= 0, 1.0, -1.0) * (0.5 + np.abs(vals)) * scale
        w = (w * mask).astype(np.float32)
        gate = _structure_gate(spec)
        if act_density is not None:
            live = np.nonzero(gate)[0] if gate is not None \
                else np.arange(spec.width)
            keep = int(round(act_density * live.size))
            g = np.zeros(spec.width, np.float32)
            if keep > 0:
                g[rng.choice(live, size=keep, replace=False)] = 1.0
            gate = g
    sd = spec.neuron_model == "sd_relu"
    return SimLayer(
        name=spec.name, kind="fc", weights=torch.from_numpy(w).to(dev),
        neuron_model=spec.neuron_model,
        msg_gate=None if gate is None else torch.from_numpy(gate).to(dev),
        force_active=not sd, decay=0.5,
        threshold=0.05 if sd else 0.0, sends_deltas=sd)


def compile_network(arch, *, seq_len: int = DEFAULT_SEQ_LEN,
                    smoke: bool = True, seed: int = 0,
                    act_density=None,
                    recurrent_neuron: str = "ssm",
                    verify_attention: bool = False,
                    device: "str | torch.device" = "cuda"
                    ) -> CompiledNetwork:
    """Compile a registry arch id (or raw config) into a CompiledNetwork
    whose layers live on ``device``.

    ``arch``: a ``repro_torch.configs.registry`` id (``smoke=True`` selects
    the arch's smoke config, ``False`` the full assigned config) or a
    ``ModelCfg`` / ``EncDecCfg`` instance.  ``seq_len`` sets the
    steady-state decode context (attention layers price
    ``min(window, seq_len)`` cache positions).  ``act_density`` programs an
    exact message density on top of the structural gates (None = the dense
    token pipeline, the counter-exact default); it accepts a scalar, a
    per-layer density schedule (any length — resampled over normalized
    depth), or an object with ``densities_for(n_layers)``.
    ``verify_attention`` runs :func:`attention_probe` at every lowered
    attention shape on ``device`` and raises if the kernel strays more
    than :data:`PROBE_ATOL` from its plain version.
    """
    dev = resolve_device(device)
    cfg, name, arch_id, family = _resolve(arch, smoke)
    specs, attn_specs = lowering_spec(cfg, seq_len=seq_len,
                                      recurrent_neuron=recurrent_neuron)
    rng = np.random.default_rng(seed)
    dens = _resolve_densities(act_density, len(specs))
    layers = [_build_layer(s, rng, d, dev) for s, d in zip(specs, dens)]
    net = SimNetwork(layers=layers, in_size=cfg.d_model)
    compiled = CompiledNetwork(
        net=net, cfg=cfg, name=name, arch_id=arch_id, family=family,
        seq_len=seq_len, specs=specs, attn_specs=attn_specs)
    if verify_attention:
        for spec in attn_specs:
            out, ref = attention_probe(spec, seed=seed, device=dev)
            err = float((out - ref).abs().max()) if out.numel() else 0.0
            if err > PROBE_ATOL:
                raise ValueError(
                    f"flash_attn kernel diverged from its plain version at "
                    f"{spec} (max err {err:.2e})")
    return compiled


def attention_probe(spec: AttnSpec, *, seed: int = 0,
                    device: "str | torch.device" = "cuda"
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Run the flash-attention wrapper and its plain version at exactly the
    (heads, kv_heads, head_dim, seq, causal, window, softcap) shape ``spec``
    was lowered for, batch 1; returns ``(kernel_out, plain_out)``, float32
    tensors on ``device`` (on the CPU the wrapper itself runs the plain
    version, through its padding).

    q, k and v are the JAX package's probe inputs: float32 standard
    normal draws (``prng.normal``, on ``device``) from the three keys of
    ``split(PRNGKey(seed), 3)``."""
    dev = resolve_device(device)
    keys = prng.split_words(prng.PRNGKey(seed), 3)
    q, k, v = (prng.normal(key, (1, spec.seq, heads, spec.head_dim), dev)
               for key, heads in zip(keys, (spec.heads, spec.kv_heads,
                                            spec.kv_heads)))
    kw = dict(causal=spec.causal, window=spec.window, softcap=spec.softcap)
    return flash_attention(q, k, v, **kw), flash_attention_ref(q, k, v, **kw)
