"""The frontend's lowering arithmetic and seeded weight draws, frozen for
the benchmark's reference and counting functions.

Frozen from ``repro_torch.neuromorphic.frontend`` at commit cbf4587:
``_structure_nnz``, ``_structure_mask``, ``_structure_gate``,
``_Lowering``, ``lowering_spec`` and the draws of ``_build_layer``.  The
copy reads a configuration file's JSON object instead of the port's
config dataclasses and imports nothing of the program, so a later change
to the frontend is judged against this arithmetic, not against itself.

A configuration object holds ``kind`` (``"encdec"`` or ``"lm"``) and the
sizes under the port's field names: for ``"encdec"`` ``d_model``,
``n_heads``, ``n_kv_heads``, ``head_dim``, ``d_ff``, ``n_enc_layers``,
``n_dec_layers``, ``n_frames``, ``vocab_size``; for ``"lm"`` also
``prefix``, ``pattern``, ``n_repeats``, ``suffix`` (lists of block
objects with ``kind``, ``d_ff``, ``window`` and ``ssd`` / ``moe`` /
``rglru`` sub-objects) and ``attn_softcap``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

RECURRENT_NEURONS = ("ssm", "sd_relu")


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One emitted fc layer: its shape, mask structure and dense-activity
    MAC arithmetic (as the frontend's ``LayerSpec``)."""

    name: str
    fanin: int
    width: int
    structure: tuple
    role: str
    nnz: int
    param_nnz: int
    macs_per_token: int
    neuron_model: str = "relu"
    gate: tuple | None = None


def structure_nnz(structure: tuple, fanin: int, width: int) -> int:
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


def structure_mask(spec: LayerSpec) -> np.ndarray:
    """0/1 float32 synapse mask (fanin, width) of ``spec.structure``."""
    kind = spec.structure[0]
    m = np.zeros((spec.fanin, spec.width), np.float32)
    if kind == "dense":
        m[:] = 1.0
    elif kind == "first_rows":
        m[: spec.structure[1], :] = 1.0
    elif kind == "attn_scores":
        _, heads, seq, hd = spec.structure
        for h in range(heads):
            m[h * hd:(h + 1) * hd, h * seq:(h + 1) * seq] = 1.0
    elif kind == "attn_values":
        _, heads, seq, hd = spec.structure
        for h in range(heads):
            m[h * seq:(h + 1) * seq, h * hd:(h + 1) * hd] = 1.0
    elif kind == "moe_down":
        _, n_tot, n_router, f = spec.structure
        for e in range(n_tot):
            m[e * 2 * f: e * 2 * f + f, :] = 1.0
    elif kind == "ssd_state":
        _, di, hd, groups, st = spec.structure
        n_heads = di // hd
        heads_per_group = n_heads // groups
        for j in range(di):
            head = j // hd
            g = head // heads_per_group
            m[j, j] = 1.0
            m[2 * di + g * st: 2 * di + (g + 1) * st, j] = 1.0
            b0 = 2 * di + groups * st
            m[b0 + g * st: b0 + (g + 1) * st, j] = 1.0
            m[2 * di + 2 * groups * st + head, j] = 1.0
    else:
        raise ValueError(f"unknown structure {spec.structure!r}")
    if int(m.sum()) != spec.nnz:
        raise AssertionError(f"{spec.name}: mask nnz {int(m.sum())} != "
                             f"spec nnz {spec.nnz}")
    return m


def structure_gate(spec: LayerSpec) -> np.ndarray | None:
    """Static per-neuron message gate (MoE expert activation)."""
    if spec.gate is None:
        return None
    tag, n_experts, n_shared, top_k, f = spec.gate
    g = np.zeros(spec.width, np.float32)
    for e in range(top_k):
        g[e * 2 * f:(e + 1) * 2 * f] = 1.0
    for e in range(n_experts, n_experts + n_shared):
        g[e * 2 * f:(e + 1) * 2 * f] = 1.0
    g[-n_experts:] = 1.0
    return g


class _Lowering:
    def __init__(self, seq_len: int, recurrent_neuron: str):
        if recurrent_neuron not in RECURRENT_NEURONS:
            raise ValueError(f"recurrent_neuron must be one of "
                             f"{RECURRENT_NEURONS}, got {recurrent_neuron!r}")
        self.seq_len = seq_len
        self.recurrent_neuron = recurrent_neuron
        self.specs: list[LayerSpec] = []
        self._prev_gate: tuple | None = None

    def add(self, name, fanin, width, structure, role, *, param_nnz=0,
            neuron_model="relu", gate=None):
        nnz = structure_nnz(structure, fanin, width)
        if self._prev_gate is None:
            macs = nnz
        else:
            tag, n_experts, n_shared, top_k, f = self._prev_gate
            if structure[0] != "moe_down":
                raise ValueError("only moe_up -> moe_down gating is lowered")
            macs = (top_k + n_shared) * f * width
        self.specs.append(LayerSpec(
            name=name, fanin=fanin, width=width, structure=structure,
            role=role, nnz=nnz, param_nnz=param_nnz, macs_per_token=macs,
            neuron_model=neuron_model, gate=gate))
        self._prev_gate = gate

    def attn(self, prefix, d, heads, kv_heads, head_dim, *, seq):
        q, kv = heads * head_dim, kv_heads * head_dim
        self.add(f"{prefix}.qkv", d, q + 2 * kv, ("dense",), "param",
                 param_nnz=d * (q + 2 * kv))
        self.add(f"{prefix}.scores", q + 2 * kv, heads * seq,
                 ("attn_scores", heads, seq, head_dim), "kv")
        self.add(f"{prefix}.values", heads * seq, q,
                 ("attn_values", heads, seq, head_dim), "kv")
        self.add(f"{prefix}.out", q, d, ("dense",), "param", param_nnz=q * d)

    def mlp(self, prefix, d, d_ff):
        self.add(f"{prefix}.in", d, 2 * d_ff, ("dense",), "param",
                 param_nnz=2 * d * d_ff)
        self.add(f"{prefix}.out", 2 * d_ff, d, ("first_rows", d_ff),
                 "param", param_nnz=d_ff * d)

    def moe(self, prefix, d, m):
        n_tot = m["n_experts"] + m.get("n_shared_experts", 0)
        f = m["d_ff"]
        width = n_tot * 2 * f + m["n_experts"]
        self.add(f"{prefix}.experts_up", d, width, ("dense",), "param",
                 param_nnz=d * width,
                 gate=("moe", m["n_experts"], m.get("n_shared_experts", 0),
                       m["top_k"], f))
        self.add(f"{prefix}.experts_down", width, d,
                 ("moe_down", n_tot, m["n_experts"], f), "param",
                 param_nnz=n_tot * f * d)

    def ssd(self, prefix, d, s):
        di, st = s["d_inner"], s.get("d_state", 128)
        groups, hd = s.get("n_groups", 1), s.get("head_dim", 64)
        n_heads = di // hd
        fan = 2 * di + 2 * groups * st + n_heads
        self.add(f"{prefix}.in", d, fan, ("dense",), "param",
                 param_nnz=d * fan)
        self.add(f"{prefix}.state", fan, di, ("ssd_state", di, hd, groups, st),
                 "state", neuron_model=self.recurrent_neuron)
        self.add(f"{prefix}.out", di, d, ("dense",), "param",
                 param_nnz=di * d)

    def rglru(self, prefix, d, r):
        dr = r["d_rnn"]
        self.add(f"{prefix}.in", d, 2 * dr, ("dense",), "param",
                 param_nnz=2 * d * dr)
        self.add(f"{prefix}.gates", 2 * dr, dr, ("dense",), "state",
                 param_nnz=2 * dr * dr, neuron_model=self.recurrent_neuron)
        self.add(f"{prefix}.out", dr, d, ("dense",), "param",
                 param_nnz=dr * d)

    def head(self, d, vocab):
        self.add("head", d, vocab, ("dense",), "head", param_nnz=vocab * d)


def all_blocks(cfg: dict) -> list[dict]:
    return (list(cfg.get("prefix", [])) + list(cfg.get("pattern", []))
            * int(cfg.get("n_repeats", 0)) + list(cfg.get("suffix", [])))


def lowering_spec(cfg: dict, *, seq_len: int,
                  recurrent_neuron: str = "ssm") -> list[LayerSpec]:
    """The layer plan of ``cfg`` (no weights built)."""
    lo = _Lowering(seq_len, recurrent_neuron)
    d = cfg["d_model"]
    H, K, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    if cfg["kind"] == "encdec":
        for i in range(cfg["n_enc_layers"]):
            lo.attn(f"enc{i}.attn", d, H, K, hd, seq=cfg["n_frames"])
            lo.mlp(f"enc{i}.mlp", d, cfg["d_ff"])
        for i in range(cfg["n_dec_layers"]):
            lo.attn(f"dec{i}.attn", d, H, K, hd, seq=seq_len)
            lo.attn(f"dec{i}.xattn", d, H, K, hd, seq=cfg["n_frames"])
            lo.mlp(f"dec{i}.mlp", d, cfg["d_ff"])
        lo.head(d, cfg["vocab_size"])
        return lo.specs
    if cfg["kind"] != "lm":
        raise ValueError(f"unknown configuration kind {cfg['kind']!r}")
    for bi, blk in enumerate(all_blocks(cfg)):
        prefix = f"b{bi}"
        if blk["kind"] == "attn":
            window = blk.get("window")
            seq = min(window, seq_len) if window else seq_len
            lo.attn(f"{prefix}.attn", d, H, K, hd, seq=seq)
        elif blk["kind"] == "ssd":
            lo.ssd(f"{prefix}.ssd", d, blk["ssd"])
        elif blk["kind"] == "rglru":
            lo.rglru(f"{prefix}.rglru", d, blk["rglru"])
        else:
            raise ValueError(f"unknown block kind {blk['kind']!r}")
        if blk.get("moe") is not None:
            lo.moe(f"{prefix}.moe", d, blk["moe"])
        elif blk.get("d_ff"):
            lo.mlp(f"{prefix}.mlp", d, blk["d_ff"])
    lo.head(d, cfg["vocab_size"])
    return lo.specs


@dataclasses.dataclass
class DrawnLayer:
    """One layer as the frontend draws it: float32 weights, the message
    gate (None: every neuron messages) and the neuron parameters."""

    spec: LayerSpec
    weights: np.ndarray
    gate: np.ndarray | None
    force_active: bool
    decay: float
    threshold: float
    sends_deltas: bool


def draw_layer(spec: LayerSpec, rng: np.random.Generator,
               act_density: float | None = None) -> DrawnLayer:
    """The frontend's draws for one layer, in its order, from the shared
    generator: float64 normals, sign-preserving magnitudes bounded away
    from zero, the structural mask, then (only with ``act_density``) the
    programmed gate."""
    mask = structure_mask(spec)
    scale = 0.5 / np.sqrt(max(1.0, spec.nnz / spec.width))
    vals = rng.normal(0.0, 1.0, (spec.fanin, spec.width))
    w = np.where(vals >= 0, 1.0, -1.0) * (0.5 + np.abs(vals)) * scale
    w = (w * mask).astype(np.float32)
    gate = structure_gate(spec)
    if act_density is not None:
        live = (np.nonzero(gate)[0] if gate is not None
                else np.arange(spec.width))
        keep = int(round(act_density * live.size))
        g = np.zeros(spec.width, np.float32)
        if keep > 0:
            g[rng.choice(live, size=keep, replace=False)] = 1.0
        gate = g
    sd = spec.neuron_model == "sd_relu"
    return DrawnLayer(spec=spec, weights=w, gate=gate, force_active=not sd,
                      decay=0.5, threshold=0.05 if sd else 0.0,
                      sends_deltas=sd)


def draw_network(specs: list[LayerSpec], seed: int,
                 act_density: float | None = None):
    """Yield every layer's draws in order from ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    for spec in specs:
        yield draw_layer(spec, rng, act_density)
