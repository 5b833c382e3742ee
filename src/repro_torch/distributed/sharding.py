"""Per-architecture parameter / batch / gradient / optimizer-state
sharding specs as data (PyTorch port of ``repro.distributed.sharding``).

Sharding rules (mesh ``("pod","data","model")`` / ``("data","model")``):

  batch            -> (pod, data)             [replicated when B < |dp|]
  attention        -> Q heads over `model` when divisible (Megatron TP),
                      otherwise head_dim on the projections
  MLP / expert FF  -> column->row parallel over `model`
  MoE experts      -> over `data` (expert parallelism)
  vocab            -> over `model` (embed rows / unembed cols)
  SSD / RG-LRU     -> channel dims over `model`
  optimizer state  -> ZeRO-1: + `data` on the first unsharded divisible dim
  giant gradients  -> + `pod` for leaves of 256 Mi elements or more

A spec is a tuple with one entry per
leading dim of its leaf; an entry is None, an axis name or a tuple of axis
names (the content of the JAX package's ``PartitionSpec``: ``P(*dims)``
there is ``tuple(dims)`` here).  A mesh is a mapping from axis name to
size, in axis order (``launch.mesh.PRODUCTION_MESHES``), or None.

The spec trees mirror ``lm.param_layout`` / ``encdec.param_layout`` key for
key (``pre{i}``, ``pattern/blk{j}`` with the repeat axis first,
``suf{i}``); :func:`grad_specs`, :func:`zero1_specs` and the optimizers'
``state_specs`` read leaf shapes from a parameter tree such as
``step.param_tree(lm.abstract_params(cfg))`` on ``meta`` tensors.

The JAX package's ``island_mesh`` and ``to_shardings`` build JAX meshes and
``NamedSharding`` objects and have no counterpart: the port's sharded
search takes a process group (``core.device_search``).  A
:class:`ShardCtx` built from a ``launch.mesh.Mesh`` carries the mesh's
process groups beside the sizes (``dp_group``, ``tp_group``) and the
reference's :class:`PerfFlags`.

**Tensor parallelism.**  :func:`shard_params` places a model on the
``"model"`` group: every leaf whose spec names `model` keeps this rank's
block along that dim (the reference's GSPMD placement, made explicit),
each parameter records its :class:`Split`, and the model records the
context that its layers read.  The fused projections ``ssd.in_xz`` =
``[x | z]`` and ``rglru.in_xy`` = ``[x | gate]`` keep this rank's block of
each half (Megatron's fused layout), so that a rank's ``x`` and ``z``
channels match.  :func:`gather_leaf` is the inverse (the reference's
layout, for ``params_to_numpy`` and checkpoints), :func:`slice_leaf`
cuts a whole leaf to this rank's block (a restore on another mesh).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, Optional

import torch
import torch.distributed as dist

from repro_torch.distributed import collectives as C
from repro_torch.models import moe as moe_lib
from repro_torch.models.common import BlockCfg, ModelCfg
from repro_torch.models.encdec import EncDecCfg


@dataclasses.dataclass(frozen=True)
class PerfFlags:
    """The reference's hillclimb knobs; the defaults are its baseline."""

    moe_sp_dispatch: bool = False   # slice the MoE a2a payload over `model`
    sp_residual: bool = False       # Megatron-SP: the residual stream
                                    # sequence-sharded over `model`


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """Mesh and axis roles.  ``mesh=None`` is one device: nothing is
    sharded."""

    mesh: Optional[Mapping[str, int]] = None
    dp: tuple[str, ...] = ("data",)     # batch axes (("pod","data") multi-pod)
    tp: Optional[str] = "model"
    batch_sharded: bool = True          # False when B < |dp|
    flags: PerfFlags = PerfFlags()
    #: axis name -> process group (``launch.mesh.Mesh.groups``); None
    #: when the mesh is a plain mapping
    groups: Optional[Mapping[str, Any]] = dataclasses.field(
        default=None, compare=False, hash=False)

    @property
    def dp_group(self):
        """The process group of the data axis, or None."""
        if self.groups is None or len(self.dp) != 1:
            return None
        return self.groups.get(self.dp[0])

    @property
    def tp_group(self):
        """The process group of the model axis, or None (no tensor
        parallelism at run time)."""
        if self.groups is None or self.tp is None:
            return None
        return self.groups.get(self.tp)

    @property
    def tp_rank(self) -> int:
        return C.group_rank(self.tp_group)

    def seq_sharded(self, seq_len: int) -> bool:
        """The reference's ``cs_res`` rule as a predicate: the residual
        stream of ``seq_len`` positions is sequence-sharded over `model`
        (Megatron-SP) when ``flags.sp_residual`` holds and the model
        group's size divides ``seq_len``."""
        return (self.flags.sp_residual and self.tp_group is not None
                and seq_len % self.tp_size == 0)

    @property
    def tp_size(self) -> int:
        if self.mesh is None or self.tp is None:
            return 1
        return self.mesh[self.tp]

    @property
    def dp_size(self) -> int:
        if self.mesh is None:
            return 1
        return math.prod(self.mesh[a] for a in self.dp)

    @property
    def dp_spec(self):
        return self.dp if self.batch_sharded else None

    def can_shard(self, dim_size: int) -> bool:
        return self.tp is not None and dim_size % max(self.tp_size, 1) == 0


def make_ctx(mesh: Optional[Mapping[str, int]], *,
             batch_size: int | None = None,
             flags: PerfFlags = PerfFlags()) -> ShardCtx:
    """ShardCtx from a mesh mapping, or a ``launch.mesh.Mesh`` whose
    groups it keeps (axis names decide dp)."""
    if mesh is None:
        return ShardCtx(mesh=None, flags=flags)
    groups = getattr(mesh, "groups", None)
    mesh = getattr(mesh, "sizes", mesh)
    dp = tuple(a for a in mesh if a in ("pod", "data"))
    dp_size = math.prod(mesh[a] for a in dp)
    sharded = batch_size is None or batch_size % dp_size == 0
    return ShardCtx(mesh=dict(mesh), dp=dp, tp="model",
                    batch_sharded=sharded, flags=flags, groups=groups)


# ------------------------------------------------- tensor-parallel leaves

#: leaves that concatenate two projections on their last dim; each half
#: is split on its own
FUSED = {"in_xz": 2, "in_xy": 2}


@dataclasses.dataclass(frozen=True)
class Split:
    """A leaf held in blocks over a process group: this rank keeps block
    ``rank`` along ``dim`` of each of the leaf's ``parts`` equal chunks."""

    dim: int
    group: Any = dataclasses.field(compare=False)
    parts: int = 1


def slice_leaf(t: torch.Tensor, splits) -> torch.Tensor:
    """This rank's block of the whole leaf ``t`` (a new tensor for any
    split)."""
    for sp in splits:
        n = C.group_size(sp.group)
        if t.shape[sp.dim] % (n * sp.parts):
            raise ValueError(f"dim {sp.dim} of {tuple(t.shape)} does not "
                             f"split in {sp.parts} x {n}")
        chunks = t.chunk(sp.parts, dim=sp.dim)
        k = chunks[0].shape[sp.dim] // n
        r = C.group_rank(sp.group)
        t = torch.cat([c.narrow(sp.dim, r * k, k) for c in chunks],
                      dim=sp.dim)
    return t


def gather_leaf(t: torch.Tensor, splits) -> torch.Tensor:
    """The whole leaf from every rank's block (outside autograd; every
    rank of each group calls it)."""
    t = t.detach()
    for sp in reversed(tuple(splits)):
        n = C.group_size(sp.group)
        blocks = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(blocks, t.contiguous(), group=sp.group)
        parts = [b.chunk(sp.parts, dim=sp.dim) for b in blocks]
        t = torch.cat([parts[r][j] for j in range(sp.parts)
                       for r in range(n)], dim=sp.dim)
    return t


def global_shape(t, splits) -> tuple:
    """The whole leaf's shape from a block's."""
    shape = list(t.shape)
    for sp in splits:
        shape[sp.dim] *= C.group_size(sp.group)
    return tuple(shape)


def param_splits(p, stacked: bool = False) -> tuple:
    """The :class:`Split` s of a parameter (its experts over the data
    group, ``moe.shard_experts``; a dim over the model group,
    :func:`shard_params`), with dims moved one on for a ``stacked`` leaf
    (the reference's leading repeat axis)."""
    s = int(stacked)
    out = []
    if getattr(p, "ep_group", None) is not None:
        out.append(Split(s, p.ep_group))
    if getattr(p, "tp_group", None) is not None:
        dim, parts = p.tp_split
        out.append(Split(dim + s, p.tp_group, parts))
    return tuple(out)


def layout_splits(layout: dict) -> dict:
    """:func:`param_splits` over a parameter layout (``lm.param_layout``:
    a parameter, or the tuple of a stacked leaf's parameters)."""
    from repro_torch.models.layers import map_layout
    return map_layout(lambda x: param_splits(
        x[0] if isinstance(x, tuple) else x, isinstance(x, tuple)), layout)


def gather_layout(layout: dict) -> dict:
    """A parameter layout with each leaf whole: stacked leaves stacked,
    split leaves gathered (every rank calls it)."""
    from repro_torch.models.layers import map_layout

    def one(x):
        t = torch.stack(x) if isinstance(x, tuple) else x
        return gather_leaf(t, param_splits(
            x[0] if isinstance(x, tuple) else x, isinstance(x, tuple)))
    return map_layout(one, layout)


def _lib(model):
    from repro_torch.models import encdec, lm
    return encdec if isinstance(model, encdec.EncDec) else lm


@torch.no_grad()
def shard_params(model, ctx: ShardCtx) -> int:
    """Keep this rank's block of every leaf of ``model`` whose spec
    (:func:`param_specs`) names `model`, record each block's
    :class:`Split` on its parameter and ``ctx`` on the model (its layers
    then run tensor-parallel over ``ctx.tp_group``).  Leaves the spec
    replicates stay whole.  Call it on the whole model (from
    ``init_params`` or ``params_from_numpy``; before or after
    ``moe.shard_experts``), before ``step.param_tree``.  Without a model
    group it records ``ctx`` and slices nothing.  Returns the number of
    leaves sliced."""
    if getattr(model, "shard_ctx", None) is not None:
        raise ValueError("the model is placed already")
    if getattr(model, "_param_tree", None) is not None:
        raise ValueError("shard_params before step.param_tree")
    model.shard_ctx = ctx
    group = ctx.tp_group
    if group is None:
        return 0
    if C.group_size(group) != ctx.tp_size:
        raise ValueError(f"a model axis of {ctx.tp_size} over a group of "
                         f"{C.group_size(group)}")
    done = 0

    def walk(layout, specs, name=""):
        nonlocal done
        if isinstance(layout, dict):
            for k, v in layout.items():
                walk(v, specs[k], k)
            return
        stacked = isinstance(layout, tuple)
        spec = tuple(specs)[int(stacked):]
        dims = [i for i, e in enumerate(spec)
                if e is not None and ctx.tp in _axes(e)]
        if not dims:
            return
        (dim,) = dims
        sp = Split(dim, group, FUSED.get(name, 1))
        for p in (layout if stacked else (layout,)):
            p.data = slice_leaf(p.data, (sp,))
            p.tp_group, p.tp_split = group, (dim, sp.parts)
            done += 1
    walk(_lib(model).param_layout(model), param_specs(model.cfg, ctx))
    return done


def _map_specs(fn, tree):
    """``fn`` over the spec leaves (tuples) of a nested dict."""
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v) for k, v in tree.items()}
    return fn(tree)


def zip_specs(fn, params, specs):
    """``fn(leaf, spec)`` over a parameter tree and its spec tree (dicts
    down to the leaves)."""
    if isinstance(params, dict):
        return {k: zip_specs(fn, params[k], specs[k]) for k in params}
    return fn(params, specs)


def _axes(entry) -> tuple:
    return entry if isinstance(entry, tuple) else (entry,)


# ----------------------------------------------------------------- params

def _attn_specs(cfg: ModelCfg, ctx: ShardCtx) -> dict:
    tp = ctx.tp
    head_tp = ctx.can_shard(cfg.n_heads)
    kv_tp = ctx.can_shard(cfg.n_kv_heads)
    if head_tp:
        sp = {"wq": (None, tp, None),
              "wk": (None, tp if kv_tp else None, None if kv_tp else tp),
              "wv": (None, tp if kv_tp else None, None if kv_tp else tp),
              "wo": (tp, None, None)}
    else:   # context-parallel attention: shard head_dim on the projections
        sp = {"wq": (None, None, tp), "wk": (None, None, tp),
              "wv": (None, None, tp), "wo": (None, tp, None)}
    if cfg.qk_norm:
        sp["q_gamma"] = (None,)
        sp["k_gamma"] = (None,)
    return sp


def _mlp_specs(ctx: ShardCtx) -> dict:
    return {"wi": (None, ctx.tp), "wg": (None, ctx.tp), "wo": (ctx.tp, None)}


def _ssd_specs(ctx: ShardCtx) -> dict:
    tp = ctx.tp
    return {"in_xz": (None, tp), "in_bc": (None, None),
            "in_dt": (None, None), "conv_w": (None, None),
            "A_log": (None,), "D": (None,), "dt_bias": (None,),
            "norm_g": (tp,), "out": (tp, None)}


def _rglru_specs(ctx: ShardCtx) -> dict:
    tp = ctx.tp
    return {"in_xy": (None, tp), "conv_w": (None, tp),
            "w_r": (None, tp), "w_i": (None, tp),
            "a_param": (tp,), "out": (tp, None)}


def _block_specs(blk: BlockCfg, cfg: ModelCfg, ctx: ShardCtx) -> dict:
    sp: dict[str, Any] = {"norm1": (None,)}
    if blk.kind == "attn":
        sp["attn"] = _attn_specs(cfg, ctx)
    elif blk.kind == "ssd":
        sp["ssd"] = _ssd_specs(ctx)
    elif blk.kind == "rglru":
        sp["rglru"] = _rglru_specs(ctx)
    if blk.moe is not None:
        sp["norm2"] = (None,)
        sp["moe"] = moe_lib.moe_param_specs(cfg, blk.moe, ctx)
    elif blk.d_ff:
        sp["norm2"] = (None,)
        sp["mlp"] = _mlp_specs(ctx)
    if blk.post_norms:
        sp["norm1_post"] = (None,)
        sp["norm2_post"] = (None,)
    return sp


def _stack(spec_tree):
    """Prepend the stacked (n_repeats) axis to every leaf spec."""
    return _map_specs(lambda s: (None,) + tuple(s), spec_tree)


def lm_param_specs(cfg: ModelCfg, ctx: ShardCtx) -> dict:
    tp = ctx.tp
    specs: dict[str, Any] = {"embed": (tp, None), "final_norm": (None,)}
    if not cfg.tie_embeddings:
        specs["unembed"] = (None, tp)
    for i, blk in enumerate(cfg.prefix):
        specs[f"pre{i}"] = _block_specs(blk, cfg, ctx)
    if cfg.n_repeats:
        specs["pattern"] = _stack(
            {f"blk{j}": _block_specs(blk, cfg, ctx)
             for j, blk in enumerate(cfg.pattern)})
    for i, blk in enumerate(cfg.suffix):
        specs[f"suf{i}"] = _block_specs(blk, cfg, ctx)
    return specs


def encdec_param_specs(cfg: EncDecCfg, ctx: ShardCtx) -> dict:
    mc = cfg.mc

    def enc_block():
        return {"norm1": (None,), "attn": _attn_specs(mc, ctx),
                "norm2": (None,), "mlp": _mlp_specs(ctx)}

    def dec_block():
        return {"norm1": (None,), "attn": _attn_specs(mc, ctx),
                "norm_x": (None,), "xattn": _attn_specs(mc, ctx),
                "norm2": (None,), "mlp": _mlp_specs(ctx)}

    return {"embed": (ctx.tp, None),
            "enc": _stack(enc_block()), "dec": _stack(dec_block()),
            "enc_norm": (None,), "dec_norm": (None,)}


def param_specs(cfg, ctx: ShardCtx) -> dict:
    if isinstance(cfg, EncDecCfg):
        return encdec_param_specs(cfg, ctx)
    return lm_param_specs(cfg, ctx)


# ------------------------------------------------------- batch / grad / opt

def batch_specs(batch_tree: dict, ctx: ShardCtx) -> dict:
    """Shard dim 0 (batch) of every input over the DP axes.  Leaves are
    anything with a ``shape`` (tensors, ``shapes.TensorSpec``)."""
    dp = ctx.dp_spec

    def leaf(x):
        nd = len(getattr(x, "shape", ()))
        return (dp,) + (None,) * (nd - 1) if nd >= 1 else ()
    return {k: leaf(x) for k, x in batch_tree.items()}


_GIANT = 256 * 2**20        # elements; ~0.5 GiB in bf16


def _add_axis(shape, spec, axis: str, size: int, *, at_least: bool):
    """``spec`` with ``axis`` on the first unsharded dim of ``shape`` that
    ``size`` divides (and, ``at_least``, that is at least ``size``); the
    spec unchanged when ``axis`` is used already or no dim qualifies."""
    dims = list(tuple(spec) + (None,) * (len(shape) - len(tuple(spec))))
    if any(axis in _axes(d) for d in dims):
        return spec
    for i, d in enumerate(dims):
        if d is None and shape[i] % size == 0 and (
                not at_least or shape[i] >= size):
            dims[i] = axis
            return tuple(dims)
    return spec


def grad_specs(params_tree, specs_tree, ctx: ShardCtx):
    """Gradient specs: the parameters', plus `pod` on the first unsharded
    divisible dim of giant leaves (a cross-pod reduce-scatter instead of
    an all-reduce: the MoE expert tensors of kimi-k2)."""
    if ctx.mesh is None or "pod" not in ctx.mesh:
        return specs_tree
    pod = ctx.mesh["pod"]

    def leaf(x, s):
        if math.prod(x.shape) < _GIANT:
            return s
        return _add_axis(x.shape, s, "pod", pod, at_least=False)
    return zip_specs(leaf, params_tree, specs_tree)


def zero1_specs(params_tree, specs_tree, ctx: ShardCtx):
    """Optimizer-state specs: the parameters' spec + `data` on the first
    unsharded divisible dim (ZeRO-1 state sharding over the DP axis)."""
    if ctx.mesh is None:
        return specs_tree
    data = ctx.mesh["data"]
    return zip_specs(
        lambda x, s: _add_axis(x.shape, s, "data", data, at_least=True),
        params_tree, specs_tree)


def _zip_leaves(tree, specs):
    """(leaf, spec) pairs of a tree of dicts and lists whose spec tree has
    the same containers and tuples at the leaves."""
    if isinstance(tree, dict):
        for k in tree:
            yield from _zip_leaves(tree[k], specs[k])
    elif isinstance(tree, list):
        if len(tree) != len(specs):
            raise ValueError(f"{len(tree)} leaves against {len(specs)} specs")
        for x, s in zip(tree, specs):
            yield from _zip_leaves(x, s)
    else:
        yield tree, specs


def spec_bytes(tree, specs, mesh: Mapping[str, int]) -> int:
    """Per-device bytes of ``tree`` (tensors or ``TensorSpec``s) sharded
    by ``specs`` over ``mesh``: each leaf's bytes over the product of the
    sizes of the axes in its spec, rounded down per leaf."""
    total = 0
    for x, s in _zip_leaves(tree, specs):
        shards = math.prod(mesh[a] for entry in s for a in _axes(entry)
                           if a is not None)
        total += math.prod(x.shape) * x.dtype.itemsize // shards
    return total
