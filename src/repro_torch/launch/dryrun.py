"""One-card dry-run: every (arch x shape) cell built on ``meta`` tensors
and counted (PyTorch port of ``repro.launch.dryrun``).

The reference lowers and compiles each cell on 512 placeholder CPU
devices and reads the compiled HLO.  The port has one card and no HLO:
each cell's parameters, optimizer state, batch or decode cache are built
on ``meta`` tensors, which allocate nothing (the counterpart of
``jax.eval_shape``), and its step runs once under
:mod:`repro_torch.core.hlo_cost`'s counter.  A train step runs one
microbatch and scales it by the microbatch count, as the reference's
analyzer scales its scan body.  Each record holds the count, the three
floorline terms and a one-card memory account: the step's argument
bytes, the peak of live bytes during the counted call, and whether the
two fit the card's memory (a cell that does not is recorded with
``"fits": false``, not as an error).  Beside the card's state bytes,
``mesh_state_bytes_per_device`` holds the per-device state bytes on the
reference's production meshes (``launch.mesh.PRODUCTION_MESHES``), from
the sharding specs (``distributed.sharding.spec_bytes``): parameters and
optimizer state for a train cell, parameters for prefill, parameters and
the decode cache (the port's cache layout) for decode.

  python -m repro_torch.launch.dryrun --arch gemma2-2b --shape train_4k
  python -m repro_torch.launch.dryrun --arch olmoe-1b-7b --shape train_4k \\
      --smoke --microbatches 2 --remat none --out DIR
  python -m repro_torch.launch.dryrun --all --out DIR

Nothing here touches a card: ``meta`` tensors carry shapes and dtypes
only, so full-size configs count on any host.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback
from typing import Callable, Optional

import torch

from repro_torch.configs import registry
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.core import hlo_cost
from repro_torch.core import tpu_floorline as tfl
from repro_torch.distributed import autoshard, sharding
from repro_torch.launch.mesh import PRODUCTION_MESHES
from repro_torch.models import encdec, layers, lm
from repro_torch.train import optim, schedules
from repro_torch.train import step as step_lib
from repro_torch.tree import tree_leaves

CARD_BYTES = 80e9            # an H100's HBM, when no card is visible
META = torch.device("meta")


@dataclasses.dataclass
class Cell:
    """One built cell: ``fn(*args)`` runs its step once; a train cell's
    ``parts`` are ``step.train_step_parts`` of that step."""
    fn: Callable
    args: tuple
    meta: dict
    cfg: object
    shape: ShapeSpec
    argument_bytes: int                 # parameters, state, cache, batch
    parts: Optional[tuple] = None


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _inputs(specs: dict) -> dict:
    return {k: torch.empty(s.shape, dtype=s.dtype, device=META)
            for k, s in specs.items()}


def card_bytes() -> float:
    """The card's memory, or an H100's 80 GB when none is visible."""
    if torch.cuda.is_available():
        return float(torch.cuda.get_device_properties(0).total_memory)
    return CARD_BYTES


def build_cell(arch_id: str, shape: "str | ShapeSpec", *,
               smoke: bool = False, microbatches: int | None = None,
               remat: str | None = None) -> Cell:
    """The cell's step and its arguments on ``meta``: a train step
    (AdamW or Adafactor by ``optim.for_arch``, ``global_batch``
    microbatches by default), a prefill step, or one decode step against
    a full ``seq_len`` cache.  ``shape`` is one of the arch's shape names
    (``smoke``: at seq 32, batch 8) or a :class:`ShapeSpec`."""
    entry = registry.get(arch_id)
    cfg = entry.smoke() if smoke else entry.config
    if remat is not None:
        cfg = dataclasses.replace(cfg, remat=remat)
    if not isinstance(shape, ShapeSpec):
        shape = entry.shapes[shape]
        if smoke:
            shape = ShapeSpec(shape.name, seq_len=32, global_batch=8,
                              kind=shape.kind)
    lib = encdec if entry.is_encdec else lm
    model = lib.abstract_params(cfg)
    meta = {"arch": arch_id, "shape": shape.name, "kind": shape.kind,
            "seq_len": shape.seq_len, "global_batch": shape.global_batch,
            "n_chips": 1, "params": int(cfg.param_count())}
    ctxs = {name: (mesh, sharding.make_ctx(mesh,
                                           batch_size=shape.global_batch))
            for name, mesh in PRODUCTION_MESHES.items()}

    def mesh_bytes(trees) -> dict:
        """Per-device bytes on each production mesh of the (tree, specs
        of a ShardCtx) pairs ``trees(ctx)`` gives."""
        return {name: sum(sharding.spec_bytes(t, s, mesh)
                          for t, s in trees(ctx))
                for name, (mesh, ctx) in ctxs.items()}

    params = step_lib.param_tree(model)
    pspecs = lambda ctx: sharding.param_specs(cfg, ctx)

    if shape.kind == "train":
        M = microbatches or shape.global_batch
        opt = optim.for_arch(cfg.param_count(),
                             schedules.cosine(3e-4, 100, 10_000))
        accum = "bfloat16" if cfg.param_count() > 100e9 else "float32"
        state = step_lib.init_state(model, opt)
        batch = _inputs(entry.input_specs(shape, cfg=cfg))
        fn = step_lib.make_train_step(model, opt, num_microbatches=M,
                                      grad_accum_dtype=accum)
        parts = step_lib.train_step_parts(model, opt, num_microbatches=M,
                                          grad_accum_dtype=accum)
        meta.update(microbatches=M, optimizer=opt.name,
                    state_bytes_per_device=_bytes(state["params"])
                    + _bytes(state["opt"]),
                    mesh_state_bytes_per_device=mesh_bytes(lambda ctx: (
                        (params, pspecs(ctx)),
                        (state["opt"], opt.state_specs(params, pspecs(ctx),
                                                       ctx)))))
        return Cell(fn, (state, batch), meta, cfg, shape,
                    _bytes((state, batch)), parts)

    if shape.kind == "prefill":
        batch = _inputs(entry.input_specs(shape, cfg=cfg))
        meta["state_bytes_per_device"] = _bytes(params)
        meta["mesh_state_bytes_per_device"] = mesh_bytes(
            lambda ctx: ((params, pspecs(ctx)),))
        return Cell(lambda b: step_lib.make_prefill_step(cfg)(model, b),
                    (batch,), meta, cfg, shape,
                    meta["state_bytes_per_device"] + _bytes(batch))

    # decode: one token at the last position of a full seq_len cache
    B = shape.global_batch
    cache = lib.abstract_cache(cfg, B, shape.seq_len)
    tokens = torch.empty((B, 1), dtype=torch.int32, device=META)
    serve = step_lib.make_serve_step(cfg)
    meta["cache_bytes_per_device"] = _bytes(cache)
    meta["state_bytes_per_device"] = (_bytes(params)
                                      + meta["cache_bytes_per_device"])
    meta["mesh_state_bytes_per_device"] = mesh_bytes(lambda ctx: (
        (params, pspecs(ctx)), (cache, lib.cache_spec(cfg, ctx))))
    return Cell(lambda c, t: serve(model, t, c, shape.seq_len - 1),
                (cache, tokens), meta, cfg, shape,
                meta["state_bytes_per_device"] + _bytes(tokens))


def score_dims(cell: Cell) -> set:
    """The (queries, keys) dims of the cell's attention-score blocks: self-
    attention over the sequence, and for an encoder-decoder the encoder's
    frames and the cross-attention.  A decode step's single query makes
    no block."""
    if cell.shape.kind == "decode":
        return set()
    S = cell.shape.seq_len
    dims = {(S, layers.score_cols(S))}
    if isinstance(cell.cfg, encdec.EncDecCfg):
        F = cell.cfg.n_frames
        dims |= {(F, layers.score_cols(F)), (S, layers.score_cols(F))}
    return dims


def count_cell(cell: Cell) -> hlo_cost.HloCost:
    """The cell's step counted once; a train step's microbatch counted
    once and scaled by the microbatch count."""
    with hlo_cost.counting(score_dims(cell)) as c:
        if cell.parts is None:
            cell.fn(*cell.args)
        else:
            start, body, finish = cell.parts
            state, batch = cell.args
            M = cell.meta["microbatches"]
            carry = start()
            with c.trips("microbatch", M):
                carry = body(carry, next(step_lib.microbatches(batch, M)))
            finish(state, carry)
    return c.result()


def run_cell(arch_id: str, shape: "str | ShapeSpec", *,
             out_dir: str | None = None, smoke: bool = False,
             microbatches: int | None = None, remat: str | None = None,
             quiet: bool = False) -> dict:
    """Build, count and bound one cell; write its record to ``out_dir``
    (``<arch>__<shape>__card.json``) and return it."""
    t0 = time.perf_counter()
    cell = build_cell(arch_id, shape, smoke=smoke,
                      microbatches=microbatches, remat=remat)
    t_build = time.perf_counter() - t0
    hc = count_cell(cell)
    t_count = time.perf_counter() - t0 - t_build
    meta, cfg, shape = cell.meta, cell.cfg, cell.shape
    mesh_name = "card"
    args = cell.argument_bytes
    capacity = card_bytes()
    mem = {"argument_bytes": args, "temp_bytes": hc.peak_live_bytes,
           "peak_bytes": args + hc.peak_live_bytes,
           "card_bytes": capacity,
           "fits": args + hc.peak_live_bytes <= capacity}
    mf = tfl.model_flops_for(cfg, shape.kind, shape.seq_len,
                             shape.global_batch)
    # memory term: flash-adjusted — a flash-attention kernel keeps the
    # score blocks on chip; the raw eager count is recorded alongside
    terms = tfl.RooflineTerms(
        flops_per_chip=hc.flops,
        hbm_bytes_per_chip=hc.hbm_bytes - hc.score_bytes,
        collective_bytes_per_chip=hc.collective_bytes,
        model_flops=mf, n_chips=1,
        label=f"{arch_id}|{shape.name}|{mesh_name}",
        flops_by_dtype=dict(hc.flops_by_dtype))
    record = {
        **meta,
        "mesh": mesh_name, "mesh_shape": [1],
        "build_s": t_build, "count_s": t_count,
        "memory_analysis": mem,
        "hlo_cost": {
            "flops": hc.flops, "hbm_bytes": hc.hbm_bytes,
            "score_bytes": hc.score_bytes,
            "collective_bytes": hc.collective_bytes,
            "bytes_by_kind": hc.bytes_by_kind,
            "count_by_kind": hc.count_by_kind,
            "while_trips": hc.while_trips,
            "flops_by_dtype": hc.flops_by_dtype,
            "n_ops": hc.n_ops,
            "top_collectives": hc.top_collectives[:8],
            "top_dots": hc.top_dots[:8],
            "top_hbm": hc.top_hbm[:8],
        },
        "roofline": terms.row(),
        "ok": True,
    }
    if not quiet:
        print(f"[{arch_id} x {shape.name} x {mesh_name}] dominant="
              f"{terms.dominant.value} bound={terms.bound:.4f}s "
              f"useful_ratio={terms.useful_flops_ratio:.3f} "
              f"fits={mem['fits']} (build {t_build:.1f}s count "
              f"{t_count:.1f}s)", flush=True)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir,
                            f"{arch_id}__{shape.name}__{mesh_name}.json")
        with open(path, "w") as f:
            json.dump(record, f, indent=1)
    return record


def hillclimb_cell(arch_id: str, shape: str, *, smoke: bool = False
                   ) -> autoshard.HillResult:
    """:func:`autoshard.hillclimb` over a train cell with the moves one
    card has (:func:`autoshard.card_moves`).  A variant that does not fit
    the card has no bound (``bound_s`` infinite), so it is never kept."""
    def evaluate(**overrides):
        rec = run_cell(arch_id, shape, smoke=smoke, quiet=True, **overrides)
        row = dict(rec["roofline"])
        if not rec["memory_analysis"]["fits"]:
            row["bound_s"] = float("inf")
        return row
    base = build_cell(arch_id, shape, smoke=smoke)
    return autoshard.hillclimb(evaluate, autoshard.card_moves(
        base.meta["microbatches"], base.cfg.remat))


def _sweep(args) -> int:
    """Every cell, one after another in this process."""
    ok = 0
    cells = registry.all_cells()
    for a, s in cells:
        try:
            run_cell(a, s, out_dir=args.out, smoke=args.smoke)
            ok += 1
        except Exception:                       # report, go on to the next
            print(f"[FAIL] {a} x {s}")
            traceback.print_exc()
    print(f"\nsweep: {ok}/{len(cells)} cells passed")
    return 0 if ok == len(cells) else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=registry.ARCH_IDS)
    ap.add_argument("--shape")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config, seq 32, batch 8")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--remat", default=None, choices=["none", "block"])
    ap.add_argument("--out", default=None)
    ap.add_argument("--all", action="store_true")
    args = ap.parse_args(argv)
    if args.all:
        return _sweep(args)
    if not (args.arch and args.shape):
        ap.error("--arch and --shape, or --all")
    try:
        run_cell(args.arch, args.shape, out_dir=args.out, smoke=args.smoke,
                 microbatches=args.microbatches, remat=args.remat)
        return 0
    except Exception:
        traceback.print_exc()
        return 1


if __name__ == "__main__":
    sys.exit(main())
