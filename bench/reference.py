"""The plain reference of a simulation job, and its control.

Plain PyTorch on the weights drawn again from the seed by the frozen
frontend copy (:mod:`bench.lowering`); it imports nothing of the
program.  For each layer in order it computes the pre-activations
``x_eff @ W`` (``x_eff`` the wire's messages, or their running sum
where the sender sends deltas), the neuron model, the message gate and
the five exact counters of that layer, and hands the counters to a
callback, so a caller can compare them with the program's and keep
none.

Each neuron model is a file of its own, ``bench/neurons/<model>.py``,
found by the name the frontend gives the layer: its ``messages(layer,
pre)`` maps a (T, n) block of pre-activations, from zero state, to the
(T, n) messages the layer sends (for a sigma-delta model, its deltas).

Precisions:

``"float64"``  the reference: every product and recurrence in float64.
``"tf32"``     the control: float32 with both operands of every product
               rounded to TF32 (10 mantissa bits, to nearest, ties away
               from zero, as the tensor cores' ``cvt.rna.tf32``) and
               float32 accumulation.  This is the step below the float32
               that the configurations state.
"""

from __future__ import annotations

import importlib.util
import pathlib
from typing import Callable, Iterable

import torch

PRECISIONS = ("float64", "tf32")
HERE = pathlib.Path(__file__).resolve().parent


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32: the low 13 mantissa bits dropped,
    rounding to nearest with ties away from zero."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def _matmul(x: torch.Tensor, w32: torch.Tensor, precision: str
            ) -> torch.Tensor:
    if precision == "float64":
        return x.to(torch.float64) @ w32.to(torch.float64)
    if precision == "tf32":
        return tf32_round(x) @ tf32_round(w32)
    raise ValueError(f"unknown precision {precision!r}")


def neuron(model: str, bench_dir: pathlib.Path = HERE) -> Callable:
    """The ``messages`` function of ``bench_dir/neurons/<model>.py``."""
    path = bench_dir / "neurons" / f"{model}.py"
    if not path.exists():
        raise NotImplementedError(
            f"the reference has no {model!r} neuron model: add {path}")
    spec = importlib.util.spec_from_file_location(
        f"bench_neuron_{model}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.messages


def counters(x_in: torch.Tensor, w_nz: torch.Tensor, y: torch.Tensor
             ) -> dict[str, torch.Tensor]:
    """The five counters of one layer from its wire input ``x_in`` (T,
    fanin), its weights' nonzero pattern and its output messages ``y``,
    in float64 (exact: every count is an integer far below 2**53)."""
    act = (x_in != 0).to(torch.float64)
    msgs_in = act.sum(dim=1)
    macs = act @ w_nz
    return {"msgs_in": msgs_in,
            "macs": macs,
            "fetches_dense": msgs_in[:, None].expand(macs.shape),
            "msgs_out": (y != 0).to(torch.float64),
            "acts_evented": (macs > 0).to(torch.float64)}


def run(layers: Iterable, streams: dict[int, torch.Tensor],
        device: torch.device, precisions: tuple[str, ...] = ("float64",),
        on_layer: Callable | None = None, bench_dir: pathlib.Path = HERE
        ) -> dict[str, dict[int, torch.Tensor]]:
    """Run every stream through ``layers`` (the frozen copy's
    :class:`~bench.lowering.DrawnLayer` s, in order) in each precision.
    ``on_layer(index, layer, stream, {precision: counters})`` receives
    each layer's counters of each stream in every precision.  Returns
    the final output messages, ``{precision: {stream: (T, n_out)}}``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cur = {p: {j: x.to(device) for j, x in streams.items()}
           for p in precisions}
    models: dict[str, Callable] = {}
    deltas_in = False               # the wire carries the sender's deltas
    for i, layer in enumerate(layers):
        model = layer.spec.neuron_model
        if model not in models:
            models[model] = neuron(model, bench_dir)
        w32 = torch.from_numpy(layer.weights).to(device)
        gate = (None if layer.gate is None
                else torch.from_numpy(layer.gate).to(device))
        w_nz = (w32 != 0).to(torch.float64) if on_layer else None
        for j in streams:
            cnts = {}
            for p in precisions:
                x = cur[p][j]
                x_eff = x.cumsum(dim=0) if deltas_in else x
                y = models[model](layer, _matmul(x_eff, w32, p))
                if gate is not None:
                    y = y * gate.to(y.dtype)
                if on_layer is not None:
                    cnts[p] = counters(x, w_nz, y)
                cur[p][j] = y if p == "float64" else y.to(torch.float32)
            if on_layer is not None:
                on_layer(i, layer, j, cnts)
        deltas_in = layer.sends_deltas
        del w32, w_nz
    return cur


def gap(out: torch.Tensor, ref: torch.Tensor) -> float:
    """The widest gap between ``out`` and the reference, as a share of
    the reference's largest magnitude."""
    ref = ref.to(torch.float64)
    scale = float(ref.abs().max())
    return float((out.to(torch.float64) - ref).abs().max()) / max(scale,
                                                                  1e-300)
