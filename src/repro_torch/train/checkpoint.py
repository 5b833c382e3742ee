"""Fault-tolerant checkpointing: atomic, versioned, resumable.

* atomic: write to ``<dir>/tmp.<step>.npz`` then ``os.replace`` — a crash
  never leaves a partial checkpoint visible;
* versioned: ``step_<N>.npz`` + ``meta.json``; ``keep`` newest retained;
* resumable: :func:`restore` returns (state, step, extra) — ``extra``
  carries e.g. a data iterator's state so restarts are bit-identical.

The layout is the JAX package's, so a checkpoint written by either package
restores in the other.  A state is a flat or nested dict of numpy arrays,
tensors or scalars; its leaves are flattened in the JAX package's pytree
order (keys sorted) under its path names — an entry is ``['name']``,
nested entries are joined by ``/`` — and stored with ``/`` replaced by
``|``.  Tensors are saved from the host and restored onto the device of
the matching leaf of ``like_state``.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch


def _flatten(state, prefix: tuple = ()) -> list[tuple[str, object]]:
    """(path name, leaf) pairs in pytree order (dict keys sorted)."""
    if isinstance(state, dict):
        out = []
        for k in sorted(state):
            out += _flatten(state[k], prefix + (f"[{k!r}]",))
        return out
    return [("/".join(prefix), state)]


def _unflatten(like, leaves):
    """Rebuild ``like``'s structure from an iterator of leaves."""
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    return next(leaves)


def _to_host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu").numpy()
    return np.asarray(v)


def _npz_key(name: str) -> str:
    return name.replace("/", "|")


def save(ckpt_dir: str, step: int, state, extra: dict | None = None,
         keep: int = 3) -> str:
    """Write ``state`` as ``step_<step>.npz`` (atomically), then
    ``meta.json``, then drop all but the ``keep`` newest checkpoints."""
    os.makedirs(ckpt_dir, exist_ok=True)
    arrays = {_npz_key(k): _to_host(v) for k, v in _flatten(state)}
    tmp = os.path.join(ckpt_dir, f"tmp.{step}.npz")
    final = os.path.join(ckpt_dir, f"step_{step:08d}.npz")
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, final)                                   # atomic
    meta = {"latest_step": step, "extra": extra or {}}
    mtmp = os.path.join(ckpt_dir, "meta.tmp")
    with open(mtmp, "w") as f:
        json.dump(meta, f)
    os.replace(mtmp, os.path.join(ckpt_dir, "meta.json"))
    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: str, keep: int):
    ckpts = sorted(f for f in os.listdir(ckpt_dir)
                   if f.startswith("step_") and f.endswith(".npz"))
    for f in ckpts[:-keep]:
        try:
            os.remove(os.path.join(ckpt_dir, f))
        except OSError:
            pass


def _scan_steps(ckpt_dir: str) -> list[int]:
    """Step numbers of the complete checkpoints on disk.  Partial writes
    never match: they live under ``tmp.<step>.npz`` until the atomic
    ``os.replace``."""
    try:
        names = os.listdir(ckpt_dir)
    except FileNotFoundError:
        return []
    steps = []
    for f in names:
        if f.startswith("step_") and f.endswith(".npz"):
            try:
                steps.append(int(f[len("step_"):-len(".npz")]))
            except ValueError:          # host-sharded / foreign names
                pass
    return sorted(steps)


def latest_step(ckpt_dir: str) -> int | None:
    """Newest complete checkpoint step.

    The ``step_<N>.npz`` files are authoritative — each lands via one
    atomic ``os.replace``, so scanning them survives a crash between the
    npz replace and the ``meta.json`` replace (where meta is one step
    stale) and a torn or lost ``meta.json``.  ``meta.json`` is consulted
    only when no checkpoint file is found."""
    steps = _scan_steps(ckpt_dir)
    if steps:
        return steps[-1]
    meta = os.path.join(ckpt_dir, "meta.json")
    if not os.path.exists(meta):
        return None
    with open(meta) as f:
        return json.load(f).get("latest_step")


def restore(ckpt_dir: str, like_state, *, step: int | None = None):
    """Restore into the structure of ``like_state`` (arrays, tensors or
    scalars; each restored leaf takes its like-leaf's dtype, and a tensor
    leaf its device).  Returns (state, step, extra)."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}.npz")
    out = []
    with np.load(path) as data:
        for k, like in _flatten(like_state):
            a = data[_npz_key(k)]
            if isinstance(like, torch.Tensor):
                out.append(torch.from_numpy(a).to(device=like.device,
                                                  dtype=like.dtype))
            else:
                dt = np.asarray(like).dtype
                out.append(a.astype(dt) if a.dtype != dt else a)
    state = _unflatten(like_state, iter(out))
    extra = {}
    meta_path = os.path.join(ckpt_dir, "meta.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
        # extra describes the step meta.json last recorded; pairing it
        # with another step's arrays would silently desynchronize e.g. the
        # data-iterator state
        if meta.get("latest_step") == step:
            extra = meta.get("extra", {})
    return state, step, extra
