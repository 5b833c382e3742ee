"""Fault-tolerant checkpointing: atomic, versioned, resumable.

* atomic: write to ``<dir>/tmp.<step>.npz`` then ``os.replace`` — a crash
  never leaves a partial checkpoint visible;
* versioned: ``step_<N>.npz`` + ``meta.json``; ``keep`` newest retained;
* resumable: :func:`restore` returns (state, step, extra) — ``extra``
  carries e.g. a data iterator's state so restarts are bit-identical;
* asynchronous: :func:`save_async` copies the state to the host, then
  writes the same files from a thread while training goes on;
* elastic: ``restore(..., shardings=)`` places each leaf on a target
  device and, for a leaf split over ranks, keeps this rank's block, so a
  checkpoint written on one mesh resumes on another (every leaf is
  saved whole: data-parallel ranks replicate the state, and expert- and
  tensor-parallel blocks are gathered before a save).

The layout is the JAX package's, so a checkpoint written by either package
restores in the other.  A state nests dicts, lists and tuples of numpy
arrays, tensors or scalars (``None`` holds no leaf); its leaves are
flattened in the JAX package's pytree order (dict keys sorted, sequences
in order) under its path names — a dict entry is ``['name']``, a sequence
entry ``[i]``, nested entries are joined by ``/`` — and stored with ``/``
replaced by ``|``: the trainer's ``{"params": [w0, w1], ...}`` saves
``['params']|[0]`` and ``['params']|[1]``.  Tensors are saved from the
host and restored onto the device of the matching leaf of ``like_state``;
bfloat16 tensors are stored as the JAX package stores them, as 2-byte
void entries.
"""

from __future__ import annotations

import json
import os
import threading

import numpy as np
import torch


def _flatten(state, prefix: tuple = ()) -> list[tuple[str, object]]:
    """(path name, leaf) pairs in pytree order (dict keys sorted)."""
    if isinstance(state, dict):
        out = []
        for k in sorted(state):
            out += _flatten(state[k], prefix + (f"[{k!r}]",))
        return out
    if isinstance(state, (list, tuple)):
        out = []
        for i, v in enumerate(state):
            out += _flatten(v, prefix + (f"[{i}]",))
        return out
    if state is None:
        return []
    return [("/".join(prefix), state)]


def _flatten_targets(shardings, like, prefix: tuple = ()):
    """(path, target) pairs of a ``shardings`` tree that matches ``like``
    (a device or None at each of ``like``'s leaves)."""
    if isinstance(like, dict):
        out = []
        for k in sorted(like):
            out += _flatten_targets(shardings[k], like[k],
                                    prefix + (f"[{k!r}]",))
        return out
    if isinstance(like, (list, tuple)):
        out = []
        for i, v in enumerate(like):
            out += _flatten_targets(shardings[i], v, prefix + (f"[{i}]",))
        return out
    if like is None:
        return []
    if isinstance(shardings, tuple):
        device, splits = shardings
        return [("/".join(prefix), (torch.device(device), splits))]
    return [("/".join(prefix),
             None if shardings is None else (torch.device(shardings), ()))]


def _unflatten(like, leaves):
    """Rebuild ``like``'s structure from an iterator of leaves."""
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves) for v in like)
    if like is None:
        return None
    return next(leaves)


def _to_host(v, copy: bool = False) -> np.ndarray:
    """``v`` as a host array; ``copy`` makes it storage of its own (a CPU
    tensor's array otherwise shares the tensor's)."""
    if isinstance(v, torch.Tensor):
        v = v.detach().to("cpu", copy=copy)
        if v.dtype == torch.bfloat16:
            # numpy has no bfloat16: the JAX package's npz holds its raw
            # 2-byte words as void ("|V2") entries, and so does this one
            return v.view(torch.int16).numpy().view("V2")
        return v.numpy()
    return np.array(v, copy=True) if copy else np.asarray(v)


def _npz_key(name: str) -> str:
    return name.replace("/", "|")


def _write(ckpt_dir: str, step: int, arrays: dict, extra, keep: int
           ) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
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


def _host_arrays(state, copy: bool = False) -> dict:
    return {_npz_key(k): _to_host(v, copy) for k, v in _flatten(state)}


def save(ckpt_dir: str, step: int, state, extra: dict | None = None,
         keep: int = 3) -> str:
    """Write ``state`` as ``step_<step>.npz`` (atomically), then
    ``meta.json``, then drop all but the ``keep`` newest checkpoints."""
    return _write(ckpt_dir, step, _host_arrays(state), extra, keep)


def save_async(ckpt_dir: str, step: int, state, extra: dict | None = None,
               keep: int = 3) -> threading.Thread:
    """Copy ``state`` to host memory now, then write :func:`save`'s files
    from a thread (training goes on during the write).  Returns the
    started thread; ``join`` it before reading the files."""
    arrays = _host_arrays(state, copy=True)
    t = threading.Thread(target=_write, daemon=True,
                         args=(ckpt_dir, step, arrays, extra, keep))
    t.start()
    return t


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


def restore(ckpt_dir: str, like_state, *, shardings=None,
            step: int | None = None):
    """Restore into the structure of ``like_state`` (arrays, tensors or
    scalars; each restored leaf takes its like-leaf's dtype, and a tensor
    leaf its device).  ``shardings``: a matching tree of target devices
    (None leaves keep the like-leaf's), the placement on the current
    mesh — elastic reshard on load; on a data-parallel mesh every leaf is
    replicated, so a target is this rank's device.  A target may also be
    ``(device, splits)``: the leaf is cut to this rank's block
    (``distributed.sharding.slice_leaf``).  Returns (state, step,
    extra)."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}.npz")
    likes = _flatten(like_state)
    targets = ([v for _, v in _flatten_targets(shardings, like_state)]
               if shardings is not None else [None] * len(likes))
    out = []
    with np.load(path) as data:
        for (k, like), target in zip(likes, targets):
            a = data[_npz_key(k)]
            if isinstance(like, torch.Tensor) or target is not None:
                t = (torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
                     if a.dtype == np.dtype("V2") else torch.from_numpy(a))
                dtype = (like.dtype if isinstance(like, torch.Tensor)
                         else t.dtype)
                device, splits = target if target is not None else (
                    like.device, ())
                if splits:
                    from repro_torch.distributed.sharding import slice_leaf
                    t = slice_leaf(t, splits)
                out.append(t.to(device=device, dtype=dtype))
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
