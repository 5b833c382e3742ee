"""Batched serving engine: prefill, then one decode step per new token
(PyTorch port).

``generate`` left-pads the prompts to the batch's longest with token 0
(the pads are attended to, as in the JAX package), runs
:func:`repro_torch.models.lm.prefill`, places each block's prefill cache
into decode buffers and decodes ``max_new_tokens - 1`` more tokens.

Every cache keeps an explicit per-block layout, so no axis is found by
its size: an attention block's buffer is (B, W, K, hd) with ``W = max_len``
for global blocks and ``min(window, max_len)`` for window blocks, whose
slot ``p % W`` holds position ``p``.  Decode masks slots to
``0 <= pos - p < window``, so a window block never attends past its
window whatever the prompt length.

On a mesh with a model group (``Engine(..., mesh=...)``, the reference's
``mesh`` argument) the model is placed by ``sharding.shard_params`` and
each rank keeps its share of the decode buffers: an attention block's
``W`` slots are rounded up to a multiple of the group's ``n`` ranks and
rank ``r`` holds slots ``[r * W / n, (r + 1) * W / n)`` of that ring
(``lm.init_cache``).  Every rank serves the whole batch and samples the
same tokens; a data axis replicates the engine.

Greedy sampling is ``argmax``.  Temperature sampling follows the
reference's key schedule (``PRNGKey(seed)`` for the first token, then one
``split`` per step) and ``jax.random.categorical``'s Gumbel-max recipe
through :mod:`repro_torch.core.prng`.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding
from repro_torch.launch.mesh import mesh_of
from repro_torch.models import lm
from repro_torch.models.common import ModelCfg


@dataclasses.dataclass
class ServeConfig:
    max_new_tokens: int = 32
    temperature: float = 0.0         # 0 => greedy
    seed: int = 0


def decode_cache(cfg: ModelCfg, cache: list, prompt_len: int,
                 max_len: int, ctx=None) -> list:
    """A prefill cache (``lm.prefill`` of ``prompt_len`` tokens) as decode
    buffers of ``max_len`` positions.  Each attention block's K/V, which
    holds positions ``[S - n, S)`` at rows ``[0, n)``, goes into ``W``
    slots with position ``p`` at slot ``p % W``; recurrent states are kept
    as they are.  With a model group in ``ctx`` the ring has
    ``lm.slots`` slots a rank and this rank keeps its own."""
    g = None if ctx is None else ctx.tp_group
    ranks = 1 if g is None else ctx.tp_size
    out = []
    for blk, c in zip(cfg.all_blocks(), cache):
        if blk.kind != "attn":
            out.append(c)
            continue
        Wl = lm.slots(blk, max_len, ranks)
        W = Wl * ranks
        placed = {}
        for name, x in c.items():
            n = x.shape[1]
            slots = torch.arange(prompt_len - n, prompt_len,
                                 device=x.device) % W
            buf = x.new_zeros((x.shape[0], W) + tuple(x.shape[2:]))
            buf[:, slots] = x
            if g is not None:
                buf = buf[:, ctx.tp_rank * Wl:(ctx.tp_rank + 1) * Wl]
            placed[name] = buf.clone() if g is not None else buf
        out.append(placed)
    return out


class Engine:
    """Serves ``model`` (an :class:`~repro_torch.models.lm.LM` of ``cfg``,
    whole) on ``device``; ``mesh`` (None, a ``launch.mesh.Mesh`` or a
    shape laid out over the process group): with a model group the model
    is placed on it (module docstring).  The engine takes ``model`` over:
    it moves it to ``device`` in place and, with a model group, cuts it
    to this rank's blocks (``sharding.shard_params``), so the caller
    keeps no whole copy.  After each ``generate``, ``timings`` holds the
    prefill seconds (to the first token on the host) and each decode
    step's."""

    def __init__(self, cfg: ModelCfg, model: lm.LM, scfg: ServeConfig,
                 device: "str | torch.device" = "cuda", mesh=None):
        self.device = resolve_device(device)
        self.cfg, self.scfg = cfg, scfg
        self.model = model.to(self.device)
        self.mesh = mesh_of(mesh)
        self.ctx = sharding.make_ctx(self.mesh)
        if self.ctx.tp_group is not None:
            sharding.shard_params(self.model, self.ctx)
        self.timings: dict = {}

    def prefill(self, tokens: torch.Tensor, max_len: int):
        """(B, S) prompt tokens -> (last logits, decode cache of
        ``max_len`` positions)."""
        logits, cache = lm.prefill(self.model, tokens)
        return logits, decode_cache(self.cfg, cache, tokens.shape[1],
                                    max_len, self.ctx)

    @torch.no_grad()
    def generate(self, prompts: list[list[int]],
                 max_new_tokens: Optional[int] = None) -> list[list[int]]:
        """Batched greedy / temperature generation."""
        new_toks = max_new_tokens or self.scfg.max_new_tokens
        B = len(prompts)
        S = max(len(p) for p in prompts)
        toks = np.zeros((B, S), np.int64)
        for i, p in enumerate(prompts):
            toks[i, S - len(p):] = p                     # left-pad
        t0 = time.perf_counter()
        logits, cache = self.prefill(
            torch.from_numpy(toks).to(self.device), S + new_toks)
        key = prng.PRNGKey(self.scfg.seed)
        cur = self._sample(logits, key)
        out = [[t] for t in cur.tolist()]
        self.timings = {"prefill_s": time.perf_counter() - t0, "step_s": []}
        for t in range(1, new_toks):
            t1 = time.perf_counter()
            key, sub = prng.split(key)
            logits, cache = lm.decode_step(self.model, cur[:, None], cache,
                                           S + t - 1)
            cur = self._sample(logits, sub)
            for row, tok in zip(out, cur.tolist()):
                row.append(tok)
            self.timings["step_s"].append(time.perf_counter() - t1)
        return out

    def _sample(self, logits: torch.Tensor, key: torch.Tensor
                ) -> torch.Tensor:
        if self.scfg.temperature <= 0.0:
            return logits.argmax(dim=-1)
        # a true division, as the reference's (CUDA would multiply by the
        # reciprocal of a Python scalar)
        temp = torch.full((), self.scfg.temperature, device=logits.device)
        return prng.categorical(key, logits / temp)
