"""Deterministic synthetic data pipelines (no external datasets): the JAX
package's ``repro.train.data``, numpy only, so both packages draw the same
batches bit for bit for any (seed, step).  Every pipeline is:

  * deterministic given (seed, step) — restart/elastic-safe: the iterator
    state IS the step counter, stored in every checkpoint;
  * host-sharded: ``batch_for_host(step, host_id, n_hosts)`` returns only
    this host's rows.

``lm_task`` generates token streams with learnable structure (a mixture of
Zipfian unigrams, a fixed Markov backbone, and copy motifs) so training
losses decrease measurably within a few hundred steps — used by the e2e
example and the convergence tests.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class LMTaskConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_states: int = 64          # Markov backbone states


class SyntheticLM:
    """Markov-backbone token stream: next-token entropy is well below
    log(V), so a model that learns reduces loss quickly."""

    def __init__(self, cfg: LMTaskConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        V, S = cfg.vocab_size, cfg.n_states
        # each backbone state prefers a small token subset
        self.emit = rng.integers(0, V, size=(S, 8))
        self.trans = rng.integers(0, S, size=(S, 4))

    def _rows(self, step: int, rows: np.ndarray) -> np.ndarray:
        cfg = self.cfg
        out = np.empty((len(rows), cfg.seq_len + 1), np.int32)
        for i, r in enumerate(rows):
            rng = np.random.default_rng(
                (self.cfg.seed * 1_000_003 + step) * 65_521 + int(r))
            s = int(rng.integers(0, cfg.n_states))
            for t in range(cfg.seq_len + 1):
                out[i, t] = self.emit[s, rng.integers(0, 8)]
                s = int(self.trans[s, rng.integers(0, 4)])
        return out

    def batch(self, step: int) -> dict[str, np.ndarray]:
        toks = self._rows(step, np.arange(self.cfg.global_batch))
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def batch_for_host(self, step: int, host_id: int,
                       n_hosts: int) -> dict[str, np.ndarray]:
        per = self.cfg.global_batch // n_hosts
        rows = np.arange(host_id * per, (host_id + 1) * per)
        toks = self._rows(step, rows)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class SyntheticDenoise:
    """(noisy, clean) feature pairs for the S5 audio-denoising reproduction
    (paper Table II / Fig 3): clean = sparse sinusoid mixture, noisy = clean
    + white noise."""

    def __init__(self, n_features: int, seq_len: int, global_batch: int,
                 seed: int = 0, snr: float = 0.5):
        self.n, self.S, self.B = n_features, seq_len, global_batch
        self.seed, self.snr = seed, snr

    def batch(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng(self.seed * 7919 + step)
        t = np.arange(self.S)[None, :, None] / self.S
        freqs = rng.integers(1, 12, size=(self.B, 1, self.n))
        phase = rng.uniform(0, 2 * np.pi, size=(self.B, 1, self.n))
        clean = np.sin(2 * np.pi * freqs * t + phase).astype(np.float32)
        mask = rng.random((self.B, 1, self.n)) < 0.5
        clean = clean * mask
        noisy = clean + self.snr * rng.standard_normal(
            clean.shape).astype(np.float32)
        return {"noisy": noisy, "clean": clean}


class SyntheticImages:
    """Procedural 10-class image-like classification task (AkidaNet /
    Speck reproduction stand-in for Imagenette/N-MNIST): class = which
    oriented-bar pattern dominates; solvable by small CNNs/MLPs."""

    def __init__(self, hw: int, channels: int, global_batch: int,
                 n_classes: int = 10, seed: int = 0):
        self.hw, self.c, self.B = hw, channels, global_batch
        self.k, self.seed = n_classes, seed
        rng = np.random.default_rng(seed)
        self.templates = rng.standard_normal(
            (n_classes, hw, hw, channels)).astype(np.float32)

    def batch(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng(self.seed * 104_729 + step)
        y = rng.integers(0, self.k, size=self.B)
        noise = rng.standard_normal(
            (self.B, self.hw, self.hw, self.c)).astype(np.float32)
        x = self.templates[y] * 1.5 + noise
        return {"x": np.maximum(x, 0.0), "y": y.astype(np.int32)}
