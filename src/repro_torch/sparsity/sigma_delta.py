"""Per-layer sigma-delta threshold calibration (paper §VII-A, PilotNet).

The paper's baseline uses one uniform Σ-Δ threshold; its improved recipe
assigns thresholds per layer to hit per-layer sparsity targets, which
load-balances the deployed network (M0).  ``calibrate_thresholds`` solves
each layer's threshold by bisection on sample activation deltas.

Host-side numpy in float64, as in the JAX package: this is the calibration
tool, not the encoder kernel (:mod:`repro_torch.kernels.sigma_delta`).
"""

from __future__ import annotations

import numpy as np


def delta_sparsity(deltas: np.ndarray, theta: float) -> float:
    """Fraction of suppressed (|delta| <= theta) messages."""
    return float(np.mean(np.abs(deltas) <= theta))


def calibrate_thresholds(layer_deltas: list[np.ndarray],
                         target_sparsity: list[float] | float,
                         iters: int = 40) -> list[float]:
    """Bisection per layer: smallest theta with sparsity >= target."""
    if isinstance(target_sparsity, float):
        target_sparsity = [target_sparsity] * len(layer_deltas)
    thetas = []
    for deltas, tgt in zip(layer_deltas, target_sparsity):
        lo, hi = 0.0, float(np.max(np.abs(deltas)) + 1e-9)
        for _ in range(iters):
            mid = 0.5 * (lo + hi)
            if delta_sparsity(deltas, mid) >= tgt:
                hi = mid
            else:
                lo = mid
        thetas.append(hi)
    return thetas


def sigma_delta_densities(layer_acts_seq: list[np.ndarray],
                          thetas: list[float]) -> list[float]:
    """Message density per layer under calibrated thresholds: run the Σ-Δ
    encoder over each layer's (T, n) activation sequence and count firing
    messages — the measured-density column of a sigma-delta
    :class:`~repro_torch.sparsity.profile.SparsityProfile`."""
    dens = []
    for acts, theta in zip(layer_acts_seq, thetas):
        acts = np.asarray(acts, np.float64)
        ref = np.zeros_like(acts[0])
        fired = 0
        for t in range(acts.shape[0]):
            q, ref = sigma_delta_messages(acts[t], ref, theta)
            fired += int(np.count_nonzero(q))
        dens.append(fired / max(acts.size, 1))
    return dens


def sigma_delta_messages(acts_t: np.ndarray, acts_prev: np.ndarray,
                         theta: float):
    """Quantized Σ-Δ messaging for one step: (messages, new_reference).
    The numpy form of :func:`repro_torch.kernels.sigma_delta.ref.
    sigma_delta_ref`, for calibration."""
    delta = acts_t - acts_prev
    fire = np.abs(delta) > theta
    q = np.where(fire, delta, 0.0)
    return q, acts_prev + q
