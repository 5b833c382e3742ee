"""Fault-tolerance layer for the search / pricing stack (PyTorch port).

The evolutionary mapping search is the system's long-running job.  Four
primitives keep it alive and honest, as in the JAX package:

* :class:`SearchCheckpointer` — crash-safe per-generation snapshots on the
  atomic ``os.replace`` + versioned ``step_<N>.npz`` layout of
  :mod:`repro_torch.train.checkpoint`.  Each snapshot is self-contained:
  the JSON meta (history, RNG state, evaluation ledger) rides inside the
  ``.npz`` next to the arrays it describes.  Resume is bit-identical to
  the uninterrupted run, and a snapshot written by either package restores
  in the other.
* :class:`FallbackChain` — graceful pricing degradation ``device -> vmap
  -> numpy`` with structured retry / backoff, the JAX package's three
  links.  The population backends agree at float64 roundoff, so a mid-run
  demotion changes the trajectory by at most rtol 1e-9 against a
  numpy-only run.
* :func:`quarantine_rows` — non-finite screening: NaN/inf (time, energy)
  rows get sentinel-worst ``+inf`` fitness, so they lose tournaments and
  survival deterministically; finite rows keep their exact values.
* :class:`FaultPlan` — the deterministic fault-injection harness: scripted
  exception throws per pricing backend or device search engine, scripted
  NaN pricing rows, and a simulated kill after generation ``g``
  (:class:`SimulatedCrash`), raised only after that generation's
  checkpoint landed.

The device search engines (:mod:`repro_torch.core.device_search`) keep
their own shell: a failing engine is retried per :class:`RetryPolicy`
and demoted to its host mirror, recorded as ``Demotion(frm="device" |
"sharded", to="numpy-mirror")``.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time

import numpy as np
import torch

from repro_torch.train import checkpoint as ckpt

log = logging.getLogger("repro_torch.resilience")

#: sentinel fitness for quarantined rows: +inf never dominates a finite row
#: and sorts after every finite (rank, time, energy) key.
QUARANTINE_SENTINEL = float("inf")

#: "fail this site forever" budget for :class:`FaultPlan` (any count larger
#: than the total number of pricing calls behaves identically).
ALWAYS = 1 << 30


class InjectedFault(RuntimeError):
    """A scripted backend failure thrown by a :class:`FaultPlan` — stands in
    for a build error, a device OOM, or a runtime pricing fault."""


class SimulatedCrash(BaseException):
    """A scripted process kill (:attr:`FaultPlan.kill_after_gen`).

    Derives from ``BaseException`` on purpose: a real ``kill -9`` is not
    catchable, so no retry / fallback handler (or user code catching
    ``Exception``) may absorb it."""


# ------------------------------------------------------------ fault plans

@dataclasses.dataclass
class FaultPlan:
    """Deterministic, scripted fault schedule for one search run.

    ``fail`` maps a site (a pricing-backend name, ``"device"`` or
    ``"numpy"``; for the device search engines ``"device"`` or
    ``"sharded"``) to a count: the first that-many :meth:`check` calls at
    the site raise :class:`InjectedFault` (:data:`ALWAYS` for a permanent
    outage).  ``nan_rows`` maps a global pricing-call index (0-based,
    counted by :meth:`corrupt` over successful population pricings) to the
    row indices whose (time, energy) become NaN.  ``kill_after_gen`` raises
    :class:`SimulatedCrash` from :meth:`after_generation` once that
    generation (and its checkpoint) has completed."""

    fail: dict = dataclasses.field(default_factory=dict)
    nan_rows: dict = dataclasses.field(default_factory=dict)
    kill_after_gen: int | None = None
    calls: int = 0          # successful population pricings seen so far

    def check(self, site: str) -> None:
        """Raise :class:`InjectedFault` while the site's budget lasts."""
        n = int(self.fail.get(site, 0))
        if n > 0:
            self.fail[site] = n - 1
            raise InjectedFault(f"injected failure at site {site!r}")

    def corrupt(self, reports: list) -> list:
        """Apply this pricing call's scripted NaN rows (in place) and
        advance the call counter."""
        rows = self.nan_rows.get(self.calls, ())
        self.calls += 1
        for k in rows:
            if 0 <= int(k) < len(reports):
                r = reports[int(k)]
                r.time_per_step = float("nan")
                r.energy_per_step = float("nan")
        return reports

    def corrupt_arrays(self, times, energies):
        """Array-form :meth:`corrupt` for pricers that hand back stacked
        objectives instead of report lists (the device engines' host
        mirrors): same schedule, same call counter."""
        rows = [int(k) for k in self.nan_rows.get(self.calls, ())]
        self.calls += 1
        if rows:
            times = np.asarray(times, np.float64).copy()
            energies = np.asarray(energies, np.float64).copy()
            for k in rows:
                if 0 <= k < times.shape[0]:
                    times[k] = energies[k] = float("nan")
        return times, energies

    def after_generation(self, gen: int) -> None:
        """Kill the run (once) after generation ``gen`` completed."""
        if self.kill_after_gen is not None and gen >= self.kill_after_gen:
            self.kill_after_gen = None
            raise SimulatedCrash(f"injected kill after generation {gen}")


# --------------------------------------------------------- fallback chain

@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Structured retry before demotion: ``max_retries`` extra attempts per
    backend, sleeping ``backoff_s * multiplier**attempt`` between them
    (default: one immediate retry)."""

    max_retries: int = 1
    backoff_s: float = 0.0
    multiplier: float = 2.0


@dataclasses.dataclass(frozen=True)
class Demotion:
    """One logged fallback-chain demotion record."""

    site: str       # where it happened ("population pricing", ...)
    frm: str        # backend given up on
    to: str         # backend demoted to
    error: str      # repr of the final exception at ``frm``
    retries: int    # attempts burned at ``frm`` beyond the first


class FallbackChain:
    """Sticky pricing-backend degradation ``device -> vmap -> numpy``.

    :meth:`run` calls ``attempt(backend)`` with the current backend,
    retrying per the :class:`RetryPolicy`; when a backend's retries are
    exhausted it demotes to the next link (logged, recorded in
    :attr:`demotions`) and stays there.  The numpy backend is the last
    link; its failure propagates.  :class:`SimulatedCrash` is never
    absorbed."""

    CHAIN = ("device", "vmap", "numpy")

    def __init__(self, backend: str = "numpy",
                 retry: RetryPolicy | None = None):
        self.backend = str(backend)
        self.retry = retry or RetryPolicy()
        self.demotions: list[Demotion] = []

    def _next(self) -> str | None:
        if self.backend in self.CHAIN:
            i = self.CHAIN.index(self.backend) + 1
            if i < len(self.CHAIN):
                return self.CHAIN[i]
        return None

    def run(self, attempt, *, site: str = "population pricing"):
        while True:
            delay = self.retry.backoff_s
            last: Exception | None = None
            for a in range(self.retry.max_retries + 1):
                if a and delay > 0:
                    time.sleep(delay)
                    delay *= self.retry.multiplier
                try:
                    return attempt(self.backend)
                except Exception as e:      # noqa: BLE001 — the whole point
                    last = e
            nxt = self._next()
            if nxt is None:
                raise last
            d = Demotion(site=site, frm=self.backend, to=nxt,
                         error=repr(last), retries=self.retry.max_retries)
            self.demotions.append(d)
            log.warning("fallback: %s backend %r failed after %d retries "
                        "(%s); demoting to %r", site, d.frm, d.retries,
                        d.error, d.to)
            self.backend = nxt


# --------------------------------------------------- non-finite quarantine

def _sentinel(xp, like):
    """The quarantine sentinel as a 0-d array of ``like``'s dtype (and, for
    a tensor, its device)."""
    if xp is torch:
        return torch.tensor(QUARANTINE_SENTINEL, dtype=like.dtype,
                            device=like.device)
    return xp.asarray(QUARANTINE_SENTINEL, dtype=like.dtype)


def quarantine_rows(xp, times, energies):
    """Screen per-candidate objectives for NaN/inf.

    Returns ``(times, energies, bad)`` where rows with a non-finite time
    *or* energy carry the sentinel-worst fitness ``(+inf, +inf)`` and
    ``bad`` marks them.  Finite rows are returned bit-unchanged.  ``xp`` is
    ``numpy`` or ``torch`` (pure ``where`` masking, no data-dependent
    shapes)."""
    bad = ~(xp.isfinite(times) & xp.isfinite(energies))
    inf = _sentinel(xp, times)
    return xp.where(bad, inf, times), xp.where(bad, inf, energies), bad


def finite_mean(xp, values):
    """Mean over the finite entries (``+inf`` when none are finite) — the
    quarantine-safe ``mean_time`` statistic.  With ``xp`` numpy or torch it
    equals that library's ``values.mean()`` bit for bit when everything is
    finite (same sum, same divisor)."""
    ok = xp.isfinite(values)
    n = ok.sum()
    zero = xp.zeros_like(values)
    total = xp.where(ok, values, zero).sum()
    denom = n.clamp(min=1) if xp is torch else xp.maximum(n, 1)
    return xp.where(n > 0, total / denom, _sentinel(xp, values))


def validate_resume_meta(meta: dict, *, engine: str,
                         checkpoint_dir: str | None,
                         expect: dict | None = None) -> None:
    """Shared engine-tag + run-config validation for checkpoint resume:
    ``engine`` is the resuming engine's tag; ``expect`` maps meta keys to
    the values the resuming run was configured with.  A mismatch raises
    ``ValueError`` instead of continuing a trajectory that could silently
    diverge."""
    got = meta.get("engine")
    if got != engine:
        raise ValueError(
            f"checkpoint in {checkpoint_dir!r} was written by the "
            f"{got!r} engine; resume it with engine={got!r}")
    for key, want in (expect or {}).items():
        have = meta.get(key)
        if have != want:
            raise ValueError(
                f"checkpoint in {checkpoint_dir!r} was written with "
                f"{key}={have!r} but this run uses {key}={want!r}; resume "
                "with the checkpoint's settings (or start a fresh run "
                "without resume=True)")


# ------------------------------------------------- serialization utilities

def encode_bytes_set(keys) -> tuple[np.ndarray, np.ndarray]:
    """A set of ``bytes`` phenotype keys -> (flat uint8 buffer, lengths),
    in sorted order (sorting makes the snapshot deterministic)."""
    ordered = sorted(keys)
    buf = np.frombuffer(b"".join(ordered), np.uint8).copy() \
        if ordered else np.zeros(0, np.uint8)
    lens = np.asarray([len(k) for k in ordered], np.int64)
    return buf, lens


def decode_bytes_set(buf: np.ndarray, lens: np.ndarray) -> set:
    raw = np.asarray(buf, np.uint8).tobytes()
    out, pos = set(), 0
    for n in np.asarray(lens, np.int64):
        out.add(raw[pos:pos + int(n)])
        pos += int(n)
    return out


def rng_state(rng: np.random.Generator) -> dict:
    """JSON-serializable bit-generator state (PCG64 state dicts hold plain
    ints and strings; JSON handles the 128-bit ints natively)."""
    return rng.bit_generator.state


def rng_from_state(state: dict) -> np.random.Generator:
    rng = np.random.default_rng()
    if state["bit_generator"] != rng.bit_generator.state["bit_generator"]:
        raise ValueError(
            f"checkpoint RNG is {state['bit_generator']!r}; this NumPy's "
            f"default_rng is {rng.bit_generator.state['bit_generator']!r}")
    rng.bit_generator.state = state
    return rng


# ----------------------------------------------------------- checkpointer

_META_KEY = "_meta_json"


class SearchCheckpointer:
    """Crash-safe search snapshots on the ``train/checkpoint`` layout.

    ``save`` writes one self-contained ``step_<gen>.npz`` through
    :func:`repro_torch.train.checkpoint.save` — tmp file + atomic
    ``os.replace``, ``keep`` newest retained, ``meta.json`` updated last.
    The snapshot's JSON meta is embedded in the npz (key ``_meta_json``),
    so every complete npz restores on its own; ``meta.json`` only carries
    a summary.  ``restore`` loads the newest complete snapshot (or an
    explicit ``step``), ignoring partial ``tmp.<N>`` writes."""

    def __init__(self, ckpt_dir: str, *, every: int = 1, keep: int = 3):
        self.dir = str(ckpt_dir)
        self.every = max(1, int(every))
        self.keep = max(1, int(keep))

    def due(self, gen: int, generations: int) -> bool:
        """Snapshot cadence: every ``every`` generations and always the
        final one (so a finished run restores as finished)."""
        return gen % self.every == 0 or gen >= generations

    def save(self, gen: int, arrays: dict, meta: dict) -> str:
        state = {k: np.asarray(v) for k, v in arrays.items()}
        if _META_KEY in state:
            raise ValueError(f"array name {_META_KEY!r} is reserved")
        blob = json.dumps(meta).encode("utf-8")
        state[_META_KEY] = np.frombuffer(blob, np.uint8).copy()
        summary = {"generation": int(gen), "engine": meta.get("engine")}
        return ckpt.save(self.dir, int(gen), state, extra=summary,
                         keep=self.keep)

    def latest(self) -> int | None:
        if not os.path.isdir(self.dir):
            return None
        return ckpt.latest_step(self.dir)

    def restore(self, step: int | None = None):
        """-> (arrays, gen, meta) of the newest complete snapshot, or
        ``None`` when the directory holds no checkpoint yet."""
        step = self.latest() if step is None else int(step)
        if step is None:
            return None
        path = os.path.join(self.dir, f"step_{step:08d}.npz")
        with np.load(path) as data:
            arrays = {}
            for key in data.files:
                name = key
                # reverse train/checkpoint's flat dict-path naming:
                # {"cores": ...} flattens to the npz key "['cores']"
                if name.startswith("['") and name.endswith("']"):
                    name = name[2:-2]
                arrays[name] = data[key]
        meta = json.loads(arrays.pop(_META_KEY).tobytes().decode("utf-8"))
        log.info("restored search checkpoint %s (generation %d)", path, step)
        return arrays, step, meta
