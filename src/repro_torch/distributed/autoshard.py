"""Floorline-informed step optimization (paper §VI-B; PyTorch port of
``repro.distributed.autoshard``).

The paper's stage-2 procedure, adapted: the "workload position" is the
three-term bound of the counted dry-run (core.tpu_floorline), the
"partitioning moves" are step variants, and the loop is the same
assumption-driven backtracking:

  1. measure the baseline; identify the dominant term (= bottleneck state);
  2. apply the candidate move with the best predicted delta on that term;
  3. re-count + re-analyze; keep if the bound improved >= min_gain,
     else BACKTRACK (revert the move — extra complexity without improvement
     costs exactly like neurocore over-utilization costs power);
  4. when the dominant term's moves are exhausted, shift the assumption to
     the next term; stop when every move fails (true boundary reached).

One card has no sharding moves: its moves are the remat policy and the
microbatch count (:func:`card_moves`).  Every step is an OptStep-style
record (hypothesis -> change -> before -> after -> verdict).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.core.analytical import Bottleneck


@dataclasses.dataclass
class Move:
    name: str
    hypothesis: str              # napkin math / predicted delta
    targets: Bottleneck          # which term this move attacks
    overrides: dict              # kwargs for the evaluator


@dataclasses.dataclass
class HillStep:
    iteration: int
    move: str
    hypothesis: str
    before: dict
    after: dict
    accepted: bool
    verdict: str


@dataclasses.dataclass
class HillResult:
    best: dict
    best_overrides: dict
    log: list[HillStep]

    def markdown(self) -> str:
        rows = ["| # | move | hypothesis | bound before | bound after | "
                "verdict |", "|---|------|------------|-----|-----|---------|"]
        for s in self.log:
            rows.append(
                f"| {s.iteration} | {s.move} | {s.hypothesis[:80]} | "
                f"{s.before['bound_s']:.4f}s | {s.after['bound_s']:.4f}s | "
                f"{'ACCEPT' if s.accepted else 'backtrack'}: {s.verdict} |")
        return "\n".join(rows)


def hillclimb(evaluate: Callable[..., dict], moves: list[Move], *,
              min_gain: float = 0.02, max_iters: int = 12) -> HillResult:
    """``evaluate(**overrides) -> roofline row dict`` (must include
    bound_s / t_compute_s / t_memory_s / t_collective_s / dominant)."""
    base = evaluate()
    current = dict(base)
    applied: dict = {}
    log: list[HillStep] = []
    remaining = list(moves)
    it = 0
    while remaining and it < max_iters:
        dom = current["dominant"]
        # paper ordering: attack the dominant term first, then the others
        remaining.sort(key=lambda m: 0 if m.targets.value == dom else 1)
        move = remaining.pop(0)
        it += 1
        trial = {**applied, **move.overrides}
        after = evaluate(**trial)
        gain = (current["bound_s"] - after["bound_s"]) / max(
            current["bound_s"], 1e-30)
        accepted = gain >= min_gain
        verdict = (f"bound {'-' if gain >= 0 else '+'}"
                   f"{abs(gain) * 100:.1f}%")
        log.append(HillStep(it, move.name, move.hypothesis,
                            dict(current), dict(after), accepted, verdict))
        if accepted:
            applied = trial
            current = dict(after)
    return HillResult(best=current, best_overrides=applied, log=log)


def card_moves(microbatches: int, remat: str) -> list[Move]:
    """The moves of a train step on one card: the other remat policy, and
    4x and 16x fewer (larger) microbatches."""
    other = "none" if remat == "block" else "block"
    moves = [Move(f"remat-{other}",
                  "no block recompute: about a quarter fewer FLOPs, more "
                  "live activations" if other == "none" else
                  "recompute each block: less live memory, a quarter more "
                  "FLOPs", Bottleneck.COMPUTE, {"remat": other})]
    for f in (4, 16):
        if microbatches % f == 0:
            moves.append(Move(
                f"microbatches-{microbatches // f}",
                f"{f}x larger microbatches read the weights {f}x fewer "
                "times", Bottleneck.MEMORY,
                {"microbatches": microbatches // f}))
    return moves
