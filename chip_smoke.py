#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line:

  (a) build     — compile the CUDA kernels (``src/repro_torch/csrc/*.cu``)
                  with nvcc for sm_90a and load them.
  (b) main_path — a chip-filling Loihi-2 deployment at full width:
                  fc 1024-2048-1024-1024-512, sd_relu (threshold 0.05),
                  weight density 0.5, T = 1024 steps at input density 0.1.
                  Functional run through the event backend's kernel mode
                  (float32 values, int8 counters, value-only base rows: 11
                  ``event_matmul2`` launches per run_batch), single-
                  candidate pricing into a SimReport, a floorline fit over
                  five input densities, and the greedy §VI-B partitioner.
                  Kernel launch counts are zeroed just before and read just
                  after; every kernel must have launched.
  profile       — one more run_batch under torch.profiler: device busy
                  time, the device's idle share, the top kernels.
  (c) kernels   — every kernel against its plain PyTorch version on the
                  card, teacher-forced at the main path's own operands
                  (values in float32 and, joint, in bfloat16; counters as
                  float and as int8 masks; the value-only base rows), on a
                  strided conv stack through im2col, and on edge cases
                  (bm = 64 with a threshold); two launches of each of the
                  six instances (1-D and joint, float32 on the wgmma body
                  / bfloat16 / int8 on mma.sync) bit for bit, with and without a split k list; a layer's
                  two products in one library call (the bind kernel, then
                  each product; values and wire events that differ) at
                  whisper-base's values map (K = 12,000, copied to a
                  padded layout), its fc2 (read in place) and ragged
                  edges: values within ``EM_TOL``, counts, recorded live
                  tiles and padded copies exact.
  (d) dense     — the same workload through the dense backend.
  (e) times     — CUDA-event times of each kernel's launch alone (``ms``;
                  for the matmul, its library call: the bind kernel, the
                  product and its split reduction),
                  of its wrappers (the public one, which lays the weights
                  out per call, and the event backend's on cached
                  weights), of its plain version and of one PyTorch call
                  computing the same function, beside the card's bound for
                  the same work: by the method the kernel uses (3xTF32 at
                  the TF32 rate, int8, bytes) and at the fp32 FMA rate.
                  ``event_matmul2`` is timed at the largest value and
                  counter launches, the narrowest layer, a base-row value
                  launch, the largest delta stream with half its windows
                  quiet (dead activation tiles), whisper-base's fc2 at
                  M = 448 (448x2048 @ 2048x512, a split k list) and the
                  mamba2-1.3b head (1024x2048 @ 2048x50277), each value
                  launch's output held to the float64 product within
                  ``EM_TOL`` and to the plain version with its own error
                  as slack; the share
                  of live tile products of every main-path launch is
                  printed too.  ``window_cumsum`` at the widest stream.
  (f) frontend  — the model-zoo frontend at full width: whisper-base's full
                  config compiled at its decoder context (seq_len 448; 97
                  fc layers, 0.435 G weight entries) with every attention
                  site verified on the card, then 448 decoded tokens through
                  the event backend's kernel mode.  Launch counts are zeroed
                  before the compile and read after the run; every MAC
                  counter equals 448 * macs_per_token and every counter is
                  bit-identical to a dense run.  One more kernel-mode run
                  is traced as in ``profile``, with the device time of each
                  kernel family, and one recorded: 24 padded copies a
                  stream (both products of the 12 values maps of K =
                  12,000).
  (g) pricing   — four compiled smoke archs (gemma2, mamba2, olmoe, whisper)
                  priced on loihi2_like through kernel mode and dense; the
                  per-layer counters equal ``tests/golden/model_*.json``.
  (h) attention — ``attention_probe`` at all 18 lowered sites of full
                  whisper-base (seq_len 448) and all 26 of full gemma2-2b
                  (seq_len 8192), and edge cases (a window that bites,
                  ragged Sq != Skv with masked keys, GQA 10/1, hd 112,
                  B = 2, peaked scores from q x 4 at whisper's encoder
                  shape, hd 36, hd 3, ragged Sq = Skv = 1000): the flash
                  kernel within the frontend's own probe limit
                  (``PROBE_ATOL``, 2e-4) of its plain version.
  (i) times     — ``flash_attn`` at whisper's encoder site, its decoder
                  self-attention site (S 448, causal) and gemma2's global
                  site, as in (e), bound by 3xTF32 and at the fp32 FMA
                  rate, with nvcc's registers and spills per instance.
                  The library call is ``scaled_dot_product_attention`` at
                  whisper's sites and, for gemma2's tanh softcap,
                  ``flex_attention`` compiled by Inductor (its caches under
                  ``build/``), each held to the plain version first.
  (j) kernel_api — the public kernel API (``repro_torch.kernels``, the
                  JAX package's ``repro.kernels``) on the slice-1 cell's own
                  streams: ``sigma_delta_encode`` of fc0's (T, 2048)
                  activations against the state one step behind (theta
                  0.05), then ``event_matmul_pair`` of the messages with
                  fc1's weights and ``event_matmul`` of fc0's operands,
                  both without weight occupancy (the 1-D kernel).  Launch
                  counts are zeroed before and read after: one encoder and
                  three 1-D matmul launches, counters bit-identical.
  (k) kernels   — the 1-D ``event_matmul`` against its plain version: (j)'s
                  value product (fc1, 1024x2048 @ 2048x1024, on the encoded
                  messages), and at fc0 (1024x1024 @ 1024x2048) float32
                  with every tile live, 25% of the tiles live in float32
                  and bfloat16, and whisper-base's fc2 shape at M = 448;
                  the pair on fc0's teacher-forced operands (counters equal
                  to dense and to ``event_matmul2``'s).  The encoder bit for
                  bit against its plain version at fc0's stream and at
                  whisper-base's widest map (1500, 2048), float32 and bf16.
  (l) times     — both kernels as in (e), and each launch alone after a
                  write that evicts the L2 (``time_ms_cold``); the encoder's
                  ``ms`` is that cold time.  The library call is
                  ``torch.matmul`` for the 1-D matmul, none for the encoder.
  (m) population — 1024 (partition, mapping) candidates of the slice-1 cell
                  (the minimal partition and the greedy walk's, each with
                  ordered, strided and random mappings) priced through
                  ``evaluate_population`` with the ``numpy`` and ``device``
                  backends from one pricing cache: device within rtol 1e-9
                  of numpy, 16 spread-out candidates bit-identical to
                  ``simulate``, evaluation counts exact; candidates per
                  second, cache build time, peak device memory.
  (n) guidance  — floorline guidance per layer at the slice-1 cell.
  (o) sparsity_profile — ``tests/golden/trained_profile.npz`` (loaded with
                  the port's ``SparsityProfile``) applied, seed 0, to the
                  slice-1 cell: its 3 activation densities resampled to the
                  4 layers (0.3, 0.4, 0.367, 0.2) as message gates, exact-
                  density weight masks at 0.6 / 0.8 / 0.7 / 0.7 over the
                  existing weights.  A kernel-mode ``run_batch`` of the
                  profiled cell launches ``event_matmul2`` and
                  ``window_cumsum`` as (b) does, with counters bit-identical
                  to dense; live-tile shares and wall times.  Phase (g) also
                  reproduces the three golden fixtures priced under that
                  profile.
  (p) search    — ``greedy_then_evolve`` on the profiled cell (population
                  64, 10 generations, seed 0) through a ``SimEvaluator``
                  with the profile, kernel mode and the ``device``
                  population backend, then again with ``numpy`` on the same
                  cache: no demotion, never worse than the greedy walk, a
                  non-empty front, the best and the knee re-priced by
                  ``simulate`` within rtol 1e-9, every generation's best
                  time within rtol 1e-9 across the backends; candidates per
                  second per backend.
  (q) resume    — each backend's search killed after generation 4
                  (``FaultPlan``, the scripted ``SimulatedCrash``) and
                  resumed from its snapshots under ``build/repro_torch/
                  ckpt/`` (scratch): the result equals the uninterrupted
                  run's, bit for bit where the device pricer gives the same
                  bits twice and in other batches (checked first), else
                  within rtol 1e-9.  Then ``FaultPlan(fail={"device": 2})``:
                  exactly one demotion, device to vmap (the chain's next
                  link), and a trajectory within rtol 1e-9 of the
                  numpy-only run.
  (r) device_search — ``evolutionary_search(engine="device")`` on the
                  profiled cell from (p)'s cache and greedy walk
                  (population 64, 10 generations, seed 0, a snapshot every
                  generation), then its host mirror (``reference=True``):
                  identical genomes, stages and hot layers in all 11
                  snapshots, objectives within rtol 1e-9, the same final
                  candidate and front, no demotion.  The threefry draws on
                  the card equal the CPU's bit for bit at the cell's
                  shapes.  Wall, seconds per generation, time per stage,
                  peeled fronts and host syncs per generation, and a
                  population-1024 throughput run (candidates/s, peak
                  bytes).
  (s) sharded_search — ``engine="sharded"`` with one island, bit for bit
                  the device engine; with four islands of 16 (migration
                  every 5 generations) held to the island host mirror as
                  in (r).
  (t) device_resilience — ``FaultPlan(fail={"device": 2})``: exactly one
                  demotion to the numpy mirror, then (r)'s trajectory; a
                  kill after generation 4 resumed to (r)'s final state
                  (bit for bit where (q) found the device pricer
                  repeating its bits).
  (u) sparsity_training — ``SparseTrainer`` on the card at chip-filling
                  width: the images task (hw 32, 2 channels), fc
                  2048-2048-1024-1024-10 (7.35 M weights, 113 of
                  loihi2_like's 120 cores dense), batch 64, seed 0.  A
                  dense baseline of 200 steps, whose first 20 losses the
                  host repeats from the same initial weights (each within
                  ``TRAIN_LOSS_TOL`` times the first loss; one initial layer
                  is also drawn on the host and must equal the card's bit
                  for bit); floorline weights from its deployment (probe
                  T = 8); guided tl1 at
                  lambda 0.05, a one-shot prune to 0.5 at step 200 and 60
                  masked fine-tune steps, each mask keeping exactly
                  round(n * 0.5); the same run killed at step 130 and resumed
                  from its checkpoint equals it bit for bit.  Seconds per
                  step, the device's idle share over 10 traced steps,
                  accuracy and activation density of each run.
  (v) iso_accuracy — for the dense and the guided run: ``extract_profile``,
                  ``deploy``, one kernel-mode ``run_batch`` of the held-out
                  probe stream (launches counted, counters bit-identical to
                  dense), then ``evolutionary_search(engine="device")``
                  (population 20, 10 generations, seed 0) held to its host
                  mirror snapshot by snapshot; each run's (accuracy, knee
                  time, knee energy) and the paper's iso-accuracy verdict,
                  as ``benchmarks/iso_accuracy.py`` computes it (no verdict
                  is gated).  The winning profile is injected into
                  gemma2-2b's smoke config (``compile_network(act_density=
                  profile)``) against its mean density.
  (w) sigma_delta_training — the denoise task at the slice-1 cell's widths
                  (fc 1024-2048-1024-1024-1024), 100 steps, then
                  ``calibrate_sigma_delta(0.1)``: thresholds within rtol
                  1e-6 of the host's calibration of the same weights.  The
                  deployed sd_relu network runs the held-out rows of step
                  11,000 on (384 steps, past the 128-step delta window) in
                  kernel mode, so ``window_cumsum`` launches beside
                  ``event_matmul2``; counters bit-identical to dense, or
                  within rtol 1e-3 per layer total where quantiser ties move
                  messages (the line says which held); measured message
                  densities against the profile's.

  (x) serve     — the model and serving stack: full-width gemma2-2b in
                  bf16 (2.61 G parameters) built by ``repro_torch.launch.
                  serve`` (weights from seed 0), batch 4, 128-token
                  prompts from ``np.random.default_rng(0)``, 32 new
                  tokens, greedy, after one warm ``generate``: prefill
                  seconds, decode ms per token (the median over steps
                  after the first) beside the weight-streaming bound (the
                  weights' bytes at 3.35 TB/s), tokens per second, peak
                  device memory; 8 decode steps under torch.profiler
                  (idle share, device operations per step); temperature
                  0.8, seed 1, twice: identical tokens.  Every token lies
                  in [0, vocab).  Launch counts of the five ported
                  kernels are zeroed before and read after: the serving
                  path launches none of them (the JAX package's serving
                  path reaches no Pallas kernel).  Also counts how often
                  CUDA's division by a Python scalar (a reciprocal
                  product) differs from a true division.
  (y) serve_check — the same model in float32 (10.4 GB), batch 1, greedy,
                  on a 128-token prompt (+16), a 4090-token one (+16,
                  crossing the 4096 window during decode) and a 5120-
                  token one (+8, prefill through ``_chunked_sdpa`` and the
                  ring roll): the engine's tokens equal the argmax of
                  ``forward`` on the growing sequence, and its logits at
                  every step are within ``SERVE_LOGIT_ATOL`` of the
                  forward's; argmax margins below that are printed.
  (z) serve_families — the nine decoder-only smoke configs and whisper's
                  (encode, cross cache, greedy ``decode_step``) on the
                  card and on the host from the same float32 weights:
                  greedy tokens equal, prefill and decode logits within
                  the CPU tests' tolerance; then full-width whisper-base
                  (1500 frames, 32 decode steps, float32): ``decode_step``
                  logits against ``decode_train``'s.

  (A) lm_train  — training of the LM stack: full-width gemma2-2b in bf16
                  (2.61 G parameters, as published) built by
                  ``repro_torch.launch.train`` (weights from seed 0; AdamW
                  by ``for_arch``; ``lr_for``'s cosine schedule at lr
                  1e-3), ``SyntheticLM`` at vocab 256,000, seq_len 1024,
                  global batch 2, seed 0, one microbatch, 8 steps through
                  ``Trainer.run``: seconds per step (the median after the
                  first), tokens/s, model-FLOP utilisation (6 N tokens
                  per step over 989 TFLOP/s), the step's bound (GEMM
                  operations at 989 TFLOP/s plus AdamW's bytes at 3.35
                  TB/s, ``lm_step_bound``), peak device memory, 2 more
                  steps under torch.profiler (idle share, device
                  operations per step) and the loss curve.  Every loss
                  finite, the last below the first.
  (B) lm_grad_check — full-width gemma2-2b in float32, one batch of
                  1 x 512 tokens: the gradient's directional derivative
                  <g, d> along seeded random directions d (N(0, 0.02^2)
                  per entry: over all leaves, then the embedding, the
                  attention, the MLP and the norm leaves alone) against
                  the central difference of the loss, within
                  ``GRAD_CHECK_RTOL``.  The difference is Richardson-
                  extrapolated from steps h and h / 2, over h = eps /
                  2**k, k = 0 to 6, eps the step at which the loss moves
                  by 1e-3 at first order; of those, the estimate that
                  agrees best with the one at the next larger step
                  (Ridders' choice: between truncation at large steps
                  and the float32 loss's roundoff at small ones).
  (C) lm_train_families — the nine decoder-only smoke configs and
                  whisper's ``encdec.loss_fn``, float32, on the card and
                  on the host from the same weights: loss, metrics and
                  every gradient leaf; the parameters after one AdamW and
                  one Adafactor step (factoring from 32) on the host's
                  gradients; granite's smoke config through one
                  ``num_microbatches=2`` step and two ``compress_grads``
                  steps, each computing its own gradients; within the CPU
                  tests' tolerances.
  (D) lm_resume — granite-3-2b's smoke ``Trainer`` on the card for 12
                  steps (checkpoints every 4 under ``build/repro_torch/
                  ckpt/lm``, scratch): killed at the start of step 8 and
                  resumed from its checkpoint, step 12's loss equal to the
                  continuous run's (bit for bit, or within rtol 1e-5: the
                  line says which held); a ``RuntimeError`` scripted at
                  step 6 restored exactly once, and no recovery in any
                  other run.
                  Launch counts of the five ported kernels are zeroed
                  before (A) and read after (A), (C) and (D): the
                  training path launches none of them (the JAX package's
                  reaches no Pallas kernel).

  (E) step_bound — the step's three-term bound (``repro_torch.core.
                  {hlo_cost,tpu_floorline}``): (A)'s full-width gemma2-2b
                  bf16 step (batch 2 x 1024, AdamW) counted once on the
                  card's tensors (matmul FLOPs, HBM bytes of every
                  dispatched op, collective bytes 0), its compute, memory
                  and link terms beside ``lm_step_bound`` and (A)'s
                  measured step, and the step's ratio to each bound; the
                  same cell counted on meta by the dry-run (the same FLOPs
                  required) with its flash-adjusted terms and its peak of
                  live bytes beside (A)'s measured peak.  Each dtype's
                  products are priced at its own peak.  Then olmoe-1b-7b (full width, 6 of its
                  16 layers, so that AdamW fits) and mamba2-1.3b (full),
                  bf16, batch 2 x 1024: seconds per step (median of 5 after
                  a warm-up), the counted bound and the step over it.
  (F) dryrun    — ``repro_torch.launch.dryrun`` on meta tensors (nothing
                  allocated) over every arch's train_4k cell at full size
                  (the whole sweep is the CLI's ``--all``): dominant term,
                  bound, useful-FLOPs ratio and whether it fits the card;
                  then one ``hillclimb`` over gemma2-2b's train_4k cell
                  with one card's moves (remat, microbatch count), its
                  markdown log printed.  Both phases require that no ported
                  kernel launched.

  (G) event_options — ``EventCompute``'s options on the slice-1 cell
                  (fc 1024-2048-1024-1024-512, T = 1024) copied onto the
                  1/8 grid: weights and inputs rounded to nonzero
                  multiples of 1/8 and the sigma-delta threshold 0.125, so
                  every sum is exact in float32 in any order (on the float
                  cell, phase (d) shows quantiser ties moving messages
                  between summation orders); inputs bursty, with events in
                  the first 64 of every 256 steps.  Five option sets in
                  kernel mode on the card (``delta_window`` 16 and 32,
                  ``delta_mode="cumsum"``, ``threshold=0.05``, ``bm = bk =
                  64``), each against the host's gather run with the same
                  options: every counter bit-identical, outputs within
                  phase (d)'s rtol; launches counted per set (11
                  ``event_matmul2`` and 3 ``window_cumsum`` windowed, 8 and
                  0 for cumsum); ``run_batch`` walls side by side, windowed
                  and cumsum (the sd_window arm of the JAX package's
                  ``benchmarks/sim_speed.py``).
  (H) vmap_pricing — phase (m)'s 1024 candidates priced from phase (p)'s
                  cache (the profiled cell) through ``evaluate_population``
                  with the ``vmap``, ``device`` and ``numpy`` backends:
                  vmap and device within rtol 1e-9 of numpy; candidates
                  per second each; then ``FaultPlan(fail={"device": 2})``:
                  exactly one demotion, device to vmap, as the JAX
                  package records it, priced within rtol 1e-9 of numpy.

  (I) data_parallel — the data-parallel half over a one-rank process
                  group (NCCL, ``file://`` store): (I.a) full-width
                  gemma2-2b in bf16 with AdamW at batch 2 x 1024: the exact
                  DP step's loss and parameters bit-identical to the step
                  without a group, then s a step of both paths and of the
                  compressed step (int8 with error feedback) beside phase
                  (A)'s, the NCCL all-reduce of the gradient tree and the
                  compressed mean alone, traced NCCL time, peaks; (I.b)
                  olmoe-1b-7b (full width, 6 of 16 layers): ``loss_fn``
                  and its gradients through the expert-parallel MoE over
                  the group bit-identical to the path without one; (I.c)
                  the island search with 4 islands over the group on phase
                  (s)'s cell, genomes identical to the one-program run and
                  to phase (s)'s snapshots in every generation; (I.d)
                  granite's smoke ``Trainer`` on a (1, 1) mesh over the
                  group, a ``save_async`` while it trains on (step times
                  during the write), restored bit-identical to a
                  synchronous save.  No ported kernel may launch.
  (J) tensor_parallel — the tensor-parallel code over a (1, 1) mesh on a
                  one-rank process group (NCCL), so that its model group
                  is real: (J.a) phase (x)'s cell through ``Engine(...,
                  mesh=...)`` (full-width gemma2-2b, bf16, batch 4, 128-
                  token prompts, 32 new tokens): tokens equal to (x)'s,
                  decode ms a token beside (x)'s, 7 decode steps traced
                  (device ops, idle share, NCCL kernels); (J.b) 2 AdamW
                  steps of phase (A)'s cell through the launcher's
                  ``Trainer`` with ``--mesh-shape 1,1``: losses and every
                  parameter
                  bit-identical to the same steps without a group, s a
                  step and peaks of both; (J.c) the collective launches of
                  one decode step and one train step
                  (``collectives.TP_CALLS``) equal to the count derived
                  from the code (``tp_calls_per_step``); (J.d)
                  ``PerfFlags(True, True)`` on full-width gemma2-2b and
                  olmoe-1b-7b (6 of 16 layers): loss and gradients
                  bit-identical to the path without a group; olmoe's,
                  mamba2's and recurrentgemma's smoke configs on the card
                  over the group, with and without the flags, against the
                  host.  No ported kernel may launch.
  (K) init      — the LM weights from the JAX package's key: full-width
                  gemma2-2b in bf16 drawn from ``PRNGKey(0)`` on the card
                  (``lm.init_params``: the reference's ``truncated_normal``
                  on the port's threefry, in chunks), its seconds and peak
                  bytes beside the model's own; the host draws again every
                  leaf of the first pattern repeat and of the last block,
                  and the first and last 2**22 elements of ``embed`` from
                  their offsets: bit for bit.  The same for olmoe-1b-7b at
                  phase (E)'s 6 of 16 layers, holding every block's
                  float32 router and the ends of ``embed`` and
                  ``unembed``.  Phases (x), (A), (I) and (J) start from
                  these weights.  No ported kernel may launch.
  (L) neuron_scan — the ssm state neurons' scan (``csrc/neuron_scan.cu``)
                  at one state layer of ``mamba2-1.3b-6of48.ssm1024``
                  (T = 1,024, n = 4,096, decay 0.5, a row slice of a
                  padded block): messages and final state bit for bit
                  with the loop on the card for both ``force_active``
                  values, one launch a call, and the launch alone (warm
                  and cold L2), the wrapper and the loop timed beside
                  the 10.0 us bytes bound.  Then one stream of the cell
                  itself (the registry's mamba2-1.3b cut to 6 blocks and
                  the published 50,277-wide head, T = 1,024) through
                  ``run_batch`` in kernel mode, recorded: one launch a
                  state layer (6), ``neuron_scan.entries`` 6 x 1,024
                  x 4,096, every layer's float32 value product (19) held
                  to the float64 product and the plain version as in
                  (e), the output and all five counters bit for bit with
                  the same stream through the loop.  Phases (f)
                  and (g) count the launches too: none for whisper-base,
                  one a state layer and ``run_batch`` for every
                  compiled fixture.
                  The neuron epilogue (``csrc/neuron_epilogue.cu``): one
                  launch a layer (19) and 18 wire handoffs on that
                  stream, and the kernel alone at the head's shape
                  (1,024 x 50,277, force-active, row slices of the padded
                  product), each neuron code bit for bit with the plain
                  version, timed beside its bytes bound (five maps).
                  Phases (f) (97 launches), (g) (one a layer and
                  ``run_batch``), (L), (u)-(w) (one a layer) and (G) (one
                  a layer and option set) count its launches, and each
                  holds its kernel-mode runs' outputs and five counters
                  bit for bit with the same run through the eager glue
                  without the handoff (``glue_parity``), printing both
                  runs' SHA-256 digests.

Then a ``{"kernels": [...]}`` line, the card's name and power limit as
nvidia-smi reports them, and a last line ``{"ok": true, "device": ...}``.
Any failed check raises: the script exits non-zero and prints no result.
It exits non-zero without a result when no GPU is visible, or when the
port's package is not beside it.
"""

from __future__ import annotations

import json
import os
import pathlib
import statistics
import shutil
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# Published H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit;
# one table, in the port's floorline): HBM3 bandwidth, the float32 rate
# outside the tensor cores, and the tensor-core rates: TF32 (the float32
# value products run as 3xTF32: three TF32 products per multiply-add),
# bf16 and int8 (0/1 counter products are exact in int8 with int32 sums).
from repro_torch.core.tpu_floorline import HBM_BW as PEAK_BYTES_PER_S
from repro_torch.core.tpu_floorline import PEAK_FLOPS as PEAK_BF16_FLOPS
from repro_torch.core.tpu_floorline import (PEAK_FP32_FLOPS, PEAK_INT8_OPS,
                                            PEAK_TF32_FLOPS)
TILE = 128
DEVICE = "cuda"
SLICE1_SIZES = (1024, 2048, 1024, 1024, 512)   # the slice-1 cell, (b)
SLICE1_T = 1024
THETA = 0.05                          # sigma-delta threshold, phases (j)-(l)
K_POP = 1024                          # candidates priced in phase (m)
PROFILE_PATH = ROOT / "tests" / "golden" / "trained_profile.npz"
SEARCH = dict(population_size=64, generations=10, seed=0)   # phases (p)-(t)
KILL_AFTER = 4                        # phases (q) and (t): scripted crash
THROUGHPUT = dict(population_size=1024, generations=5, seed=0)  # phase (r)
ISLANDS = dict(n_islands=4, migrate_every=5)                    # phase (s)
# phase (u): the images task at chip-filling width (hw 32, 2 channels)
TRAIN_SIZES = (2048, 2048, 1024, 1024, 10)
TRAIN = dict(steps=200, batch=64, seed=0, lam=0.05, prune_sparsity=0.5,
             finetune_steps=60)
TRAIN_KILL = 130                      # (u): kill, then resume
CPU_STEPS = 20                        # (u): first losses against the CPU
PROBE_STEPS = 8                       # (v): T of the held-out probe stream
ISO_SEARCH = dict(population_size=20, generations=10, seed=0)    # (v)
ISO_ARCH = "gemma2-2b"                # (v): the first model-zoo arch
ACC_TOL = 0.01                        # (v): "matched accuracy" band
# phase (w): the denoise task at the slice-1 cell's widths
DENOISE_SIZES = (1024, 2048, 1024, 1024, 1024)
DENOISE_STEPS = 100
SD_TARGET = 0.1                       # (w): calibrated message density
SD_STEPS = 256                        # (w): held-out rows, at least

# phases (x)-(z): the model and serving stack
SERVE_ARCH = "gemma2-2b"
SERVE = dict(batch=4, prompt_len=128, new_tokens=32)          # (x)
SERVE_TRACE_STEPS = 8                 # (x): decode steps under the profiler
SERVE_SAMPLE = dict(temperature=0.8, seed=1)                  # (x)
CHECK_PROMPTS = ((128, 16), (4090, 16), (5120, 8))  # (y): (prompt, new)
FAMILY_STEPS = 6                      # (z): greedy tokens per smoke config
WHISPER_STEPS = 32                    # (z): full-width whisper decode steps

# phases (A)-(D): training of the LM stack
LM_ARCH = "gemma2-2b"
LM_TRAIN = dict(steps=8, batch=2, seq=1024, lr=1e-3)         # (A)
LM_TRACE_STEPS = 2                    # (A): steps under the profiler
GRAD_CHECK = dict(batch=1, seq=512, seed=0, scale=0.02,      # (B)
                  loss_change=1e-3, halvings=6)
RESUME = dict(steps=12, kill=8, fault=6, ckpt_every=4)       # (D)
BOUND_MOE_REPEATS = 6                 # (E): olmoe's 16 layers cut to fit
BOUND_STEPS = 5                       # (E): timed steps after a warm-up
DRYRUN_SHAPES = ("train_4k",)         # (F): the sweep's cells, on meta
# phase (G): EventCompute's options on the slice-1 cell copied onto the 1/8
# grid, its input bursty: events in the first 64 steps of every 256
OPTION_PERIOD, OPTION_KEEP = 256, 64
OPTION_THETA = 0.125                  # (G): sigma-delta threshold, 1/8
OPTION_REPS = 3                       # (G): timed run_batch calls
EVENT_OPTIONS = (("delta_window=16", dict(delta_window=16)),
                 ("delta_window=32", dict(delta_window=32)),
                 ("delta_mode=cumsum", dict(delta_mode="cumsum")),
                 ("threshold=0.05", dict(threshold=0.05)),
                 ("bm=bk=64", dict(bm=64, bk=64)))
VMAP_BACKENDS = ("vmap", "device", "numpy")   # (H)
# phase (I): the data-parallel half over a one-rank process group
DP_STEPS = 4                          # (I.a): timed steps of each path
ASYNC_CKPT = dict(save_at=4, steps=8)  # (I.d): steps before and after

# phase (J): tensor parallelism over a one-rank model group
TP_STEPS = 2                          # (J.b): steps of phase (A)'s cell
TP_SMOKE = ("olmoe-1b-7b", "mamba2-1.3b", "recurrentgemma-2b")   # (J.d)
# phase (K): the weights from the reference's key, card against host
INIT_SEED = 0                         # (K): PRNGKey(0), as (x), (A), (I), (J)
INIT_EDGE = 1 << 22                   # (K): embed elements held at each end
INIT_PEAK_LIMIT = 20e9                # (K): bytes allocated by one init
# phase (L): the ssm scan at a state layer of mamba2-1.3b-6of48.ssm1024
SCAN_T, SCAN_N, SCAN_DECAY = 1024, 4096, 0.5
SCAN_PAD = 64                         # (L): columns of the padded block
SCAN_BLOCKS, SCAN_VOCAB = 6, 50_277   # (L): the cell's depth and head

# stated tolerances
GRAD_CHECK_RTOL = 1e-2                # (B) <g, d> vs the central difference
LM_LOSS_RTOL, LM_GRAD_ATOL = 1e-6, 2e-5  # (C) card vs host: the CPU tests'
                                      # (grads: of a leaf's largest entry)
OPT_RTOL, OPT_ATOL = 1e-5, 1e-7       # (C) optimizers on the same grads
STEP_ATOL = 0.1                       # (C) end-to-end steps, times the lr
ERR_ATOL, ERR_FLIPS = 1e-6, 1e-3      # (C) compressed step's errors
RESUME_RTOL = 1e-5                    # (D) the reference's resume bound
PRE_RTOL, PRE_ATOL = 1e-5, 1e-5       # kernel vs plain / dense pre-acts
WIN_RTOL, WIN_ATOL = 1e-6, 1e-6       # window_cumsum kernel vs plain
REPORT_RTOL = 1e-3                    # event vs dense time / energy
EM_TOL = {"float32": (1e-6, 1e-5),    # 1-D event_matmul vs plain (rtol,
          "bfloat16": (2e-2, 2e-2)}   # atol); bf16 compared in bf16
POP_RTOL = 1e-9                       # device vs numpy population pricing
SEARCH_RTOL = 1e-9                    # search objectives across backends
TRAIN_LOSS_TOL = 1e-3                 # (u) card vs CPU, first losses: the
                                      # largest difference over the first
REPORT_ARRAYS = ("times", "energies", "per_core_synops", "per_core_acts",
                 "per_core_msgs_out")
REPORT_SCALARS = ("time_per_step", "energy_per_step", "max_synops",
                  "max_acts", "max_link_load")
SERVE_LOGIT_ATOL = 2e-3               # (y), (z) full width, float32: decode
                                      # logits vs the full forward's
FAMILY_RTOL, FAMILY_ATOL = 1e-5, 2e-5  # (z) card vs host: the CPU tests'
FIELDS = ("msgs_in", "macs", "fetches_dense", "msgs_out", "acts_evented")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def close(a, b, rtol, atol, what: str) -> float:
    import torch
    err = float((a - b).abs().max()) if a.numel() else 0.0
    require(torch.allclose(a, b, rtol=rtol, atol=atol),
            f"{what}: max abs err {err} beyond rtol={rtol} atol={atol}")
    return err


def exact(a, b, what: str) -> None:
    import torch
    require(torch.equal(a, b), f"{what}: not bit-identical")


def f32_product_errors(y, x, w, occ, what: str) -> dict:
    """A float32 product ``y`` of the event matmul held as the card tests
    hold the wgmma body: to the float64 product within ``EM_TOL``, and to
    the plain version (``event_matmul2_ref`` at threshold 0, joint with
    the weight-tile occupancy ``occ``) with that version's own float32
    error as the only slack -- the plain float32 product strays up to
    1.9e-5 at K = 8,512, so EM_TOL alone cannot hold the kernel to it.
    Dead activation tiles and unoccupied weight tiles are zeros, so the
    float64 product is ``x @ w``.  Returns the largest errors."""
    import torch
    from repro_torch.kernels.event_matmul.ops import _pad_to
    from repro_torch.kernels.event_matmul.ref import event_matmul2_ref
    rtol, atol = EM_TOL["float32"]
    M, N = y.shape
    want = x.double() @ w.double()
    plain = event_matmul2_ref(_pad_to(x, (TILE, TILE)),
                              _pad_to(w, (TILE, TILE)), occ, threshold=0.0,
                              bm=TILE, bk=TILE, bn=TILE)[:M, :N].double()
    err = (y.double() - want).abs()
    slack = (plain - want).abs()
    off = (y.double() - plain).abs()
    past = float((err - rtol * want.abs()).max())
    past_plain = float((off - rtol * plain.abs() - slack).max())
    out = {"float64_max_abs_err": float(err.max()),
           "plain_float64_max_abs_err": float(slack.max()),
           "plain_max_abs_err": float(off.max())}
    require(past <= atol and past_plain <= atol,
            f"{what}: {out} beyond rtol={rtol} atol={atol} (float64 "
            f"{past}, plain with its own error as slack {past_plain})")
    del want, plain, err, slack, off
    return out


def reports_close(got, want, rtol: float) -> float:
    """Hold two lists of SimReports to each other over the fields of the
    JAX package's population parity check (arrays with an atol of rtol,
    scalars as np.isclose, stages, core counts and M0 metrics); returns
    the largest relative difference where the wanted value is nonzero."""
    import numpy as np
    import torch
    worst = 0.0
    for f in REPORT_ARRAYS:
        a = torch.cat([getattr(r, f) for r in got])
        b = torch.cat([getattr(r, f) for r in want])
        require(a.shape == b.shape and torch.allclose(a, b, rtol=rtol,
                                                      atol=rtol),
                f"population {f} beyond rtol {rtol}")
        nz = b != 0
        if bool(nz.any()):
            worst = max(worst, float(((a - b)[nz] / b[nz]).abs().max()))
    for f in REPORT_SCALARS + ("msgs_total", "weight_density",
                               "act_density"):
        src = (lambda r: getattr(r.metrics, f)) if f in (
            "msgs_total", "weight_density", "act_density") else (
            lambda r: getattr(r, f))
        a = np.array([src(r) for r in got])
        b = np.array([src(r) for r in want])
        require(bool(np.isclose(a, b, rtol=rtol).all()),
                f"population {f} beyond rtol {rtol}")
        nz = b != 0
        if nz.any():
            worst = max(worst, float(np.abs((a - b)[nz] / b[nz]).max()))
    for x, y in zip(got, want):
        require((x.bottleneck_stage, x.n_cores_active)
                == (y.bottleneck_stage, y.n_cores_active),
                "population stage or core count")
        for m in ("synops", "acts", "traffic"):
            u, v = getattr(x.metrics, m), getattr(y.metrics, m)
            require((u.n_units, u.n_active) == (v.n_units, v.n_active)
                    and np.allclose([u.total, u.max, u.imbalance],
                                    [v.total, v.max, v.imbalance],
                                    rtol=rtol, atol=0.0),
                    f"population metrics.{m}")
    return worst


def reports_identical(a, b) -> bool:
    import torch
    return (all(torch.equal(getattr(a, f), getattr(b, f))
                for f in REPORT_ARRAYS)
            and all(getattr(a, f) == getattr(b, f) for f in
                    REPORT_SCALARS + ("bottleneck_stage", "n_cores_active",
                                      "metrics")))


def gpu_name_and_limit() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, batches: int = 5) -> float:
    """Median over ``batches`` of the mean time of ``reps`` back-to-back
    calls, timed with CUDA events around each batch (after a warm-up)."""
    import torch
    fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(batches):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        per_call.append(a.elapsed_time(b) / reps)
    return statistics.median(per_call)


def time_ms_cold(fn, reps: int = 20) -> float:
    """Median time of ``reps`` calls, each timed alone with CUDA events
    after a 256 MB write that evicts the 50 MB L2, so the call reads its
    inputs from HBM (the host enqueues the call while the write runs)."""
    import torch
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(reps):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        per_call.append(a.elapsed_time(b))
    return statistics.median(per_call)


def flash_ptxas(log: pathlib.Path) -> dict:
    """nvcc's report for each flash_attn instance (its head-dim class HD,
    16- or 4-byte copies): the registers and spill lines that follow its
    entry in build.log."""
    import re
    out, hd = {}, None
    for line in log.read_text().splitlines() if log.exists() else []:
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            m = re.search(r"flash_attn_kernelILi(\d+)ELb(\d)E",
                          entry.group(1))
            hd = (f"HD {m.group(1)}, {16 if m.group(2) == '1' else 4}-byte "
                  "copies" if m else None)
        elif hd and ("registers" in line or "spill" in line):
            out.setdefault(hd, []).append(line.split(":", 1)[-1].strip())
    return out


#: Kernel families in a trace, by substrings of their kernels' names: the
#: block-sparse matmul is its tile body plus the split-sum pass.
FAMILIES = {"event_matmul": ("event_matmul_kernel", "reduce_splits"),
            "event_bind": ("event_bind",),
            "flash_attn": ("flash_attn",),
            "window_cumsum": ("window_cumsum",),
            "sigma_delta": ("sigma_delta",)}


def traced(fn, match: dict | None = None) -> dict:
    """Wall time, device busy time, the device's idle share, the number of
    device operations (kernels, copies, fills), the device time of each
    kernel family and the top kernels of one call of ``fn`` under
    torch.profiler (ending in a synchronise); with ``match`` (name ->
    substrings of kernel names) also the device seconds and calls of the
    kernels each name matches."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as trace:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side events only: a host op's self device time repeats the
    # time of the kernels it launched
    dev_us = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0.0))
    by_kernel = sorted(((e.key, dev_us(e), e.count)
                        for e in trace.key_averages()
                        if e.device_type == torch.autograd.DeviceType.CUDA
                        and dev_us(e) > 0), key=lambda r: -r[1])
    busy_s = sum(us for _, us, _ in by_kernel) * 1e-6
    families = {f: sum(us for k, us, _ in by_kernel
                       if any(p in k for p in parts)) * 1e-6
                for f, parts in FAMILIES.items()}
    matched = {f: {"device_s": sum(us for k, us, _ in by_kernel
                                   if any(p in k for p in parts)) * 1e-6,
                   "calls": sum(n for k, _, n in by_kernel
                                if any(p in k for p in parts))}
               for f, parts in (match or {}).items()}
    return {"wall_s": wall, "device_ops": sum(n for _, _, n in by_kernel),
            **({"matched": matched} if match else {}),
            "device_busy_s": busy_s if busy_s else "not measured",
            "device_idle_share": (1 - busy_s / wall) if busy_s
            else "not measured",
            "family_device_s": families if busy_s else "not measured",
            "top_kernels": [{"name": k[:90], "device_s": us * 1e-6,
                             "calls": n} for k, us, n in by_kernel[:10]]}


def recorder():
    """A kernel-mode event backend that keeps every synaptic forward's
    operands (``.calls``) and every value-only pass's (``.bases``,
    ``.deltas``), for the teacher-forced checks of phases (c) and (o)."""
    from repro_torch.neuromorphic import EventCompute

    class Recorder(EventCompute):
        def __init__(self):
            super().__init__(mode="kernel")
            self.calls, self.deltas, self.bases = [], [], []

        def forward(self, layer, x_eff, act_mask, msgs_in):
            self.calls.append((layer, x_eff, act_mask, msgs_in))
            return super().forward(layer, x_eff, act_mask, msgs_in)

        def value_forward(self, layer, x_eff):
            self.bases.append((layer, x_eff))
            return super().value_forward(layer, x_eff)

        def delta_forward(self, layer, x_in, in_acc, act_mask, msgs_in):
            self.deltas.append((layer, x_in, in_acc.clone()))
            return super().delta_forward(layer, x_in, in_acc, act_mask,
                                         msgs_in)
    return Recorder()


def plain_glue_run(net, xs, compute):
    """``net.run_batch(xs)`` as the port ran it before the neuron
    epilogue: each layer's ``step_batch`` recomputes its wire events from
    its input, and the eager glue (``neuron_epilogue_ref``) stands in the
    epilogue's place.  Returns ``(outputs, counters)``."""
    import torch
    from repro_torch.kernels.neuron_epilogue.ref import neuron_epilogue_ref
    from repro_torch.neuromorphic import network as network_mod

    states, accs = net.init_states(), net.init_accs()
    cur = torch.as_tensor(xs, dtype=torch.float32, device=net.device)
    cnts = []
    kept = network_mod.neuron_epilogue
    network_mod.neuron_epilogue = neuron_epilogue_ref
    try:
        for i, layer in enumerate(net.layers):
            cur, states[i], c, accs[i] = layer.step_batch(
                cur, states[i], accs[i], compute=compute)
            cnts.append(c)
    finally:
        network_mod.neuron_epilogue = kept
    return cur.reshape(xs.shape[0], -1), cnts


def run_digest(out, cnts) -> str:
    """SHA-256 of a run's outputs and every layer's five counters, in
    layer and field order (the bits, as numpy holds them on the host)."""
    import hashlib
    h = hashlib.sha256()
    for a in [out] + [getattr(c, f) for c in cnts for f in FIELDS]:
        h.update(a.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def glue_parity(net, xs, compute, got, what: str) -> dict:
    """Requires ``got``, a ``run_batch`` of ``net`` on ``xs`` (the neuron
    epilogue, the wire handed on), bit for bit with
    :func:`plain_glue_run` on the same operands: outputs and all five
    counters of every layer.  Returns both runs' :func:`run_digest`."""
    import torch
    bits = lambda a: a.view({8: torch.int64, 4: torch.int32}[
        a.element_size()])
    out, cnts = plain_glue_run(net, xs, compute)
    exact(bits(got[0]), bits(out), f"{what}: outputs against the eager glue")
    for layer, a, b in zip(net.layers, got[1], cnts, strict=True):
        for f in FIELDS:
            exact(bits(getattr(a, f)), bits(getattr(b, f)),
                  f"{what}: {layer.name} {f} against the eager glue")
    return {"digest": run_digest(*got), "plain_digest": run_digest(out, cnts)}


def live_tiles(x, w):
    """(Mb, Nb, Kb) bool live tile products of ``x @ w``, the padded
    ``x``, its tile activity and the weight-tile occupancy, as the
    wrapper computes them."""
    from repro_torch.kernels.event_matmul.ops import (pad_compact,
                                                      weight_block_occupancy)
    xp, active, _, _ = pad_compact(x, 0.0)
    occ = weight_block_occupancy(w)
    return active[:, None, :] & occ.T[None, :, :], xp, active, occ


def search_phases(net, xs, chip, *, ckpt_root, expect_launches: dict,
                  card: str, search: dict = SEARCH,
                  throughput: dict = THROUGHPUT,
                  islands: dict = ISLANDS) -> tuple:
    """Phases (o) to (t) on the slice-1 cell ``(net, xs, chip)``: the
    committed trained profile applied to it, the greedy-then-evolutionary
    search over the profiled cell with both population backends,
    kill-and-resume plus a scripted demotion, then the device engines
    (:func:`device_search_phases`).  ``expect_launches`` is the kernel
    launches of one ``run_batch`` of the cell (none on the CPU, where
    every wrapper runs its plain version).  Search snapshots go under
    ``ckpt_root`` (scratch, emptied first).  Returns the profiled cell's
    network and phase (p)'s pricing cache (phase H prices from it)."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.core import resilience as R
    from repro_torch.core.partitioner import SimEvaluator
    from repro_torch.core.search import (Population, evolutionary_search,
                                         greedy_then_evolve)
    from repro_torch.kernels.event_matmul.ops import event_matmul2
    from repro_torch.kernels.sigma_delta.ops import window_cumsum
    from repro_torch.neuromorphic import (EventCompute, simulate,
                                          simulate_population)
    from repro_torch.sparsity import SparsityProfile

    counted = {"event_matmul2": event_matmul2, "window_cumsum": window_cumsum}

    def sync():
        if net.device.type == "cuda":
            torch.cuda.synchronize()

    def zero():
        for fn in counted.values():
            fn.launches = 0

    def launches():
        return {k: fn.launches for k, fn in counted.items()}

    # ----------------------------------------- (o) the trained profile
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    profile = SparsityProfile.load(PROFILE_PATH)
    dens = profile.densities_for(len(net.layers))
    pnet = profile.apply(net, seed=0)
    sync()
    apply_s = time.perf_counter() - t0
    require(np.allclose(dens, [0.3, 0.4, 0.55 / 1.5, 0.2], rtol=1e-12,
                        atol=0.0), f"resampled densities {dens}")
    for i, (a, b) in enumerate(zip(net.layers, pnet.layers)):
        keep = int(round(float(dens[i]) * b.n_neurons))
        require(int(b.msg_gate.sum()) == keep, f"{b.name}: gate count")
        wd = float(profile.weight_density[min(i, profile.n_layers - 1)])
        require(int((b.weights != 0).sum())
                <= int(round(wd * b.n_weights)), f"{b.name}: mask count")
        require(bool(((b.weights == 0) | (b.weights == a.weights)).all()),
                f"{b.name}: masked weights are not the original ones")
    rec = recorder()
    zero()
    sync()
    t0 = time.perf_counter()
    run_o = pnet.run_batch(xs, compute=rec)
    sync()
    run_s = time.perf_counter() - t0
    launches_o = launches()
    require(launches_o == expect_launches,
            f"profiled run_batch launches {launches_o} != {expect_launches}")
    t0 = time.perf_counter()
    run_dense = pnet.run_batch(xs, compute="dense")
    sync()
    dense_s = time.perf_counter() - t0
    for layer, a, b in zip(pnet.layers, run_o[1], run_dense[1]):
        for f in FIELDS:
            exact(getattr(a, f), getattr(b, f), f"profiled {layer.name} {f}")
    require(bool(torch.isfinite(run_o[0]).all()), "profiled: non-finite")
    live = [[float(live_tiles(x, layer.weights)[0].float().mean()),
             float(live_tiles(m, layer.w_mask)[0].float().mean())]
            for layer, x, m, _ in rec.calls]
    del rec
    T = xs.shape[0]
    emit({"phase": "sparsity_profile", "source": str(
        PROFILE_PATH.relative_to(ROOT)), "seed": 0,
        "profile_layers": list(profile.layer_names),
        "act_density_programmed": dens.tolist(),
        "weight_density_applied": [
            float(profile.weight_density[min(i, profile.n_layers - 1)])
            for i in range(len(net.layers))],
        "weight_density_after": [l.w_nnz / l.n_weights for l in pnet.layers],
        "message_density_measured": [
            float(c.msgs_out.to(torch.float64).sum()) / (T * l.n_neurons)
            for l, c in zip(pnet.layers, run_o[1])],
        "launches": launches_o, "counters": "bit-identical to dense",
        "live_share_value_counter_per_call": live,
        "load_apply_s": apply_s, "run_batch_s": run_s,
        "dense_run_batch_s": dense_s,
        "phase_wall_s": time.perf_counter() - t_phase})

    # ---------------------------------------------------- (p) the search
    class Timed(SimEvaluator):
        """The evaluator, with the wall time and the candidates of its
        population pricings summed (each call ends in a synchronise)."""

        def __init__(self, *args, **kw):
            self.pricing_s, self.priced = 0.0, 0
            super().__init__(*args, **kw)

        def evaluate_population(self, candidates):
            cands = list(candidates)
            t = time.perf_counter()
            try:
                return super().evaluate_population(cands)
            finally:
                sync()
                self.pricing_s += time.perf_counter() - t
                self.priced += len(cands)

    t_phase = time.perf_counter()
    zero()
    sync()
    t0 = time.perf_counter()
    ev_dev = Timed(net, xs, chip, compute=EventCompute(mode="kernel"),
                   population_backend="device", sparsity_profile=profile)
    sync()
    cache_s = time.perf_counter() - t0
    launches_p = launches()
    require(launches_p == expect_launches,
            f"profiled precompute_pricing launches {launches_p}")
    for a, b in zip(pnet.layers, ev_dev.net.layers):   # (o)'s net, again
        exact(a.weights, b.weights, f"{a.name}: profiled weights")
        exact(a.msg_gate, b.msg_gate, f"{a.name}: profiled gate")
    pnet = ev_dev.net
    shutil.rmtree(ckpt_root, ignore_errors=True)
    ckpt = {b: ckpt_root / f"search_{b}" for b in ("device", "numpy")}
    runs = {}
    for backend, ev in (("device", ev_dev),
                        ("numpy", Timed(pnet, xs, chip, cache=ev_dev.cache))):
        t0 = time.perf_counter()
        greedy, evo = greedy_then_evolve(
            pnet, chip, ev, checkpoint_dir=str(ckpt[backend]),
            checkpoint_keep=search["generations"] + 1, **search)
        sync()
        runs[backend] = dict(greedy=greedy, evo=evo, ev=ev,
                             wall=time.perf_counter() - t0)
        require(ev.demotions == [] and evo.demotions == []
                and ev.active_backend == backend,
                f"{backend} search: demotions {ev.demotions}, active "
                f"backend {ev.active_backend}")
        require(evo.report.time_per_step <= greedy.report.time_per_step,
                f"{backend} search worse than the greedy walk")
        require(len(evo.front) > 0, f"{backend} search: empty front")
        for what, (cand, rep) in (("best", (evo.candidate, evo.report)),
                                  ("knee", evo.knee())):
            again = simulate(pnet, xs, chip, cand.partition(),
                             cand.mapping(), precomputed=run_o)
            require(bool(np.isclose(rep.time_per_step, again.time_per_step,
                                    rtol=SEARCH_RTOL, atol=0.0)
                         and np.isclose(rep.energy_per_step,
                                        again.energy_per_step,
                                        rtol=SEARCH_RTOL, atol=0.0)),
                    f"{backend} {what}: search report vs simulate")
    h_dev, h_np = runs["device"]["evo"].history, runs["numpy"]["evo"].history
    require(len(h_dev) == len(h_np), "history lengths")
    best_rel = [abs(a.best_time - b.best_time) / b.best_time
                for a, b in zip(h_dev, h_np)]
    require(max(best_rel) <= SEARCH_RTOL,
            f"per-generation best_time device vs numpy {best_rel}")
    snaps = {b: R.SearchCheckpointer(str(d)) for b, d in ckpt.items()}
    same_genomes = 0
    for g in range(len(h_np)):
        a, _, _ = snaps["device"].restore(g)
        b, _, _ = snaps["numpy"].restore(g)
        same_genomes += int(np.array_equal(a["cores"], b["cores"])
                            and np.array_equal(a["perm"], b["perm"]))
    emit({"phase": "search", "cell": "slice-1, trained profile (seed 0)",
          "card": card,
          "search": search, "cache_build_s": cache_s,
          "profiled_precompute_pricing_launches": launches_p,
          "greedy": {"iters": len(runs["numpy"]["greedy"].history),
                     "time_per_step":
                         runs["numpy"]["greedy"].report.time_per_step,
                     "partition": list(
                         runs["numpy"]["greedy"].partition.cores)},
          "best": {b: {"time_per_step": r["evo"].report.time_per_step,
                       "energy_per_step": r["evo"].report.energy_per_step,
                       "partition": list(r["evo"].partition.cores),
                       "front": len(r["evo"].front),
                       "seed_best_time": r["evo"].seed_best_time}
                   for b, r in runs.items()},
          "best_time_per_generation": {"device": [h.best_time
                                                  for h in h_dev],
                                       "numpy": [h.best_time for h in h_np]},
          "max_rel_diff_best_time": max(best_rel), "rtol": SEARCH_RTOL,
          "generations_with_identical_genomes": [same_genomes, len(h_np)],
          "n_evals": {b: r["evo"].n_evals for b, r in runs.items()},
          "evaluator_n_evals": {b: r["ev"].n_evals for b, r in runs.items()},
          "wall_s": {b: r["wall"] for b, r in runs.items()},
          "pricing_s": {b: r["ev"].pricing_s for b, r in runs.items()},
          "candidates_per_s": {b: r["ev"].priced / r["ev"].pricing_s
                               for b, r in runs.items()},
          "demotions": "none (both backends)",
          "phase_wall_s": time.perf_counter() - t_phase})

    # ---------------------------------------- (q) resume and demotion
    t_phase = time.perf_counter()
    # does the device pricer give the same bits twice, and in another
    # batch?  (its sums use scatter_add_, index_add_ and scatter_reduce)
    last, _, _ = snaps["device"].restore()
    pop = Population(last["cores"], last["perm"])
    pairs = pop.pairs()
    price = lambda ps: simulate_population(pnet, xs, chip, ps,
                                           cache=ev_dev.cache,
                                           backend="device")
    first, second = price(pairs), price(pairs)
    # the same rows in reverse order, and the first 7 alone (a resume
    # re-prices survivors and the front in batches of their own)
    other = price(pairs[::-1])[::-1] + price(pairs[:7])
    fields = REPORT_ARRAYS + REPORT_SCALARS + ("bottleneck_stage",)

    def differing(xs_, ys_):
        out = set()
        for x, y in zip(xs_, ys_):
            for f in fields:
                u, v = getattr(x, f), getattr(y, f)
                if not (torch.equal(u, v) if isinstance(u, torch.Tensor)
                        else u == v):
                    out.add(f)
        return sorted(out)
    diff_twice = differing(first, second)
    diff_batch = differing(first + first[:7], other)
    deterministic = not diff_twice and not diff_batch
    resumed = {}
    for backend in ("numpy", "device"):
        d = ckpt_root / f"resume_{backend}"
        greedy = runs[backend]["greedy"]
        crashed = False
        try:
            evolutionary_search(
                pnet, chip, SimEvaluator(pnet, xs, chip, cache=ev_dev.cache,
                                         population_backend=backend,
                                         fallback=False),
                greedy=greedy, checkpoint_dir=str(d),
                fault_plan=R.FaultPlan(kill_after_gen=KILL_AFTER), **search)
        except R.SimulatedCrash:          # the scripted kill under test
            crashed = True
        require(crashed, f"{backend}: the scripted kill did not fire")
        require(R.SearchCheckpointer(str(d)).latest() == KILL_AFTER,
                f"{backend}: newest snapshot after the kill")
        t0 = time.perf_counter()
        res = evolutionary_search(
            pnet, chip, SimEvaluator(pnet, xs, chip, cache=ev_dev.cache,
                                     population_backend=backend,
                                     fallback=False),
            greedy=greedy, checkpoint_dir=str(d), resume=True, **search)
        sync()
        resume_s = time.perf_counter() - t0
        full = runs[backend]["evo"]
        bits = backend == "numpy" or deterministic
        a, _, _ = R.SearchCheckpointer(str(d)).restore()
        b, _, _ = snaps[backend].restore()
        for k in sorted(b):
            if b[k].dtype.kind != "f":
                require(np.array_equal(a[k], b[k]),
                        f"{backend} resume: final snapshot {k}")
        objs = lambda h: np.array([[g.best_time, g.best_energy, g.mean_time]
                                   for g in h])
        ft = lambda r: np.array([[x.time_per_step, x.energy_per_step]
                                 for x in r.front_reports])
        # final population and archive objectives, the history's, the
        # front reports'
        floats = [(a[k], b[k]) for k in sorted(b) if b[k].dtype.kind == "f"]
        floats += [(objs(res.history), objs(full.history)),
                   (ft(res), ft(full))]
        same_bits = all(x.shape == y.shape and np.array_equal(x, y)
                        for x, y in floats)
        require(same_bits or not bits, f"{backend} resume: not bit for bit")
        require(all(np.allclose(x, y, rtol=SEARCH_RTOL, atol=0.0)
                    for x, y in floats),
                f"{backend} resume: objectives beyond rtol {SEARCH_RTOL}")
        worst = max(float(np.max(np.abs(x - y)[y != 0] / np.abs(y[y != 0]),
                                 initial=0.0)) for x, y in floats)
        hist = lambda h: [(g.generation, g.n_evals, g.front_size,
                           g.n_quarantined) for g in h]
        require(hist(res.history) == hist(full.history),
                f"{backend} resume: history counts")
        genomes = lambda cs: [(c.cores, c.perm) for c in cs]
        require(genomes(res.front) == genomes(full.front)
                and genomes([res.candidate, res.knee()[0]])
                == genomes([full.candidate, full.knee()[0]]),
                f"{backend} resume: best, front or knee genomes")
        resumed[backend] = {"killed_after_generation": KILL_AFTER,
                            "held_to": "bit-identical" if bits
                            else f"rtol {SEARCH_RTOL}",
                            "bit_identical": same_bits,
                            "max_rel_diff": worst, "resume_s": resume_s}
    ev_f = SimEvaluator(pnet, xs, chip, cache=ev_dev.cache,
                        population_backend="device")
    res_f = evolutionary_search(pnet, chip, ev_f,
                                greedy=runs["device"]["greedy"],
                                fault_plan=R.FaultPlan(fail={"device": 2}),
                                **search)
    dem = ev_f.demotions
    require(len(dem) == 1 and (dem[0].frm, dem[0].to) == ("device", "vmap")
            and res_f.demotions == dem and ev_f.active_backend == "vmap",
            f"scripted demotion: {dem}")
    f_rel = [abs(a.best_time - b.best_time) / b.best_time
             for a, b in zip(res_f.history, h_np)]
    require(len(res_f.history) == len(h_np) and max(f_rel) <= SEARCH_RTOL,
            f"demoted run vs numpy-only run {f_rel}")
    emit({"phase": "resume", "device_pricer_deterministic": deterministic,
          "fields_differing_when_priced_twice": diff_twice,
          "fields_differing_in_another_batch": diff_batch,
          "population_checked": len(pairs), "resume": resumed,
          "scripted_demotion": {"fault_plan": "fail={'device': 2}",
                                "retry": "RetryPolicy() (one retry)",
                                "demotions": [dataclasses.asdict(x)
                                              for x in dem],
                                "max_rel_diff_best_time_vs_numpy":
                                    max(f_rel)},
          "checkpoints": str(ckpt_root),
          "phase_wall_s": time.perf_counter() - t_phase})

    device_search_phases(pnet, xs, chip, cache=ev_dev.cache,
                         greedy=runs["numpy"]["greedy"],
                         numpy_wall=runs["numpy"]["wall"],
                         same_bits_twice=not diff_twice,
                         ckpt_root=ckpt_root, card=card, search=search,
                         throughput=throughput, islands=islands)
    return pnet, ev_dev.cache, runs["numpy"]["greedy"]


def snapshots(d) -> list[dict]:
    """Every generation's search snapshot under ``d``, oldest first."""
    from repro_torch.core import resilience as R
    ck = R.SearchCheckpointer(str(d))
    return [ck.restore(g)[0] for g in range(ck.latest() + 1)]


def held_to_mirror(got, want, sg, sw, what: str, gens: int,
                   exact: bool = False) -> float:
    """Require identical genomes, stages and hot layers in every
    generation's snapshot (``sg`` against ``sw``), the same history counts,
    final candidate and front, and objectives within SEARCH_RTOL (equal,
    ``exact``); returns the largest relative objective difference."""
    import numpy as np
    require(len(sg) == len(sw) == gens + 1, f"{what}: snapshots")
    worst = 0.0
    floats = []
    for g, (a, b) in enumerate(zip(sg, sw)):
        for k in ("cores", "perm", "stage", "hot_mem", "hot_act",
                  "arch_cores", "arch_perm"):
            require(np.array_equal(a[k], b[k]),
                    f"{what}: generation {g} {k} differs")
        floats += [(a[k], b[k]) for k in ("times", "energies",
                                          "arch_times", "arch_energies")]
    h = lambda r: np.array([[x.best_time, x.best_energy, x.mean_time]
                            for x in r.history])
    floats.append((h(got), h(want)))
    for x, y in floats:
        require(x.shape == y.shape and (
            np.array_equal(x, y) if exact else
            np.allclose(x, y, rtol=SEARCH_RTOL, atol=0.0)),
            f"{what}: objectives beyond "
            f"{'bit identity' if exact else SEARCH_RTOL}")
        nz = y != 0
        if nz.any():
            worst = max(worst, float(np.max(np.abs(x - y)[nz]
                                            / np.abs(y[nz]))))
    counts = lambda r: [(x.generation, x.n_evals, x.front_size,
                         x.n_quarantined) for x in r.history]
    genomes = lambda cs: [(tuple(c.cores), tuple(c.perm)) for c in cs]
    require(counts(got) == counts(want), f"{what}: history counts")
    require(genomes([got.candidate]) == genomes([want.candidate])
            and genomes(got.front) == genomes(want.front),
            f"{what}: final candidate or front")
    return worst


def device_search_phases(pnet, xs, chip, *, cache, greedy, numpy_wall: float,
                         same_bits_twice: bool, ckpt_root, card: str,
                         search: dict, throughput: dict,
                         islands: dict) -> None:
    """Phases (r) to (t): the device-resident search engines on the
    profiled cell ``(pnet, xs, chip)``, priced from phase (p)'s ``cache``
    and seeded by its ``greedy`` walk.  Each engine is held generation by
    generation (the per-generation snapshots) to its host mirror;
    ``same_bits_twice`` (phase q) says whether the device pricer repeats
    its bits, which decides whether a resume is held bit for bit."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.core import resilience as R
    from repro_torch.core.device_search import generation_draws, island_draws
    from repro_torch.core.device_search import island_keys
    from repro_torch.core import prng
    from repro_torch.core.partitioner import SimEvaluator
    from repro_torch.core.search import evolutionary_search

    dev = cache.layers[0].csum_macs.device
    gens = search["generations"]

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def run(d=None, **kw):
        """One search on a fresh evaluator over the shared cache: the
        result, its wall seconds and the evaluator."""
        args = dict(search, engine="device", greedy=greedy,
                    checkpoint_every=1, checkpoint_keep=gens + 1)
        args.update(kw)
        ev = SimEvaluator(pnet, xs, chip, cache=cache)
        sync()
        t0 = time.perf_counter()
        res = evolutionary_search(
            pnet, chip, ev, checkpoint_dir=None if d is None else str(d),
            **args)
        sync()
        return res, time.perf_counter() - t0, ev

    snaps = snapshots

    def held(got, want, sg, sw, what: str, exact: bool = False) -> float:
        return held_to_mirror(got, want, sg, sw, what, gens, exact)

    def unscripted(res, engine: str, what: str) -> None:
        require(res.demotions == [] and res.telemetry["backend"] == engine,
                f"{what}: demotions {res.demotions}, backend "
                f"{res.telemetry['backend']}")

    def split(res, wall: float) -> dict:
        tel = res.telemetry
        n = len(res.history) - 1
        return {"wall_s": wall, "s_per_generation": wall / n,
                "stage_s": tel["stage_s"],
                "peel_iterations_per_generation": tel["peel_iterations"],
                "host_syncs_per_generation": tel["host_syncs"],
                "candidates_per_s": res.n_evals / wall,
                "best_time_per_step": res.history[-1].best_time}

    # ------------------------------------------- (r) the device engine
    t_phase = time.perf_counter()
    # the threefry on the card against the host, at the cell's shapes
    L, S = len(pnet.layers), int(chip.n_cores)
    prng_checked = 0
    for n_pop, n_isl in ((search["population_size"], 1),
                         (throughput["population_size"], 1),
                         (search["population_size"] // islands["n_islands"],
                          islands["n_islands"])):
        keys = island_keys(prng.PRNGKey(search["seed"]), 3, n_isl)
        kw = dict(n_off=n_pop, n_pop=n_pop, n_layers=L, n_slots=S,
                  tournament_k=3)
        a = island_draws(keys, device=dev, **kw)
        b = island_draws(keys, device="cpu", **kw)
        if n_isl == 1:
            c = generation_draws(keys[0], device="cpu", **kw)
            for k in b:
                exact(b[k], c[k], f"generation_draws {k}")
        for k in b:
            exact(a[k].cpu(), b[k], f"threefry on {dev} vs the CPU: {k}")
            prng_checked += a[k].numel()
    shutil.rmtree(ckpt_root / "r", ignore_errors=True)
    r_dev, wall_dev, ev_r = run(ckpt_root / "r" / "device")
    unscripted(r_dev, "device", "(r) device engine")
    require(ev_r.n_evals == r_dev.n_evals, "(r) evaluation ledger")
    r_mir, wall_mir, _ = run(ckpt_root / "r" / "mirror", reference=True)
    s_dev = snaps(ckpt_root / "r" / "device")
    r_err = held(r_dev, r_mir, s_dev, snaps(ckpt_root / "r" / "mirror"),
                 "(r) device engine vs its host mirror")
    require(r_dev.report.time_per_step <= greedy.report.time_per_step,
            "(r) device engine worse than the greedy walk")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    r_thr, wall_thr, _ = run(**throughput)
    unscripted(r_thr, "device", "(r) throughput search")
    peak = (torch.cuda.max_memory_allocated() if dev.type == "cuda"
            else None)
    emit({"phase": "device_search", "card": card,
          "cell": "profiled slice-1 (phase p's cache and greedy walk)",
          "search": search, "threefry_values_checked_vs_cpu": prng_checked,
          "device": split(r_dev, wall_dev),
          "mirror": {"wall_s": wall_mir, "s_per_generation":
                     wall_mir / gens},
          "numpy_engine_greedy_then_evolve_wall_s_phase_p": numpy_wall,
          "held_to_mirror": f"genomes, stages, hot layers identical in "
                            f"{gens + 1} snapshots; objectives rtol "
                            f"{SEARCH_RTOL}", "max_rel_diff": r_err,
          "demotions": "none", "backend": r_dev.telemetry["backend"],
          "throughput": dict(split(r_thr, wall_thr), search=throughput,
                             peak_device_bytes=peak,
                             n_evals=r_thr.n_evals),
          "phase_wall_s": time.perf_counter() - t_phase})

    # -------------------------------- (s) the sharded engine on one card
    t_phase = time.perf_counter()
    one, wall_one, _ = run(ckpt_root / "r" / "one_island", engine="sharded",
                           n_islands=1)
    unscripted(one, "sharded", "(s) one island")
    held(one, r_dev, snaps(ckpt_root / "r" / "one_island"), s_dev,
         "(s) one island vs the device engine", exact=True)
    four, wall_four, _ = run(ckpt_root / "r" / "islands", engine="sharded",
                             **islands)
    unscripted(four, "sharded", "(s) islands")
    four_m, wall_four_m, _ = run(ckpt_root / "r" / "islands_mirror",
                                 engine="sharded", reference=True, **islands)
    s_err = held(four, four_m, snaps(ckpt_root / "r" / "islands"),
                 snaps(ckpt_root / "r" / "islands_mirror"),
                 "(s) islands vs the host island mirror")
    emit({"phase": "sharded_search", "card": card,
          "one_island": {"bit_identical_to_device_engine": True,
                         "wall_s": wall_one},
          "islands": dict(split(four, wall_four), **islands,
                          local_pop=search["population_size"]
                          // islands["n_islands"],
                          migrations=gens // islands["migrate_every"]),
          "islands_mirror_wall_s": wall_four_m, "max_rel_diff": s_err,
          "phase_wall_s": time.perf_counter() - t_phase})

    # --------------------------------------------------- (t) resilience
    t_phase = time.perf_counter()
    dem, wall_dem, _ = run(ckpt_root / "r" / "demoted",
                           fault_plan=R.FaultPlan(fail={"device": 2}))
    require([(d.frm, d.to) for d in dem.demotions]
            == [("device", "numpy-mirror")]
            and dem.telemetry["backend"] == "numpy-mirror",
            f"(t) scripted demotion: {dem.demotions}")
    t_err = held(dem, r_dev, snaps(ckpt_root / "r" / "demoted"), s_dev,
                 "(t) demoted run vs the device engine")
    d = ckpt_root / "r" / "killed"
    crashed = False
    try:
        run(d, fault_plan=R.FaultPlan(kill_after_gen=KILL_AFTER))
    except R.SimulatedCrash:              # the scripted kill under test
        crashed = True
    require(crashed and R.SearchCheckpointer(str(d)).latest() == KILL_AFTER,
            "(t) the scripted kill")
    res, wall_res, _ = run(d, resume=True)
    unscripted(res, "device", "(t) resumed run")
    held(res, r_dev, snaps(d), s_dev, "(t) resumed run vs uninterrupted",
         exact=same_bits_twice)
    emit({"phase": "device_resilience", "card": card,
          "scripted_demotion": {"fault_plan": "fail={'device': 2}",
                                "demotions": [dataclasses.asdict(x)
                                              for x in dem.demotions],
                                "max_rel_diff_vs_device": t_err,
                                "wall_s": wall_dem},
          "resume": {"killed_after_generation": KILL_AFTER,
                     "held_to": "bit-identical" if same_bits_twice
                     else f"rtol {SEARCH_RTOL}", "resume_s": wall_res},
          "phase_wall_s": time.perf_counter() - t_phase})


def host_copy(tr, cfg):
    """A CPU trainer holding ``tr``'s data stream, weights, moments, masks
    and losses under ``cfg`` (a CPU ``SparseTrainer`` would first draw
    its own initial weights: seconds at full width)."""
    import copy

    import torch
    h = copy.copy(tr)
    h.cfg, h.device = cfg, torch.device("cpu")
    for name in ("params", "opt_m", "opt_v", "masks"):
        setattr(h, name, [x.cpu() for x in getattr(tr, name)])
    h.losses = list(tr.losses)
    return h


def init_bits(params, sizes, seed: int, layer: int) -> dict:
    """``mlp_init``'s draw of one layer on the host against ``params``
    (the trainer's initial weights): the number of values that differ and
    their largest ulp distance."""
    import numpy as np
    import torch
    from repro_torch.core import prng
    key = prng.PRNGKey(seed)
    for _ in range(layer + 1):
        k1, key = prng.split(key)
    w = prng.normal(k1, (sizes[layer], sizes[layer + 1]), device="cpu")
    w = w / torch.tensor(float(np.float32(np.sqrt(sizes[layer]))))
    a = params[layer].cpu().view(torch.int32).to(torch.int64)
    b = w.view(torch.int32).to(torch.int64)
    return {"layer": layer, "values": w.numel(),
            "differing": int((a != b).sum()),
            "max_ulp": int((a - b).abs().max())}


def training_phases(*, device, card: str, ckpt_root,
                    sizes=TRAIN_SIZES, train: dict = TRAIN,
                    kill: int = TRAIN_KILL, cpu_steps: int = CPU_STEPS,
                    probe_steps: int = PROBE_STEPS,
                    iso_search: dict = ISO_SEARCH,
                    denoise_sizes=DENOISE_SIZES,
                    denoise_steps: int = DENOISE_STEPS,
                    sd_steps: int = SD_STEPS, arch: str = ISO_ARCH) -> None:
    """Phases (u) to (w): sparsity-aware training on ``device``, the
    iso-accuracy loop over its trained networks, and sigma-delta
    calibration (see the module docstring).  On the card every kernel-mode
    run must launch its kernels; on the CPU (the tests' rehearsal at small
    widths) every wrapper runs its plain version and launches nothing.
    Checkpoints go under ``ckpt_root`` (scratch, emptied first)."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.core.partitioner import SimEvaluator
    from repro_torch.core.search import evolutionary_search
    from repro_torch.device import resolve_device
    from repro_torch.kernels.event_matmul.ops import event_matmul2
    from repro_torch.kernels.neuron_epilogue.ops import neuron_epilogue
    from repro_torch.kernels.sigma_delta.ops import window_cumsum
    from repro_torch.neuromorphic import (EventCompute, compile_network,
                                          loihi2_like, minimal_partition,
                                          simulate)
    from repro_torch.neuromorphic.compute import KERNEL_TILE
    from repro_torch.sparsity.pruning import _kept
    from repro_torch.train import SparseTrainConfig, SparseTrainer

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    counted = {"event_matmul2": event_matmul2, "window_cumsum": window_cumsum}
    chip = loihi2_like()
    shutil.rmtree(ckpt_root, ignore_errors=True)

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def kernel_run(net, xs, what: str, n_delta: int = 0):
        """One kernel-mode ``run_batch`` with the launch counts zeroed just
        before and read just after: a value and a counter launch per
        layer, a value-only one per delta layer, a ``window_cumsum`` per
        delta layer past the delta window (none on the CPU)."""
        for fn in counted.values():
            fn.launches = 0
        neuron_epilogue.launches = 0
        sync()
        t0 = time.perf_counter()
        run = net.run_batch(xs, compute=EventCompute(mode="kernel"))
        sync()
        wall = time.perf_counter() - t0
        got = {k: fn.launches for k, fn in counted.items()}
        L = len(net.layers)
        windowed = n_delta if xs.shape[0] > KERNEL_TILE else 0
        want = {"event_matmul2": 2 * L + windowed if on_card else 0,
                "window_cumsum": windowed if on_card else 0}
        require(got == want, f"{what}: launches {got} != {want}")
        # one neuron epilogue a layer
        require(neuron_epilogue.launches == (L if on_card else 0),
                f"{what}: {neuron_epilogue.launches} neuron_epilogue "
                f"launches for {L} layers")
        require(bool(torch.isfinite(run[0]).all()), f"{what}: non-finite")
        return run, got, wall

    def timed_train(tr, **kw):
        sync()
        t0 = time.perf_counter()
        n0 = tr.step
        tr.train(**kw)
        sync()
        return (time.perf_counter() - t0) / max(tr.step - n0, 1)

    # --------------------------------- (u) sparsity-aware training
    t_phase = time.perf_counter()
    base_cfg = SparseTrainConfig(sizes=tuple(sizes), steps=train["steps"],
                                 batch=train["batch"], seed=train["seed"])
    base = SparseTrainer(base_cfg, device=dev)
    # the CPU run starts from the card's initial weights; whether the card
    # drew the host's bits is checked on one layer (a host draw of all
    # 7.35 M takes seconds)
    host = host_copy(base, dataclasses.replace(base_cfg, steps=cpu_steps))
    init_check = init_bits(base.params, sizes, train["seed"],
                           layer=len(sizes) - 3)
    # why prng.normal takes its root in float64: float32 sqrt on the card
    # against the host's on 4 M values in [0.001, 30)
    x = torch.rand(1 << 22, generator=torch.Generator().manual_seed(0))
    x = x * 30 + 1e-3
    sqrt_diff = int((torch.sqrt(x.to(dev)).cpu() != torch.sqrt(x)).sum())
    require(init_check["differing"] == 0,
            f"(u) initial weights vs the host's draw: {init_check}")
    cores = minimal_partition(base.deploy(), chip).total_cores
    s_dense = timed_train(base)
    host.train()
    first = np.array(base.losses[:cpu_steps])
    cpu = np.array(host.losses)
    # the loss falls by orders of magnitude within 20 steps, so the
    # difference is measured against the first loss, not each loss
    loss_err = float(np.max(np.abs(first - cpu)) / abs(cpu[0]))
    require(np.isfinite(first).all() and loss_err <= TRAIN_LOSS_TOL,
            f"(u) first {cpu_steps} losses vs the CPU: {loss_err}")
    guide = base.floorline_weights(chip, probe_steps=probe_steps)
    require(guide.shape == (len(sizes) - 2,) and np.isfinite(guide).all()
            and (guide > 0).all(), f"(u) guidance weights {guide}")
    g_cfg = dataclasses.replace(base_cfg, lam=train["lam"], reg="tl1",
                                prune_sparsity=train["prune_sparsity"],
                                finetune_steps=train["finetune_steps"])
    guided = SparseTrainer(g_cfg, layer_weights=guide, device=dev)
    s_guided = timed_train(guided)
    for m in guided.masks:
        require(int(m.sum()) == _kept(m.numel(), g_cfg.prune_sparsity)
                and int(((m == 0) | (m == 1)).sum()) == m.numel(),
                f"(u) a mask keeps {int(m.sum())} of {m.numel()}")
    # kill at step ``kill``, resume in a fresh trainer: bit for bit
    k_cfg = dataclasses.replace(g_cfg, ckpt_dir=str(ckpt_root / "u"),
                                ckpt_every=kill, ckpt_keep=2)
    SparseTrainer(k_cfg, layer_weights=guide, device=dev).train(
        stop_after=kill)
    resumed = SparseTrainer(k_cfg, layer_weights=guide, device=dev)
    s_resume = timed_train(resumed, resume=True)
    require(resumed.step == guided.step and resumed.losses == guided.losses,
            "(u) resumed losses differ from the uninterrupted run")
    for name in ("params", "opt_m", "opt_v", "masks"):
        for a, b in zip(getattr(resumed, name), getattr(guided, name)):
            exact(a, b, f"(u) resumed {name}")
    # the device's idle share over 10 training steps
    tr10 = SparseTrainer(dataclasses.replace(g_cfg, steps=10,
                                             prune_sparsity=0.0,
                                             finetune_steps=0),
                         layer_weights=guide, device=dev)
    trace = traced(tr10.train) if on_card else "not measured (CPU)"
    runs = {"dense": base, f"tl1[{train['lam']}]+prune"
            f"{train['prune_sparsity']}": guided}
    metrics = {k: tr.eval_metrics() for k, tr in runs.items()}
    emit({"phase": "sparsity_training", "card": card,
          "task": "images", "sizes": list(sizes), "batch": train["batch"],
          "dense_cores": cores, "weights": sum(p.numel() for p in base.params),
          "steps": {"dense": base.step, "guided": guided.step},
          "guidance_weights": guide.tolist(),
          "s_per_step": {"dense": s_dense, "guided": s_guided,
                         "resumed": s_resume},
          "init_vs_host_draw": init_check,
          "sqrt_f32_values_differing_from_host": [sqrt_diff, x.numel()],
          "first_losses_vs_cpu": {"steps": cpu_steps,
                                  "max_diff_over_first_loss": loss_err,
                                  "tol": TRAIN_LOSS_TOL,
                                  "card": first.tolist(),
                                  "cpu": cpu.tolist()},
          "kill_and_resume": {"killed_at": kill, "bit_identical": True},
          "masks_kept": [int(m.sum()) for m in guided.masks],
          "traced_10_steps": trace, "metrics": metrics,
          "phase_wall_s": time.perf_counter() - t_phase})

    # --------------------------------------- (v) the iso-accuracy loop
    t_phase = time.perf_counter()
    xs = base._probe_xs(probe_steps)
    gens = iso_search["generations"]
    rows, profiles, launches = [], {}, {}
    for i, (name, tr) in enumerate(runs.items()):
        profile = tr.extract_profile(meta={"config": name})
        profiles[name] = profile
        net = tr.deploy()
        run, launches[name], run_s = kernel_run(net, xs, f"(v) {name}")
        dense = net.run_batch(xs, compute="dense")
        for layer, a, b in zip(net.layers, run[1], dense[1]):
            for f in FIELDS:
                exact(getattr(a, f), getattr(b, f),
                      f"(v) {name} {layer.name} {f}")
        d = {w: ckpt_root / f"v{i}_{w}" for w in ("device", "mirror")}
        ev = SimEvaluator(net, xs, chip, compute=EventCompute(mode="kernel"))
        res, wall = {}, {}
        for w in d:
            sync()
            t0 = time.perf_counter()
            res[w] = evolutionary_search(
                net, chip, SimEvaluator(net, xs, chip, cache=ev.cache),
                engine="device", reference=w == "mirror",
                checkpoint_dir=str(d[w]), checkpoint_every=1,
                checkpoint_keep=gens + 1, **iso_search)
            sync()
            wall[w] = time.perf_counter() - t0
        require(res["device"].demotions == []
                and res["device"].telemetry["backend"] == "device",
                f"(v) {name}: demotions {res['device'].demotions}")
        err = held_to_mirror(res["device"], res["mirror"],
                             snapshots(d["device"]), snapshots(d["mirror"]),
                             f"(v) {name}: device engine vs its mirror",
                             gens)
        knee = res["device"].knee()
        rep = knee[1] if knee is not None else res["device"].report
        rows.append({"config": name, "baseline": name == "dense",
                     "acc": metrics[name]["acc"],
                     "act_density": metrics[name]["act_density"],
                     "weight_density": float(np.mean(profile.weight_density)),
                     "time": float(rep.time_per_step),
                     "energy": float(rep.energy_per_step),
                     "n_evals": int(res["device"].n_evals),
                     "profile_act_density": profile.act_density.tolist(),
                     "kernel_run_batch_s": run_s,
                     "search_wall_s": wall,
                     "max_rel_diff_vs_mirror": err})
    base_row = rows[0]
    ok = [r for r in rows if not r["baseline"]
          and r["acc"] >= base_row["acc"] - ACC_TOL]
    best = min(ok, key=lambda r: r["time"]) if ok else None
    winner = profiles[(best or base_row)["config"]]
    mean_d = float(np.mean(winner.act_density))
    comp = {k: compile_network(arch, seq_len=16, act_density=a, seed=1,
                               device=dev)
            for k, a in (("synthetic", mean_d), ("trained", winner))}
    xs2 = comp["synthetic"].inputs(probe_steps, seed=2)
    t_inj = {k: float(simulate(c.net, xs2, chip).time_per_step)
             for k, c in comp.items()}
    emit({"phase": "iso_accuracy", "card": card,
          "probe": {"steps": probe_steps, "step": 10_999},
          "search": dict(iso_search, engine="device"),
          "launches_per_run_batch": launches,
          "counters": "bit-identical to dense",
          "search_held_to_mirror": f"genomes, stages, hot layers identical "
                                   f"in {gens + 1} snapshots; objectives "
                                   f"rtol {SEARCH_RTOL}",
          "rows": rows, "acc_tol": ACC_TOL,
          "iso_ok": bool(best is not None
                         and best["time"] < base_row["time"]),
          "iso_speedup": (None if best is None
                          else base_row["time"] / best["time"]),
          "iso_energy_gain": (None if best is None
                              else base_row["energy"] / best["energy"]),
          "best_config": None if best is None else best["config"],
          "profile_injection": {
              "arch": arch, "mean_density": mean_d,
              "synthetic_time": t_inj["synthetic"],
              "trained_profile_time": t_inj["trained"],
              "time_ratio": t_inj["trained"] / t_inj["synthetic"]},
          "phase_wall_s": time.perf_counter() - t_phase})

    # ---------------------------------- (w) sigma-delta calibration
    t_phase = time.perf_counter()
    d_cfg = SparseTrainConfig(sizes=tuple(denoise_sizes), task="denoise",
                              steps=denoise_steps, batch=train["batch"],
                              seed=train["seed"])
    dn = SparseTrainer(d_cfg, device=dev)
    s_dn = timed_train(dn)
    t0 = time.perf_counter()
    prof_w, net_w = dn.calibrate_sigma_delta(SD_TARGET)
    calib_s = time.perf_counter() - t0
    prof_c, _ = host_copy(dn, d_cfg).calibrate_sigma_delta(SD_TARGET)
    th, th_c = np.array(prof_w.thresholds), np.array(prof_c.thresholds)
    th_err = float(np.max(np.abs(th - th_c) / th_c))
    require(np.allclose(th, th_c, rtol=1e-6, atol=0.0),
            f"(w) thresholds vs the CPU calibration: {th_err}")
    # held-out rows: consecutive sequences from step 11,000 on, past the
    # delta window
    seqs, t = [], 11_000
    while sum(len(s) for s in seqs) < sd_steps:
        seqs.append(dn.data.batch(t)["noisy"].reshape(-1, denoise_sizes[0]))
        t += 1
    xs_w = np.concatenate(seqs)
    n_delta = len(net_w.layers) - 1
    run_w, launches_w, run_w_s = kernel_run(net_w, xs_w, "(w) sd_relu",
                                            n_delta=n_delta)
    parity_w = glue_parity(net_w, xs_w, EventCompute(mode="kernel"), run_w,
                           "(w) sd_relu")
    dense_w = net_w.run_batch(xs_w, compute="dense")
    same = all(torch.equal(getattr(a, f), getattr(b, f))
               for a, b in zip(run_w[1], dense_w[1]) for f in FIELDS)
    worst = 0.0
    for layer, a, b in zip(net_w.layers, run_w[1], dense_w[1]):
        for f in FIELDS:
            u = float(getattr(a, f).to(torch.float64).sum())
            v = float(getattr(b, f).to(torch.float64).sum())
            worst = max(worst, abs(u - v) / max(abs(v), 1.0))
    require(same or worst <= REPORT_RTOL,
            f"(w) counters vs dense: {worst} beyond {REPORT_RTOL}")
    T_w = xs_w.shape[0]
    emit({"phase": "sigma_delta_training", "card": card, "task": "denoise",
          "sizes": list(denoise_sizes),
          "dense_cores": minimal_partition(dn.deploy(), chip).total_cores,
          "steps": dn.step, "s_per_step": s_dn,
          "target_density": SD_TARGET, "thresholds": list(th),
          "thresholds_vs_cpu_max_rel_diff": th_err, "calibrate_s": calib_s,
          "held_out_rows": T_w, "first_step": 11_000,
          "launches": launches_w, "run_batch_s": run_w_s,
          "neuron_epilogue": {"launches": len(net_w.layers) if on_card
                              else 0, "against_the_eager_glue":
                              "bit-identical", **parity_w},
          "counters": ("bit-identical to dense" if same else
                       f"within rtol {REPORT_RTOL} of dense (quantiser "
                       f"ties): max rel diff of a layer total {worst}"),
          "message_density_measured": [
              float(c.msgs_out.to(torch.float64).sum()) / (T_w * l.n_neurons)
              for l, c in zip(net_w.layers, run_w[1])],
          "message_density_profile": prof_w.act_density.tolist(),
          "phase_wall_s": time.perf_counter() - t_phase})


def engine_logits(eng, prompts, tokens):
    """The engine's logits at each of its steps, fed ``tokens`` (B, n):
    its prefill's, then each ``decode_step``'s -> (n, B, V)."""
    import torch
    from repro_torch.models import lm
    dev = eng.device
    B, n = len(prompts), len(tokens[0])
    S = len(prompts[0])
    logits, cache = eng.prefill(torch.tensor(prompts, device=dev), S + n)
    steps = [logits]
    fed = torch.tensor(tokens, device=dev)
    for i in range(1, n):
        logits, cache = lm.decode_step(eng.model, fed[:, i - 1:i], cache,
                                       S + i - 1)
        steps.append(logits)
    return torch.stack(steps)


def serve_phases(*, device, card: str, full: bool = True,
                 serve_args: dict = SERVE,
                 trace_steps: int = SERVE_TRACE_STEPS,
                 check_prompts=CHECK_PROMPTS,
                 family_steps: int = FAMILY_STEPS,
                 whisper_steps: int = WHISPER_STEPS) -> dict:
    """Phases (x) to (z): the model and serving stack (see the module
    docstring).  ``full=False`` (the tests' rehearsal on the CPU) serves
    the smoke configs in place of full-width gemma2-2b and whisper-base,
    and traces nothing.  Returns phase (x)'s greedy tokens and decode ms
    a token (phase J serves the same cell)."""
    import copy
    import dataclasses
    import math

    import numpy as np
    import torch
    from repro_torch.configs import registry
    from repro_torch.core.hlo_cost import ported_kernels
    from repro_torch.device import resolve_device
    from repro_torch.launch import serve
    from repro_torch.models import encdec, lm
    from repro_torch.serve.engine import Engine, ServeConfig

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    counted = ported_kernels()

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def in_vocab(out, n, vocab, what):
        require(all(len(o) == n and all(0 <= t < vocab for t in o)
                    for o in out), f"{what}: tokens outside [0, {vocab})")

    # ------------------------------------------------------- (x) serve
    t_phase = time.perf_counter()
    B, P, N = (serve_args[k] for k in ("batch", "prompt_len", "new_tokens"))
    for fn in counted.values():
        fn.launches = 0
    # earlier phases' live tensors, counted in the peak below
    held_before = (torch.cuda.memory_allocated() if on_card
                   else "not measured")
    t0 = time.perf_counter()
    cfg, eng, prompts = serve.build(serve.parse_args(
        ["--arch", SERVE_ARCH, "--batch", str(B), "--prompt-len", str(P),
         "--new-tokens", str(N), "--device", device]
        + ([] if full else ["--smoke"])))
    sync()
    init_s = time.perf_counter() - t0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    first = eng.generate(prompts)         # warm: cuBLAS handles, heuristics
    first_s = {"prefill_s": eng.timings["prefill_s"],
               "decode_s": sum(eng.timings["step_s"])}
    t0 = time.perf_counter()
    out = eng.generate(prompts)
    wall = time.perf_counter() - t0
    prefill_s = eng.timings["prefill_s"]
    steps_ms = [s * 1e3 for s in eng.timings["step_s"]]
    in_vocab(out, N, cfg.vocab_size, "(x) greedy")
    param_bytes = sum(p.numel() * p.element_size()
                      for p in eng.model.parameters())
    bound_ms = param_bytes / PEAK_BYTES_PER_S * 1e3
    decode_ms = statistics.median(steps_ms[1:])

    # trace_steps decode steps from a fresh prefill, under the profiler
    logits, cache = eng.prefill(torch.tensor(prompts, device=dev),
                                P + trace_steps)
    cur = logits.argmax(-1)

    def decode_steps():
        nonlocal cur, cache
        for t in range(trace_steps):
            lg, cache = lm.decode_step(eng.model, cur[:, None], cache, P + t)
            cur = lg.argmax(-1)
    if on_card:
        trace = traced(decode_steps)
        trace["device_ops_per_step"] = trace["device_ops"] / trace_steps
    else:
        decode_steps()
        trace = "not measured (CPU)"
    del cache, logits, cur

    eng.scfg = ServeConfig(max_new_tokens=N, **SERVE_SAMPLE)
    sampled = eng.generate(prompts)
    in_vocab(sampled, N, cfg.vocab_size, "(x) sampled")
    require(eng.generate(prompts) == sampled,
            "(x) temperature sampling differs between two runs")
    launches = {k: fn.launches for k, fn in counted.items()}
    require(not any(launches.values()),
            f"(x) the serving path launched a ported kernel: {launches}")
    # CUDA divides by a Python scalar as a product with its reciprocal;
    # the layers scale scores by XLA's float32 reciprocal explicitly
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(1 << 20, generator=gen, device=dev) * 30
    division = {f"{c:.6g}": int((x / c != x / torch.full((), c, device=dev))
                                .sum())
                for c in (math.sqrt(8), math.sqrt(12), 16.0, 30.0, 50.0)}
    peak = torch.cuda.max_memory_allocated() if on_card else "not measured"
    emit({"phase": "serve", "card": card, "arch": cfg.name,
          "dtype": cfg.param_dtype, "batch": B, "prompt_len": P,
          "new_tokens": N, "params": sum(p.numel()
                                        for p in eng.model.parameters()),
          "param_bytes": param_bytes, "init_s": init_s,
          "first_generate": first_s,
          "greedy_repeats": out == first, "prefill_s": prefill_s,
          "decode_ms_per_token": decode_ms, "decode_ms_steps": steps_ms,
          "weight_streaming_bound_ms": bound_ms,
          "decode_over_bound": decode_ms / bound_ms,
          "tokens_per_s": B * N / wall, "generate_wall_s": wall,
          "peak_device_bytes": peak,
          "device_bytes_held_before": held_before,
          "traced_decode": trace, "traced_steps": trace_steps,
          "sampled": {**SERVE_SAMPLE, "identical_twice": True,
                      "row0": sampled[0]},
          "greedy_row0": out[0], "ported_kernel_launches": launches,
          "scalar_vs_true_division_differing_of_2e20": division,
          "phase_wall_s": time.perf_counter() - t_phase})
    serve_x = {"tokens": out, "decode_ms": decode_ms}
    del eng
    if on_card:
        torch.cuda.empty_cache()

    # ------------------------------- (y) serve_check, full width float32
    t_phase = time.perf_counter()
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    eng = Engine(cfg32, lm.init_params(cfg32, 0, device), ServeConfig(),
                 device=device)
    window = max(b.window or 0 for b in cfg32.all_blocks())
    rng = np.random.default_rng(0)
    rows = []
    for P, n in check_prompts:
        t0 = time.perf_counter()
        prompt = rng.integers(1, cfg32.vocab_size, size=P).tolist()
        got = eng.generate([prompt], n)[0]
        gen_s = time.perf_counter() - t0
        in_vocab([got], n, cfg32.vocab_size, f"(y) prompt {P}")
        steps = engine_logits(eng, [prompt], [got])[:, 0]        # (n, V)
        # teacher forcing: one causal forward over the prompt and the
        # first n - 1 tokens gives the logits of every growing prefix
        h, _ = lm.forward(eng.model, torch.tensor([prompt + got[:-1]],
                                                  device=dev))
        forced = lm.logits_from_h(eng.model, h[:, P - 1:])[0]    # (n, V)
        del h
        diff = (steps - forced).abs().amax(-1)
        top2 = forced.topk(2, dim=-1).values
        margin = (top2[:, 0] - top2[:, 1]).tolist()
        forced_tokens = forced.argmax(-1).tolist()
        rows.append({
            "prompt_len": P, "new_tokens": n,
            "crosses_window": P < window < P + n,
            "chunked_prefill": P > 4096 and P % 1024 == 0,
            "tokens_equal_teacher_forcing": got == forced_tokens,
            "max_abs_logit_diff": float(diff.max()),
            "per_step_max_abs_diff": diff.tolist(),
            "min_argmax_margin": min(margin),
            "margins_below_tol": {i: m for i, m in enumerate(margin)
                                  if m < SERVE_LOGIT_ATOL},
            "generate_s": gen_s, "prefill_s": eng.timings["prefill_s"],
            "tokens": got})
        require(got == forced_tokens,
                f"(y) prompt {P}: engine {got} != teacher forcing "
                f"{forced_tokens} (margins {margin})")
        require(float(diff.max()) <= SERVE_LOGIT_ATOL,
                f"(y) prompt {P}: decode logits {float(diff.max())} from "
                f"the forward's, beyond {SERVE_LOGIT_ATOL}")
        del steps, forced
    emit({"phase": "serve_check", "card": card, "arch": cfg32.name,
          "dtype": "float32", "window": window, "tol": SERVE_LOGIT_ATOL,
          "prompts": rows, "phase_wall_s": time.perf_counter() - t_phase})
    del eng
    if on_card:
        torch.cuda.empty_cache()

    # ------------------------ (z) serve_families, card against host
    t_phase = time.perf_counter()
    fams = {}

    def held(card_t, host_t, what):
        err = float((card_t.cpu() - host_t).abs().max())
        require(torch.allclose(card_t.cpu(), host_t, rtol=FAMILY_RTOL,
                               atol=FAMILY_ATOL),
                f"(z) {what}: card vs host {err} beyond rtol "
                f"{FAMILY_RTOL} atol {FAMILY_ATOL}")
        return err

    for arch in registry.ARCH_IDS:
        entry = registry.get(arch)
        if entry.is_encdec:
            continue
        scfg = entry.smoke()
        host = lm.init_params(scfg, 0, "cpu")
        engines = {"host": Engine(scfg, host, ServeConfig(
            max_new_tokens=family_steps), device="cpu")}
        engines["card"] = Engine(scfg, copy.deepcopy(host),
                                 engines["host"].scfg, device=device)
        prompts = np.random.default_rng(5).integers(
            1, scfg.vocab_size, (2, 12)).tolist()
        toks = {k: e.generate(prompts) for k, e in engines.items()}
        require(toks["card"] == toks["host"],
                f"(z) {arch}: greedy tokens differ, card {toks['card']} "
                f"host {toks['host']}")
        lg = {k: engine_logits(e, prompts, toks["host"])
              for k, e in engines.items()}
        fams[arch] = {
            "tokens_equal": True,
            "prefill_max_abs_diff": held(lg["card"][0], lg["host"][0],
                                         f"{arch} prefill"),
            "decode_max_abs_diff": held(lg["card"][1:], lg["host"][1:],
                                        f"{arch} decode")}

    wcfg = registry.get("whisper-base").smoke()
    host = encdec.init_params(wcfg, 0, "cpu")
    models = {"host": host, "card": copy.deepcopy(host).to(dev)}
    frames = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (2, wcfg.n_frames, wcfg.d_model)).astype(np.float32))
    greedy = {}
    for k, m in models.items():
        where = m.embed.device
        cache = encdec.precompute_cross_cache(
            m, encdec.encode(m, frames.to(where)),
            encdec.init_cache(wcfg, 2, family_steps, where))
        tok = torch.tensor([[1], [2]], device=where)
        toks, logs = [], []
        for t in range(family_steps):
            lgt, cache = encdec.decode_step(m, tok, cache, t)
            tok = lgt.argmax(-1, keepdim=True)
            toks.append(tok[:, 0].tolist())
            logs.append(lgt)
        greedy[k] = (toks, torch.stack(logs))
    require(greedy["card"][0] == greedy["host"][0],
            "(z) whisper smoke: greedy tokens differ")
    fams["whisper-base (smoke)"] = {
        "tokens_equal": True,
        "decode_max_abs_diff": held(greedy["card"][1], greedy["host"][1],
                                    "whisper decode")}

    # whisper-base at full width: decode_step against decode_train
    wcfg = registry.get("whisper-base").config if full else wcfg
    wcfg = dataclasses.replace(wcfg, param_dtype="float32",
                               compute_dtype="float32")
    wm = encdec.init_params(wcfg, 0, device)
    wrng = np.random.default_rng(7)
    frames = torch.from_numpy(wrng.standard_normal(
        (1, wcfg.n_frames, wcfg.d_model)).astype(np.float32)).to(dev)
    wtoks = torch.from_numpy(wrng.integers(
        0, wcfg.vocab_size, (1, whisper_steps))).to(dev)
    t0 = time.perf_counter()
    enc = encdec.encode(wm, frames)
    train = encdec.logits_from_h(wm, encdec.decode_train(wm, enc, wtoks))[0]
    cache = encdec.precompute_cross_cache(
        wm, enc, encdec.init_cache(wcfg, 1, whisper_steps, device))
    steps = []
    for t in range(whisper_steps):
        lgt, cache = encdec.decode_step(wm, wtoks[:, t:t + 1], cache, t)
        steps.append(lgt[0])
    sync()
    w_s = time.perf_counter() - t0
    w_err = float((torch.stack(steps) - train).abs().max())
    require(w_err <= SERVE_LOGIT_ATOL,
            f"(z) whisper decode_step vs decode_train: {w_err}")
    emit({"phase": "serve_families", "card": card,
          "smoke_configs": fams, "tol": [FAMILY_RTOL, FAMILY_ATOL],
          "whisper": {"config": wcfg.name, "frames": wcfg.n_frames,
                      "decode_steps": whisper_steps,
                      "max_abs_logit_diff_vs_decode_train": w_err,
                      "tol": SERVE_LOGIT_ATOL, "wall_s": w_s},
          "phase_wall_s": time.perf_counter() - t_phase})
    return serve_x


def lm_step_bound(cfg, B: int, S: int) -> dict:
    """The least time of one AdamW training step of a dense attention LM
    (every block attention plus a dense MLP) on ``B`` sequences of ``S``
    tokens: its GEMM operations at the bf16 tensor-core rate plus the
    optimizer's bytes at the HBM rate.  GEMMs: the forward's block
    weights, the causal QK^T and PV products (window-limited) and the
    tied logits, counted four times for blocks recomputed in the backward
    (forward, recompute, two backward products) and three times for the
    logits.  AdamW reads each gradient and writes each parameter in the
    parameters' dtype, and reads and writes float32 m, v and master."""
    d, V, T = cfg.d_model, cfg.vocab_size, B * S
    w_blocks = attn = 0
    for blk in cfg.all_blocks():
        require(blk.kind == "attn" and blk.moe is None,
                f"lm_step_bound: {blk.kind} block")
        w_blocks += (d * (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim
                     + cfg.q_dim * d + 3 * d * blk.d_ff)
        W = blk.window or S
        pairs = sum(min(q + 1, W) for q in range(S))
        attn += 2 * 2 * cfg.n_heads * cfg.head_dim * pairs * B
    passes = 4 if cfg.remat == "block" else 3
    flops = passes * (2 * T * w_blocks + attn) + 3 * 2 * T * d * V
    psize = 2 if cfg.param_dtype == "bfloat16" else 4
    opt_bytes = cfg.param_count() * (2 * psize + 24)
    return {"gemm_flop": flops, "optimizer_bytes": opt_bytes,
            "gemm_ms": flops / PEAK_BF16_FLOPS * 1e3,
            "optimizer_ms": opt_bytes / PEAK_BYTES_PER_S * 1e3,
            "bound_ms": (flops / PEAK_BF16_FLOPS
                         + opt_bytes / PEAK_BYTES_PER_S) * 1e3}


def lm_train_phases(*, device, card: str, ckpt_root, full: bool = True,
                    train: dict = LM_TRAIN,
                    trace_steps: int = LM_TRACE_STEPS,
                    grad_check: dict = GRAD_CHECK,
                    resume: dict = RESUME) -> None:
    """Phases (A) to (D): training of the LM stack (see the module
    docstring).  ``full=False`` (the tests' rehearsal on the CPU) trains
    gemma2-2b's smoke config in place of the full one, checks the
    gradient there, traces nothing, and holds the host against itself in
    (C).  Checkpoints go under ``ckpt_root`` (scratch, emptied first)."""
    import dataclasses
    import gc
    import math

    import numpy as np
    import torch
    from repro_torch.configs import registry
    from repro_torch.core.hlo_cost import ported_kernels
    from repro_torch.device import resolve_device
    from repro_torch.distributed import collectives
    from repro_torch.launch import train as launcher
    from repro_torch.models import encdec, lm
    from repro_torch.train import data as data_lib
    from repro_torch.train import optim, schedules
    from repro_torch.train import step as step_lib
    from repro_torch.train.loop import (Trainer, TrainerConfig,
                                        make_dp_compressed_step)
    from repro_torch.tree import tree_map

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    counted = ported_kernels()
    for fn in counted.values():
        fn.launches = 0
    shutil.rmtree(ckpt_root, ignore_errors=True)

    def free():
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()

    def paths(tree, prefix=""):
        for k in sorted(tree):
            v = tree[k]
            if isinstance(v, dict):
                yield from paths(v, f"{prefix}{k}.")
            else:
                yield prefix + k, v

    # ------------------------------------------------------ (A) lm_train
    t_phase = time.perf_counter()
    B, S, steps, lr = (train[k] for k in ("batch", "seq", "steps", "lr"))
    held_before = (torch.cuda.memory_allocated() if on_card
                   else "not measured")
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = launcher.build(launcher.parse_args(
        ["--arch", LM_ARCH, "--steps", str(steps), "--batch", str(B),
         "--seq", str(S), "--lr", str(lr), "--device", device]
        + ([] if full else ["--smoke"])))
    trainer.tcfg.log_every = 1
    init_s = time.perf_counter() - t0
    cfg = trainer.cfg
    hist = trainer.run()
    losses = [h["loss"] for h in hist]
    step_s = statistics.median(h["dt"] for h in hist[1:])
    require(len(losses) == steps and all(map(math.isfinite, losses)),
            f"(A) losses {losses}")
    require(losses[-1] < losses[0], f"(A) loss did not fall: {losses}")
    batch = trainer._put_batch(trainer.data.batch(steps))

    def more_steps():
        for _ in range(trace_steps):
            trainer.state, _ = trainer.step_fn(trainer.state, batch)
    if on_card:
        trace = traced(more_steps)
        trace["device_ops_per_step"] = trace["device_ops"] / trace_steps
    else:
        more_steps()
        trace = "not measured (CPU)"
    peak = torch.cuda.max_memory_allocated() if on_card else "not measured"
    n_params = cfg.param_count()
    tokens = B * S
    bound = lm_step_bound(cfg, B, S)
    launches = {k: fn.launches for k, fn in counted.items()}
    emit({"phase": "lm_train", "card": card, "arch": cfg.name,
          "dtype": cfg.param_dtype, "optimizer": trainer.opt.name,
          "schedule": f"cosine(lr={lr}, warmup={max(steps // 20, 1)}, "
                      f"total={steps})",
          "batch": B, "seq_len": S, "steps": steps, "params": n_params,
          "init_s": init_s, "loss_curve": losses,
          "step_s": [h["dt"] for h in hist], "s_per_step": step_s,
          "tokens_per_s": tokens / step_s,
          "mfu": 6 * n_params * tokens / step_s / PEAK_BF16_FLOPS,
          "step_bound": bound, "step_over_bound":
              step_s * 1e3 / bound["bound_ms"],
          "peak_device_bytes": peak, "device_bytes_held_before": held_before,
          "traced_steps": trace_steps, "traced": trace,
          "straggler_events": len(trainer.monitor.events),
          "ported_kernel_launches": launches,
          "phase_wall_s": time.perf_counter() - t_phase})
    require(not any(launches.values()),
            f"(A) the training path launched a ported kernel: {launches}")
    del trainer, batch, more_steps
    free()

    # -------------------------------------------------- (B) lm_grad_check
    t_phase = time.perf_counter()
    entry = registry.get(LM_ARCH)
    cfg32 = dataclasses.replace(entry.config if full else entry.smoke(),
                                param_dtype="float32",
                                compute_dtype="float32")
    model = lm.init_params(cfg32, 0, device)
    data = data_lib.SyntheticLM(data_lib.LMTaskConfig(
        vocab_size=cfg32.vocab_size, seq_len=grad_check["seq"],
        global_batch=grad_check["batch"], seed=grad_check["seed"]))
    gbatch = {k: torch.from_numpy(v).to(dev)
              for k, v in data.batch(0).items()}
    t0 = time.perf_counter()
    total, _, grads = step_lib.value_and_grad(model, gbatch)
    grad_s = time.perf_counter() - t0
    params = step_lib.param_tree(model)
    gen = torch.Generator(device=dev).manual_seed(grad_check["seed"])
    direction = tree_map(lambda p: torch.randn(
        p.shape, generator=gen, device=dev) * grad_check["scale"], params)
    saved = tree_map(lambda p: p.detach().clone(), params)
    groups = {"all": lambda k: True,
              "embed": lambda k: k == "embed",
              "attention": lambda k: ".attn." in k,
              "mlp": lambda k: ".mlp." in k,
              "norms": lambda k: "norm" in k}

    def loss_at(eps, pick):
        with torch.no_grad():
            for (k, p), (_, p0), (_, d) in zip(paths(params), paths(saved),
                                                paths(direction)):
                p.copy_(p0 + eps * d if pick(k) else p0)
            return float(lm.loss_fn(model, gbatch)[0])

    checks = {}
    for name, pick in groups.items():
        dot = sum(float((g.double() * d.double()).sum())
                  for (k, g), (_, d) in zip(paths(grads), paths(direction))
                  if pick(k))
        eps = grad_check["loss_change"] / max(abs(dot), 1e-30)
        steps = [eps / 2 ** k for k in range(grad_check["halvings"] + 1)]
        central = [(loss_at(h, pick) - loss_at(-h, pick)) / (2 * h)
                   for h in steps]
        # Richardson: each pair's h^2 term cancels; Ridders: take the
        # estimate closest to its neighbour at the larger step
        rich = [(4 * b - a) / 3 for a, b in zip(central, central[1:])]
        k = min(range(1, len(rich)),
                key=lambda i: abs(rich[i] - rich[i - 1]))
        fd = rich[k]
        rel = abs(fd - dot) / max(abs(dot), 1e-30)
        checks[name] = {"directional_derivative": dot,
                        "central_difference": fd, "eps": eps,
                        "step": steps[k], "steps": steps,
                        "central": central, "richardson": rich,
                        "rel_err": rel}
        require(rel <= GRAD_CHECK_RTOL,
                f"(B) {name}: <g, d> {dot} vs central difference {fd} "
                f"(eps {eps}): rel err {rel} beyond {GRAD_CHECK_RTOL}")
    loss_at(0.0, groups["all"])                   # the weights back
    emit({"phase": "lm_grad_check", "card": card, "arch": cfg32.name,
          "dtype": "float32", "batch": grad_check["batch"],
          "seq_len": grad_check["seq"], "loss": float(total),
          "value_and_grad_s": grad_s, "direction_std": grad_check["scale"],
          "loss_change_at_eps": grad_check["loss_change"],
          "tol": GRAD_CHECK_RTOL, "checks": checks,
          "phase_wall_s": time.perf_counter() - t_phase})
    del model, params, grads, direction, saved, gbatch
    free()

    # --------------------------------------------- (C) lm_train_families
    t_phase = time.perf_counter()
    fams = {}

    def host(t):
        return t.detach().float().cpu()

    def trees_close(got, want, rtol, atol_of, what):
        worst = 0.0
        w = dict(paths(want))
        for k, g in paths(got):
            a, b = host(g), host(w[k])
            atol = atol_of(b)
            err = float((a - b).abs().max())
            require(torch.allclose(a, b, rtol=rtol, atol=atol),
                    f"(C) {what} {k}: card vs host {err} beyond rtol {rtol} "
                    f"atol {atol}")
            worst = max(worst, err)
        return worst

    def pair(scfg, lib):
        hm = lib.init_params(scfg, 0, "cpu")
        cm = lib.params_from_numpy(scfg, lib.params_to_numpy(hm), device)
        return hm, cm

    for arch in registry.ARCH_IDS:
        entry = registry.get(arch)
        scfg = entry.smoke()
        lib = encdec if entry.is_encdec else lm
        rng = np.random.default_rng(12)
        F = (0 if entry.is_encdec or scfg.frontend == "none"
             else scfg.frontend_tokens)
        nb = {}
        if entry.is_encdec or F:
            nb["frontend_embeds"] = rng.standard_normal(
                (2, scfg.n_frames if entry.is_encdec else F,
                 scfg.d_model)).astype(np.float32)
        nb["tokens"] = rng.integers(0, scfg.vocab_size, (2, 16 - F)).astype(
            np.int32)
        nb["labels"] = rng.integers(0, scfg.vocab_size, (2, 16)).astype(
            np.int32)
        hm, cm = pair(scfg, lib)
        out = {}
        for where, m in (("host", hm), ("card", cm)):
            d = m.embed.device
            out[where] = step_lib.value_and_grad(
                m, {k: torch.from_numpy(v).to(d) for k, v in nb.items()})
        (ht, hmet, hg), (ct, cmet, cg) = out["host"], out["card"]
        loss_err = abs(float(ct) - float(ht))
        require(loss_err <= LM_LOSS_RTOL * abs(float(ht)),
                f"(C) {arch}: loss card {float(ct)} host {float(ht)}")
        for k in hmet:
            require(abs(float(cmet[k]) - float(hmet[k]))
                    <= LM_LOSS_RTOL * abs(float(hmet[k])) + 1e-6,
                    f"(C) {arch}: metric {k}")
        row = {"loss": float(ht), "loss_abs_diff": loss_err,
               "grad_max_abs_diff": trees_close(
                   cg, hg, 0, lambda b: LM_GRAD_ATOL * float(b.abs().max()),
                   f"{arch} grad")}
        # both optimizers from the same weights on the host's gradients
        for name, make in (("adamw", lambda: optim.adamw(
                schedules.constant(1e-3))), ("adafactor", lambda: optim.
                adafactor(schedules.constant(1e-3), min_dim_factored=32))):
            upd = {}
            for where, m in (("host", hm), ("card", cm)):
                d = m.embed.device
                p = tree_map(lambda t: t.detach().clone(),
                             step_lib.param_tree(m))
                opt = make()
                upd[where], _ = opt.update(
                    tree_map(lambda g: g.to(d), hg), opt.init(p), p,
                    torch.zeros((), dtype=torch.int32, device=d))
            row[f"{name}_params_max_abs_diff"] = trees_close(
                upd["card"], upd["host"], OPT_RTOL, lambda b: OPT_ATOL,
                f"{arch} {name} step")
        fams[arch] = row

    # granite: two microbatches, and the compressed step twice
    gcfg = registry.get("granite-3-2b").smoke()
    lr = 1e-3
    nb = data_lib.SyntheticLM(data_lib.LMTaskConfig(
        vocab_size=gcfg.vocab_size, seq_len=16, global_batch=4, seed=3))
    gtree = lm.params_to_numpy(lm.init_params(gcfg, 0, "cpu"))
    runs = {}
    for where, d in (("host", torch.device("cpu")), ("card", dev)):
        def batch(i):
            return {k: torch.from_numpy(v).to(d)
                    for k, v in nb.batch(i).items()}
        m = lm.params_from_numpy(gcfg, gtree, d)
        opt = optim.adamw(schedules.constant(lr))
        st = step_lib.make_train_step(m, opt, num_microbatches=2)(
            step_lib.init_state(m, opt), batch(0))
        mb2 = (float(st[1]["loss"]), tree_map(host, st[0]["params"]))
        m = lm.params_from_numpy(gcfg, gtree, d)
        opt = optim.adamw(schedules.constant(lr))
        st = step_lib.init_state(m, opt)
        st["err"] = collectives.init_error_feedback(st["params"])
        fn = make_dp_compressed_step(m, opt)
        for i in range(2):
            st, met = fn(st, batch(1 + i))
        runs[where] = (mb2, (float(met["loss"]),
                             tree_map(host, st["params"]),
                             tree_map(host, st["err"])))
    (hmb, hcs), (cmb, ccs) = runs["host"], runs["card"]
    step_tol = lambda b: STEP_ATOL * lr
    extra = {"microbatches_2": {
        "loss_abs_diff": abs(cmb[0] - hmb[0]),
        "params_max_abs_diff": trees_close(cmb[1], hmb[1], 0, step_tol,
                                           "granite M=2 params")},
        "compressed": {"loss_abs_diff": abs(ccs[0] - hcs[0]),
                       "params_max_abs_diff": trees_close(
                           ccs[1], hcs[1], 0, step_tol,
                           "granite compressed params")}}
    require(abs(cmb[0] - hmb[0]) <= LM_LOSS_RTOL * abs(hmb[0])
            and abs(ccs[0] - hcs[0]) <= LM_LOSS_RTOL * abs(hcs[0]),
            f"(C) granite M=2 / compressed losses {cmb[0]} {hmb[0]} "
            f"{ccs[0]} {hcs[0]}")
    flips, err_max = 0.0, 0.0
    herr = dict(paths(hcs[2]))
    for k, e in paths(ccs[2]):
        diff = (e - herr[k]).abs()
        one_step = 2 * max(float(e.abs().max()), float(herr[k].abs().max()))
        require(bool((diff <= one_step + ERR_ATOL).all()),
                f"(C) compressed error {k}: beyond one quantization step")
        share = float((diff > ERR_ATOL).float().mean())
        require(share <= ERR_FLIPS, f"(C) compressed error {k}: {share} "
                f"of it beyond {ERR_ATOL}")
        flips, err_max = max(flips, share), max(err_max, float(diff.max()))
    extra["compressed"].update(err_share_beyond_atol=flips,
                               err_max_abs_diff=err_max)
    launches = {k: fn.launches for k, fn in counted.items()}
    emit({"phase": "lm_train_families", "card": card,
          "smoke_configs": fams, "granite": extra,
          "tol": {"loss_rtol": LM_LOSS_RTOL, "grad_atol_of_leaf_max":
                  LM_GRAD_ATOL, "opt": [OPT_RTOL, OPT_ATOL],
                  "step_atol_of_lr": STEP_ATOL,
                  "err": [ERR_ATOL, ERR_FLIPS]},
          "ported_kernel_launches": launches,
          "phase_wall_s": time.perf_counter() - t_phase})
    require(not any(launches.values()),
            f"(C) the training path launched a ported kernel: {launches}")
    free()

    # --------------------------------------------------- (D) lm_resume
    t_phase = time.perf_counter()
    rcfg = registry.get("granite-3-2b").smoke()

    class Killed(Exception):
        """A process killed at the start of a step."""

    def make(name, steps, ckpt_every=100, resume_=False, hook=None):
        t = Trainer(rcfg, None, optim.adamw(schedules.constant(2e-3)),
                    data_lib.SyntheticLM(data_lib.LMTaskConfig(
                        vocab_size=rcfg.vocab_size, seq_len=32,
                        global_batch=4, seed=1)),
                    TrainerConfig(steps=steps, log_every=4,
                                  ckpt_every=ckpt_every,
                                  ckpt_dir=str(pathlib.Path(ckpt_root) / name),
                                  resume=resume_), device=device)
        t.fault_hook = hook
        return t

    def at(hist, step):
        return next(h["loss"] for h in hist if h["step"] == step)

    n, kill, fault = resume["steps"], resume["kill"], resume["fault"]
    cont = make("continuous", n)
    full_hist = cont.run()

    def kill_hook(step):
        if step == kill:
            raise Killed(f"killed at step {step}")
    first = make("killed", n, resume["ckpt_every"], hook=kill_hook)
    try:
        first.run()
        require(False, "(D) the scripted kill did not fire")
    except Killed:
        pass
    second = make("killed", n, resume["ckpt_every"], resume_=True)
    resumed_hist = second.run()
    calls = []

    def fault_hook(step):
        if step == fault and not calls:
            calls.append(step)
            raise RuntimeError(f"scripted fault at step {step}")
    recovered = make("fault", n, resume["ckpt_every"], hook=fault_hook)
    fault_hist = recovered.run()
    unscripted = {k: t.recoveries for k, t in
                  (("continuous", cont), ("killed", first),
                   ("resumed", second)) if t.recoveries}
    require(not unscripted, f"(D) unscripted recoveries: {unscripted}")
    require(calls == [fault] and [s for s, _ in recovered.recoveries]
            == [fault], f"(D) recoveries {recovered.recoveries}")
    require(second.start_step == kill, f"(D) resumed at {second.start_step}")

    def held(a, b, what):
        if a == b:
            return "bit-identical"
        require(abs(a - b) <= RESUME_RTOL * abs(b),
                f"(D) {what}: {a} vs continuous {b}")
        return f"rtol {RESUME_RTOL}"
    want = at(full_hist, n)
    launches = {k: fn.launches for k, fn in counted.items()}
    emit({"phase": "lm_resume", "card": card, "arch": rcfg.name,
          "steps": n, "continuous_losses": [h["loss"] for h in full_hist],
          "kill_and_resume": {"killed_at": kill,
                              "resumed_from": second.start_step,
                              "loss": at(resumed_hist, n),
                              "held_to": held(at(resumed_hist, n), want,
                                              "resumed")},
          "fault": {"scripted_at": fault,
                    "recoveries": [list(r) for r in recovered.recoveries],
                    "loss": at(fault_hist, n),
                    "held_to": held(at(fault_hist, n), want, "recovered")},
          "unscripted_recoveries": 0,
          "ported_kernel_launches": launches,
          "phase_wall_s": time.perf_counter() - t_phase})
    require(not any(launches.values()),
            f"(D) the training path launched a ported kernel: {launches}")
    del cont, first, second, recovered
    free()
    return {"step_s": step_s, "peak_device_bytes": peak,
            "device_bytes_held_before": held_before, "step_bound": bound,
            "batch": B, "seq": S}


def time_steps(step_fn, state, batch, steps: int, sync) -> list[float]:
    """Host-clock seconds of ``steps`` train steps after one warm-up,
    each ending in a synchronise."""
    times = []
    for i in range(steps + 1):
        t0 = time.perf_counter()
        state, _ = step_fn(state, batch)
        sync()
        if i:
            times.append(time.perf_counter() - t0)
    return times


def step_bound_phases(*, device, card: str, lm_a: dict, full: bool = True
                      ) -> None:
    """Phase (E): the step's three-term bound (see the module docstring).
    ``lm_a`` is phase (A)'s result.  ``full=False`` (the tests' rehearsal
    on the CPU) counts the smoke configs and times 2 steps."""
    import dataclasses
    import gc

    import torch
    from repro_torch.configs import registry
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.core import hlo_cost
    from repro_torch.core import tpu_floorline as tfl
    from repro_torch.device import resolve_device
    from repro_torch.launch import dryrun
    from repro_torch.launch import train as launcher
    from repro_torch.models import lm
    from repro_torch.train import data as data_lib
    from repro_torch.train import optim, schedules
    from repro_torch.train import step as step_lib

    t_phase = time.perf_counter()
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if on_card else \
        (lambda: None)
    counted = hlo_cost.ported_kernels()
    for fn in counted.values():
        fn.launches = 0
    B, S = lm_a["batch"], lm_a["seq"]

    def bound_row(cost, cfg, what):
        terms = tfl.terms_from_step(cost, model_flops=tfl.model_flops_for(
            cfg, "train", S, B), label=what)
        return terms, {**terms.row(), "flops": cost.flops,
                       "hbm_bytes": cost.hbm_bytes,
                       "flops_by_dtype": cost.flops_by_dtype,
                       "device_ops": cost.n_ops,
                       "top_dots": cost.top_dots[:4],
                       "top_hbm": cost.top_hbm[:4]}

    # ---- (A)'s gemma2-2b step, counted on the card's tensors
    trainer = launcher.build(launcher.parse_args(
        ["--arch", LM_ARCH, "--steps", "1", "--batch", str(B), "--seq",
         str(S), "--device", device] + ([] if full else ["--smoke"])))
    cfg = trainer.cfg
    batch = trainer._put_batch(trainer.data.batch(0))
    t0 = time.perf_counter()
    cost = hlo_cost.analyze(trainer.step_fn, trainer.state, batch)
    sync()
    count_s = time.perf_counter() - t0
    terms, row = bound_row(cost, cfg,
                           f"{cfg.name} {cfg.param_dtype} {B}x{S}")
    del trainer, batch
    gc.collect()
    # the same cell on meta: the dry-run's count and memory account
    cell = dryrun.run_cell(LM_ARCH, ShapeSpec("lm_train", S, B, "train"),
                           smoke=not full, microbatches=1, quiet=True)
    require(cell["hlo_cost"]["flops"] == cost.flops,
            f"(E) meta flops {cell['hlo_cost']['flops']} != card flops "
            f"{cost.flops}")
    held = lm_a["device_bytes_held_before"]
    measured_peak = (lm_a["peak_device_bytes"] - held if on_card
                     else "not measured")
    meta_peak = cell["memory_analysis"]["peak_bytes"]
    step_s = lm_a["step_s"]
    gemma = {"arch": cfg.name, "batch": B, "seq_len": S,
             "count_wall_s": count_s, "terms": row,
             "lm_step_bound_ms": lm_a["step_bound"]["bound_ms"],
             "measured_step_s": step_s,
             "step_over_counted_bound": step_s / terms.bound,
             "step_over_lm_step_bound": step_s * 1e3
             / lm_a["step_bound"]["bound_ms"],
             "meta_count_equals_card_count": True,
             "meta_hbm_bytes": cell["hlo_cost"]["hbm_bytes"],
             "meta_score_bytes": cell["hlo_cost"]["score_bytes"],
             "meta_flash_adjusted_terms": cell["roofline"],
             "meta_peak_bytes": meta_peak,
             "meta_argument_bytes":
                 cell["memory_analysis"]["argument_bytes"],
             "measured_peak_bytes_less_held": measured_peak,
             "meta_over_measured_peak": (meta_peak / measured_peak
                                         if on_card else "not measured")}
    free_card = torch.cuda.empty_cache if on_card else (lambda: None)
    free_card()

    # ---- one MoE and one SSD arch: counted and timed
    others = {}
    for arch, repeats in (("olmoe-1b-7b", BOUND_MOE_REPEATS),
                          ("mamba2-1.3b", None)):
        entry = registry.get(arch)
        acfg = entry.config if full else entry.smoke()
        if full and repeats is not None:
            acfg = dataclasses.replace(acfg, n_repeats=repeats)
        model = lm.init_params(acfg, 0, device)
        opt = optim.for_arch(acfg.param_count(), schedules.constant(1e-4))
        state = step_lib.init_state(model, opt)
        step_fn = step_lib.make_train_step(model, opt)
        data = data_lib.SyntheticLM(data_lib.LMTaskConfig(
            vocab_size=acfg.vocab_size, seq_len=S, global_batch=B, seed=0))
        abatch = {k: torch.from_numpy(v).to(dev)
                  for k, v in data.batch(0).items()}
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        times = time_steps(step_fn, state, abatch,
                           BOUND_STEPS if full else 2, sync)
        peak = (torch.cuda.max_memory_allocated() if on_card
                else "not measured")
        acost = hlo_cost.analyze(step_fn, state, abatch)
        aterms, arow = bound_row(acost, acfg, f"{acfg.name} {B}x{S}")
        med = statistics.median(times)
        others[arch] = {"config": acfg.name, "n_repeats": acfg.n_repeats,
                        "params": acfg.param_count(),
                        "dtype": acfg.param_dtype, "optimizer": opt.name,
                        "step_s": times, "median_step_s": med,
                        "terms": arow,
                        "step_over_bound": med / aterms.bound,
                        "peak_device_bytes": peak}
        del model, state, step_fn, abatch
        gc.collect()
        free_card()
    launches = {k: fn.launches for k, fn in counted.items()}
    emit({"phase": "step_bound", "card": card, "gemma2": gemma,
          "others": others,
          "peaks": {"flops_per_s": tfl.PEAK_FLOPS, "bytes_per_s": tfl.HBM_BW,
                    "link_bytes_per_s": tfl.LINK_BW},
          "ported_kernel_launches": launches,
          "phase_wall_s": time.perf_counter() - t_phase})
    require(not any(launches.values()),
            f"(E) a counted step launched a ported kernel: {launches}")


def dryrun_phases(*, card: str, full: bool = True) -> None:
    """Phase (F): the one-card dry-run on ``meta`` tensors over every
    arch's cells of ``DRYRUN_SHAPES``, and one hillclimb (see the module
    docstring).  ``full=False`` (the tests' rehearsal) counts the smoke
    configs."""
    from repro_torch.configs import registry
    from repro_torch.core.hlo_cost import ported_kernels
    from repro_torch.launch import dryrun

    t_phase = time.perf_counter()
    counted = ported_kernels()
    for fn in counted.values():
        fn.launches = 0
    rows = {}
    for arch, shape in registry.all_cells():
        if shape not in DRYRUN_SHAPES:
            continue
        rec = dryrun.run_cell(arch, shape, smoke=not full, quiet=True)
        require(rec["hlo_cost"]["flops"] > 0
                and rec["hlo_cost"]["collective_bytes"] == 0,
                f"(F) {arch} {shape}: {rec['hlo_cost']['flops']} flops, "
                f"{rec['hlo_cost']['collective_bytes']} collective bytes")
        r = rec["roofline"]
        rows[f"{arch}|{shape}"] = {
            "dominant": r["dominant"], "bound_s": r["bound_s"],
            "useful_flops_ratio": r["useful_flops_ratio"],
            "fits": rec["memory_analysis"]["fits"],
            "peak_bytes": rec["memory_analysis"]["peak_bytes"],
            "microbatches": rec.get("microbatches"),
            "count_s": rec["count_s"]}
    sweep_s = time.perf_counter() - t_phase
    t0 = time.perf_counter()
    hill = dryrun.hillclimb_cell(LM_ARCH, "train_4k", smoke=not full)
    launches = {k: fn.launches for k, fn in counted.items()}
    emit({"phase": "dryrun", "card": card, "shapes": list(DRYRUN_SHAPES),
          "smoke": not full, "cells": rows, "sweep_s": sweep_s,
          "card_bytes": dryrun.card_bytes(),
          "hillclimb": {"cell": f"{LM_ARCH}|train_4k",
                        "best_overrides": hill.best_overrides,
                        "best": hill.best,
                        "steps": len(hill.log),
                        "wall_s": time.perf_counter() - t0},
          "ported_kernel_launches": launches,
          "phase_wall_s": time.perf_counter() - t_phase})
    print(hill.markdown(), flush=True)
    require(not any(launches.values()),
            f"(F) the dry-run launched a ported kernel: {launches}")


def eighths(t):
    """``t`` with each nonzero entry rounded to a nonzero multiple of 1/8
    (zeros, and so densities, kept)."""
    import torch
    q = torch.clamp(torch.round(t.abs() * 8), min=1) / 8
    return torch.where(t != 0, torch.sign(t) * q, t)


def event_options_phase(*, device, card: str, sizes=SLICE1_SIZES,
                        T: int = SLICE1_T, reps: int = OPTION_REPS) -> dict:
    """Phase (G): ``EventCompute``'s options, each of ``EVENT_OPTIONS`` in
    kernel mode on ``device`` against the host's gather run with the same
    options, on the slice-1 cell copied onto the 1/8 grid (see the module
    docstring).  Returns the phase's line."""
    import torch
    from repro_torch.core.hlo_cost import ported_kernels
    from repro_torch.kernels.neuron_epilogue.ops import neuron_epilogue
    from repro_torch.neuromorphic import (EventCompute, SimLayer,
                                          SimNetwork, fc_network,
                                          make_inputs)

    t_phase = time.perf_counter()
    dev = torch.device(device)
    host = torch.device("cpu")
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    base = fc_network(list(sizes), weight_density=0.5,
                      neuron_model="sd_relu", seed=0, device=dev)

    def grid_copy(d):
        return SimNetwork(layers=[SimLayer(
            name=l.name, kind="fc", weights=eighths(l.weights).to(d),
            neuron_model="sd_relu", threshold=OPTION_THETA)
            for l in base.layers], in_size=sizes[0])
    net, net_h = grid_copy(dev), grid_copy(host)
    xs = eighths(make_inputs(sizes[0], density=0.1, steps=T, seed=1,
                             device=dev))
    xs[(torch.arange(T, device=dev) % OPTION_PERIOD) >= OPTION_KEEP] = 0.0
    xs_h = xs.cpu()
    n_delta = len(net.layers) - 1          # every layer after an sd_relu one
    counted = ported_kernels()
    rows = {}
    for name, kw in EVENT_OPTIONS:
        cc = EventCompute(mode="kernel", **kw)
        windowed = kw.get("delta_mode", "window") == "window"
        # a value and a counter launch per layer, one value-only launch for
        # each delta layer's base rows when windowed
        expect = {"event_matmul2": (2 * len(net.layers)
                                    + (n_delta if windowed else 0)),
                  "window_cumsum": n_delta if windowed else 0}
        if not on_card:
            expect = dict.fromkeys(expect, 0)
        for fn in counted.values():
            fn.launches = 0
        neuron_epilogue.launches = 0
        sync()
        t0 = time.perf_counter()
        out, cnt = net.run_batch(xs, compute=cc)
        sync()
        first_s = time.perf_counter() - t0
        launches = {k: counted[k].launches for k in expect}
        require(launches == expect
                and not any(fn.launches for k, fn in counted.items()
                            if k not in expect),
                f"(G) {name}: launches {launches} != {expect}")
        epilogues = neuron_epilogue.launches
        require(epilogues == (len(net.layers) if on_card else 0),
                f"(G) {name}: {epilogues} neuron_epilogue launches")
        parity = glue_parity(net, xs, cc, (out, cnt), f"(G) {name}")
        walls = []
        for _ in range(reps):
            sync()
            t0 = time.perf_counter()
            net.run_batch(xs, compute=cc)
            sync()
            walls.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        out_h, cnt_h = net_h.run_batch(
            xs_h, compute=EventCompute(mode="gather", **kw))
        host_s = time.perf_counter() - t0
        for layer, a, b in zip(net.layers, cnt, cnt_h):
            for f in FIELDS:
                exact(getattr(a, f).cpu(), getattr(b, f),
                      f"(G) {name}: {layer.name} {f} against the host")
        err = close(out.cpu(), out_h, REPORT_RTOL, 0.0,
                    f"(G) {name}: outputs against the host")
        require(bool(torch.isfinite(out).all()), f"(G) {name}: non-finite")
        rows[name] = {
            "window": cc._delta_window_size(dev) if windowed else None,
            "launches": launches, "neuron_epilogue_launches": epilogues,
            "against_the_eager_glue": "bit-identical", **parity,
            "first_run_s": first_s,
            "run_batch_s": statistics.median(walls), "run_batch_s_all": walls,
            "host_gather_run_batch_s": host_s,
            "outputs_max_abs_err": err,
            "msgs_out_per_layer": [int(c.msgs_out.sum()) for c in cnt]}
    window_rows = [n for n, kw in EVENT_OPTIONS if "delta_mode" not in kw]
    line = {"phase": "event_options", "card": card,
            "cell": {"sizes": list(sizes), "T": T,
                     "grid": "weights, inputs and threshold multiples of "
                             "1/8", "sigma_delta_threshold": OPTION_THETA,
                     "bursty": f"events in the first {OPTION_KEEP} of "
                               f"every {OPTION_PERIOD} steps"},
            "counters": "bit-identical to the host's gather run",
            "outputs_rtol": REPORT_RTOL, "options": rows,
            "run_batch_s_window_vs_cumsum": {
                n: rows[n]["run_batch_s"]
                for n in window_rows + ["delta_mode=cumsum"]},
            "phase_wall_s": time.perf_counter() - t_phase}
    emit(line)
    return line


def vmap_pricing_phase(pnet, xs, chip, *, cache, cands, card: str) -> dict:
    """Phase (H): ``cands`` priced through ``evaluate_population`` with
    each of ``VMAP_BACKENDS`` from ``cache`` (phase p's pricing cache of
    the profiled cell ``(pnet, xs, chip)``), ``"vmap"`` and ``"device"``
    held to ``"numpy"`` at ``POP_RTOL``; then one scripted fault at the
    device site, which must demote to vmap.  Returns the phase's line."""
    import dataclasses

    import torch
    from repro_torch.core import resilience as R
    from repro_torch.core.partitioner import SimEvaluator

    t_phase = time.perf_counter()
    on_card = pnet.device.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    K = len(cands)
    reports, walls, peaks = {}, {}, {}
    for backend in VMAP_BACKENDS:
        ev = SimEvaluator(pnet, xs, chip, cache=cache,
                          population_backend=backend, fallback=False)
        # the vmap and device pricers are built on first use: time a
        # second call too
        for run in ("timed",) if backend == "numpy" else ("first", "timed"):
            if on_card:
                torch.cuda.reset_peak_memory_stats()
            sync()
            t0 = time.perf_counter()
            reports[backend] = ev.evaluate_population(cands)
            sync()
            walls[f"{backend}_{run}"] = time.perf_counter() - t0
        if on_card:
            peaks[backend] = torch.cuda.max_memory_allocated()
        require(ev.n_evals == K * (1 if backend == "numpy" else 2)
                and ev.active_backend == backend,
                f"(H) {backend}: {ev.n_evals} evaluations")
    err = {b: reports_close(reports[b], reports["numpy"], POP_RTOL)
           for b in ("vmap", "device")}
    ev_f = SimEvaluator(pnet, xs, chip, cache=cache,
                        population_backend="device",
                        fault_plan=R.FaultPlan(fail={"device": 2}))
    r_f = ev_f.evaluate_population(cands)
    dem = ev_f.demotions
    require(len(dem) == 1 and (dem[0].frm, dem[0].to) == ("device", "vmap")
            and ev_f.active_backend == "vmap",
            f"(H) scripted demotion: {dem}")
    demoted_err = reports_close(r_f, reports["numpy"], POP_RTOL)
    line = {"phase": "vmap_pricing", "card": card, "candidates": K,
            "cache": "phase (p), the profiled slice-1 cell",
            "wall_s": walls,
            "candidates_per_s": {b: K / walls[f"{b}_timed"]
                                 for b in VMAP_BACKENDS},
            "peak_device_bytes": peaks,
            "max_rel_diff_vs_numpy": err, "rtol": POP_RTOL,
            "scripted_demotion": {
                "fault_plan": "fail={'device': 2}",
                "demotions": [dataclasses.asdict(d) for d in dem],
                "max_rel_diff_vs_numpy": demoted_err},
            "phase_wall_s": time.perf_counter() - t_phase}
    emit(line)
    return line


def one_rank_group(device, store_dir):
    """A process group of one rank on ``device`` (NCCL on the card, gloo on
    the host), meeting through a ``file://`` store in ``store_dir``.  A
    group that fails to start raises."""
    import torch
    import torch.distributed as dist
    dev = torch.device(device)
    store_dir = pathlib.Path(store_dir)
    shutil.rmtree(store_dir, ignore_errors=True)
    store_dir.mkdir(parents=True)
    kw = {}
    if dev.type == "cuda":
        kw["device_id"] = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"file://{store_dir / 'store'}",
                            rank=0, world_size=1, **kw)
    require(dist.get_world_size() == 1, "one-rank group")
    return dist.group.WORLD


def data_parallel_phases(*, device, card: str, ckpt_root, lm_a: dict,
                         islands_ctx: dict, full: bool = True,
                         train: dict = LM_TRAIN, dp_steps: int = DP_STEPS,
                         async_ckpt: dict = ASYNC_CKPT) -> None:
    """Phase (I): the data-parallel half over a one-rank process group
    (see the module docstring).  ``lm_a`` is phase (A)'s result;
    ``islands_ctx`` holds phase (s)'s cell (``pnet``, ``xs``, ``chip``,
    ``cache``, ``greedy``, ``search``, ``islands`` and, on the card,
    ``phase_s_dir``, its snapshots).  ``full=False`` (the tests' rehearsal
    on the CPU, over gloo) uses the smoke configs and traces nothing."""
    import dataclasses
    import gc

    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs import registry
    from repro_torch.core.hlo_cost import ported_kernels
    from repro_torch.core.partitioner import SimEvaluator
    from repro_torch.core.search import evolutionary_search
    from repro_torch.device import resolve_device
    from repro_torch.distributed import collectives as C
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm, moe
    from repro_torch.models.layers import dt
    from repro_torch.train import checkpoint as ckpt_lib
    from repro_torch.train import data as data_lib
    from repro_torch.train import optim, schedules
    from repro_torch.train import step as step_lib
    from repro_torch.train.loop import (Trainer, TrainerConfig,
                                        make_dp_compressed_step)
    from repro_torch.tree import tree_leaves, tree_map

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    counted = ported_kernels()
    for fn in counted.values():
        fn.launches = 0
    shutil.rmtree(ckpt_root, ignore_errors=True)

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    def free():
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()

    def peak_reset():
        if on_card:
            torch.cuda.reset_peak_memory_stats()

    def peak():
        return torch.cuda.max_memory_allocated() if on_card \
            else "not measured"

    def same(a, b) -> bool:
        la, lb = tree_leaves(a), tree_leaves(b)
        return len(la) == len(lb) and all(torch.equal(x, y)
                                          for x, y in zip(la, lb))

    def event_ms(fn, reps: int = 3) -> float:
        """Median CUDA-event (host clock on the CPU) ms of ``fn``."""
        out = []
        for _ in range(reps):
            sync()
            if on_card:
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                fn()
                b.record()
                b.synchronize()
                out.append(a.elapsed_time(b))
            else:
                t0 = time.perf_counter()
                fn()
                out.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(out)

    group = one_rank_group(dev, ckpt_root / "group")
    backend = dist.get_backend()
    try:
        # ------------------------------------------- (I.a) data parallel
        t_phase = time.perf_counter()
        B, S, lr = train["batch"], train["seq"], train["lr"]
        entry = registry.get(LM_ARCH)
        cfg = entry.config if full else entry.smoke()
        opt = optim.adamw(schedules.constant(lr))
        model = lm.init_params(cfg, 0, device)
        state = step_lib.init_state(model, opt)
        params = state["params"]
        data = data_lib.SyntheticLM(data_lib.LMTaskConfig(
            vocab_size=cfg.vocab_size, seq_len=S, global_batch=B, seed=0))
        batches = [{k: torch.from_numpy(v).to(dev)
                    for k, v in data.batch(i).items()}
                   for i in range(dp_steps + 1)]
        with torch.no_grad():
            init = tree_map(lambda p: p.detach().clone(), params)

        def reset():
            """init_state's state again: the first parameters, AdamW's
            zero moments and float32 master copy, step 0."""
            with torch.no_grad():
                tree_map(lambda p, q: p.copy_(q), params, init)
                for k in ("m", "v"):
                    tree_map(lambda t: t.zero_(), state["opt"][k])
                tree_map(lambda w, p: w.copy_(p.float()),
                         state["opt"]["master"], params)
                state["step"].zero_()

        plain = step_lib.make_train_step(model, opt)
        dp = step_lib.make_train_step(model, opt, group=group)
        _, m_plain = plain(state, batches[0])
        sync()
        after = tree_map(lambda p: p.detach().clone(), params)
        reset()
        _, m_dp = dp(state, batches[0])
        sync()
        loss_bits = (m_plain["loss"].item(), m_dp["loss"].item())
        require(torch.equal(m_plain["loss"], m_dp["loss"])
                and same(after, params),
                f"(I.a) the exact DP step over one rank is not the step "
                f"without a group: losses {loss_bits}")
        del after
        free()

        def timed(step_fn, st) -> tuple[list, object]:
            times = []
            for b in batches[1:]:
                sync()
                t0 = time.perf_counter()
                st, _ = step_fn(st, b)
                sync()
                times.append(time.perf_counter() - t0)
            return times, st

        reset()
        peak_reset()
        plain_s, _ = timed(plain, state)
        plain_peak = peak()
        reset()
        peak_reset()
        dp_s, _ = timed(dp, state)
        dp_peak = peak()
        if on_card:
            trace_dp = traced(lambda: dp(state, batches[0]),
                              match={"nccl": ("nccl", "Nccl")})
        else:
            trace_dp = "not measured (CPU)"
        # the gradient tree's all-reduce alone, at its dtype and shapes
        grads = tree_map(lambda p: torch.randn(p.shape, device=dev)
                         .to(p.dtype), params)
        allreduce_ms = event_ms(lambda: tree_map(
            lambda g: dist.all_reduce(g, group=group), grads))
        grad_bytes = sum(g.numel() * g.element_size()
                         for g in tree_leaves(grads))
        del grads
        free()

        # compressed: the error tree beside the state
        reset()
        del init, reset
        free()
        state["err"] = C.init_error_feedback(params)
        comp = make_dp_compressed_step(model, opt, group)
        peak_reset()
        comp_s, _ = timed(comp, state)
        comp_peak = peak()
        require(all(np.isfinite(comp_s)), "(I.a) compressed steps")
        if on_card:
            trace_comp = traced(lambda: comp(state, batches[0]),
                                match={"nccl": ("nccl", "Nccl")})
        else:
            trace_comp = "not measured (CPU)"
        err_bytes = sum(e.numel() * 4 for e in tree_leaves(state["err"]))
        del state, comp, dp, plain, model, params
        free()
        # the quantise / all-reduce / dequantise passes alone
        model = lm.abstract_params(cfg)
        shapes = [p.shape for p in model.parameters()]
        grads = [torch.randn(s, device=dev).to(dt(cfg.param_dtype))
                 for s in shapes]
        errs = [torch.zeros(s, device=dev) for s in shapes]

        def compress(g_):
            for g, e in zip(grads, errs):
                mean, new = C.compressed_psum_mean(g, e, g_)
                e.copy_(new)
        comp_group_ms = event_ms(lambda: compress(group))
        comp_local_ms = event_ms(lambda: compress(None))
        del grads, errs, model
        free()
        a_s = lm_a["step_s"]
        emit({"phase": "dp_train", "card": card, "backend": backend,
              "world": 1, "arch": cfg.name, "dtype": cfg.param_dtype,
              "optimizer": "adamw", "batch": B, "seq_len": S,
              "exact_dp_bit_identical_to_no_group": True,
              "first_loss": loss_bits[0],
              "s_per_step": {"phase_A": a_s,
                             "no_group": statistics.median(plain_s),
                             "exact_dp": statistics.median(dp_s),
                             "compressed_dp": statistics.median(comp_s)},
              "step_s": {"no_group": plain_s, "exact_dp": dp_s,
                         "compressed_dp": comp_s},
              "peak_device_bytes": {"no_group": plain_peak,
                                    "exact_dp": dp_peak,
                                    "compressed_dp": comp_peak},
              "error_feedback_bytes": err_bytes,
              "gradient_bytes": grad_bytes,
              "grad_all_reduce_ms": allreduce_ms,
              "compressed_mean_ms": {"group": comp_group_ms,
                                     "no_group": comp_local_ms},
              "traced_exact_dp_step": trace_dp,
              "traced_compressed_step": trace_comp,
              "layers": cfg.n_repeats,
              "phase_wall_s": time.perf_counter() - t_phase})

        # ------------------------------------ (I.b) expert parallelism
        t_phase = time.perf_counter()
        ocfg = registry.get("olmoe-1b-7b")
        ocfg = ocfg.config if full else ocfg.smoke()
        if full:
            ocfg = dataclasses.replace(ocfg, n_repeats=BOUND_MOE_REPEATS)
        odata = data_lib.SyntheticLM(data_lib.LMTaskConfig(
            vocab_size=ocfg.vocab_size, seq_len=S, global_batch=B, seed=0))
        obatch = {k: torch.from_numpy(v).to(dev)
                  for k, v in odata.batch(0).items()}
        res, trace_ep = {}, "not measured (CPU)"
        # the MoE's index_add (combine, and the dispatch's backward) sums
        # with atomics on the card: bit identity needs the deterministic
        # implementations (warn_only: the GEMMs have none to select)
        was = torch.are_deterministic_algorithms_enabled()
        torch.use_deterministic_algorithms(True, warn_only=True)
        for name in ("no_group", "no_group_again", "ep"):
            omodel = lm.init_params(ocfg, 0, device)
            g = None
            if name == "ep":
                require(moe.shard_experts(omodel, group) > 0,
                        "(I.b) no MoE block")
                g = group
            with torch.no_grad():
                fwd_ms = event_ms(lambda: lm.loss_fn(omodel, obatch,
                                                     group=g))
            total, metrics, ograds = step_lib.value_and_grad(omodel, obatch,
                                                             g)
            sync()
            res[name] = (total, metrics, ograds, fwd_ms)
            if on_card and name == "ep":
                trace_ep = traced(lambda: lm.loss_fn(omodel, obatch, group=g),
                                  match={"nccl": ("nccl", "Nccl")})
            del omodel
            free()
        torch.use_deterministic_algorithms(was)

        def identical(x, y) -> bool:
            (ta, ma, ga, _), (tb, mb, gb, _) = x, y
            return (torch.equal(ta, tb) and sorted(ma) == sorted(mb)
                    and all(torch.equal(ma[k], mb[k]) for k in ma)
                    and same(ga, gb))
        require(identical(res["no_group"], res["no_group_again"]),
                "(I.b) the path without a group is not deterministic")
        require(identical(res["no_group"], res["ep"]),
                "(I.b) the EP loss or gradients over one rank differ from "
                "the path without a group")
        fa, mb, fb = res["no_group"][3], res["ep"][1], res["ep"][3]
        emit({"phase": "dp_expert_parallel", "card": card,
              "backend": backend, "world": 1, "config": ocfg.name,
              "n_repeats": ocfg.n_repeats, "dtype": ocfg.param_dtype,
              "batch": B, "seq_len": S,
              "loss_and_grads_bit_identical_to_no_group": True,
              "deterministic_algorithms": True,
              "metrics": {k: float(v) for k, v in mb.items()},
              "loss_fn_ms": {"no_group": fa, "ep": fb},
              "traced_ep_loss": trace_ep,
              "phase_wall_s": time.perf_counter() - t_phase})
        del res, mb
        free()

        # ----------------------------------- (I.c) islands over a group
        t_phase = time.perf_counter()
        ctx = islands_ctx
        gens = ctx["search"]["generations"]

        def search(d, **kw):
            ev = SimEvaluator(ctx["pnet"], ctx["xs"], ctx["chip"],
                              cache=ctx["cache"])
            sync()
            t0 = time.perf_counter()
            r = evolutionary_search(
                ctx["pnet"], ctx["chip"], ev, engine="sharded",
                greedy=ctx["greedy"], checkpoint_dir=str(d),
                checkpoint_every=1, checkpoint_keep=gens + 1,
                **ctx["search"], **ctx["islands"], **kw)
            sync()
            return r, time.perf_counter() - t0
        one, one_s = search(ckpt_root / "islands_one")
        grp, grp_s = search(ckpt_root / "islands_group", group=group)
        require(grp.demotions == [] and one.demotions == [],
                "(I.c) demotions")
        s_one = snapshots(ckpt_root / "islands_one")
        s_grp = snapshots(ckpt_root / "islands_group")
        diff = held_to_mirror(grp, one, s_grp, s_one,
                              "(I.c) islands over the group vs one program",
                              gens)
        if ctx.get("phase_s_dir") is not None:
            s_s = snapshots(ctx["phase_s_dir"])
            require(len(s_s) == len(s_grp) and all(
                np.array_equal(a[k], b[k]) for a, b in zip(s_grp, s_s)
                for k in ("cores", "perm")),
                "(I.c) genomes differ from phase (s)'s snapshots")
        emit({"phase": "dp_islands", "card": card, "backend": backend,
              "world": 1, **ctx["islands"],
              "population_size": ctx["search"]["population_size"],
              "generations": gens,
              "genomes_identical_every_snapshot": gens + 1,
              "held_to_phase_s_snapshots": ctx.get("phase_s_dir")
              is not None, "max_rel_diff": diff,
              "wall_s": {"one_program": one_s, "group": grp_s},
              "phase_wall_s": time.perf_counter() - t_phase})

        # --------------------------------------- (I.d) async checkpoints
        t_phase = time.perf_counter()
        gcfg = registry.get("granite-3-2b").smoke()
        tr = Trainer(gcfg, make_mesh((1, 1), ("data", "model")),
                     optim.adamw(schedules.constant(2e-3)),
                     data_lib.SyntheticLM(data_lib.LMTaskConfig(
                         vocab_size=gcfg.vocab_size, seq_len=32,
                         global_batch=4, seed=1)),
                     TrainerConfig(steps=async_ckpt["save_at"], log_every=1),
                     device=device)
        require(tr.group is group, "(I.d) the trainer's data group")
        tr.run()
        at = async_ckpt["save_at"]
        ckpt_lib.save(str(ckpt_root / "sync"), at, tr.state,
                      extra={"data_step": tr.data_step})
        t0 = time.perf_counter()
        th = ckpt_lib.save_async(str(ckpt_root / "async"), at, tr.state,
                                 extra={"data_step": tr.data_step})
        snapshot_s = time.perf_counter() - t0
        during, after_, written_by = [], [], None
        for i in range(async_ckpt["steps"]):
            alive = th.is_alive()
            if not alive and written_by is None:
                written_by = time.perf_counter() - t0
            b = tr._put_batch(tr.data.batch(tr.data_step + i))
            sync()
            t1 = time.perf_counter()
            tr.state, _ = tr.step_fn(tr.state, b)
            sync()
            (during if alive else after_).append(time.perf_counter() - t1)
        th.join()
        if written_by is None:
            written_by = time.perf_counter() - t0
        like = tree_map(lambda t: torch.empty((), dtype=t.dtype,
                                              device=dev), tr.state)
        ra, sa, ea = ckpt_lib.restore(str(ckpt_root / "async"), like)
        rb, sb, eb = ckpt_lib.restore(str(ckpt_root / "sync"), like,
                                      shardings=tree_map(lambda _: dev,
                                                         like))
        require(sa == sb == at and ea == eb and same(ra, rb),
                "(I.d) the async checkpoint differs from the synchronous one")
        emit({"phase": "dp_async_checkpoint", "card": card,
              "arch": gcfg.name, "saved_at_step": at,
              "restore_bit_identical_to_sync_save": True,
              "host_snapshot_s": snapshot_s,
              "write_done_within_s": written_by,
              "step_s_during_write": during, "step_s_after_write": after_,
              "phase_wall_s": time.perf_counter() - t_phase})
        del tr, ra, rb, like
        free()
    finally:
        dist.destroy_process_group()
    launches = {k: fn.launches for k, fn in counted.items()}
    require(not any(launches.values()),
            f"(I) the data-parallel paths launched a ported kernel: "
            f"{launches}")


def tp_calls_per_step(cfg) -> dict:
    """The tensor-parallel collective launches (``collectives.TP_CALLS``)
    of one decode step and one train step of ``cfg`` without PerfFlags,
    counted from the code, for a stack of L attention blocks with a dense
    MLP whose heads divide the group (branch a) and no qk-norm:

    decode: the embedding's psum; per block the query's and the new K's
    and V's gather_from, the flash-decoding merge's pmax and two psums,
    the row-parallel psums of ``wo`` and the MLP; the logits'
    gather_from.  psum 1 + 4L, gather_from 3L + 1, pmax L.

    train: the forward's psums (embedding, 2 a block, the cross entropy's
    sum of exponentials and its label logits: 2L + 3) and the max of the
    log-normaliser (1); the backward's all-reduce of each ``copy_to``
    (2 a block, the logits': 2L + 1); ``remat="block"`` recomputes each
    repeated block's forward, 2 psums each."""
    blocks = cfg.all_blocks()
    require(all(b.kind == "attn" and b.d_ff and b.moe is None
                for b in blocks) and not cfg.qk_norm
            and cfg.frontend == "none", f"{cfg.name}: not the counted stack")
    L = len(blocks)
    rep = len(cfg.pattern) * cfg.n_repeats if cfg.remat == "block" else 0
    return {"decode": {"psum": 1 + 4 * L, "gather_from": 3 * L + 1,
                       "pmax": L},
            "train": {"psum": 2 * L + 3 + 2 * rep, "pmax": 1,
                      "copy_to.grad": 2 * L + 1}}


def tensor_parallel_phases(*, device, card: str, ckpt_root, serve_x: dict,
                           full: bool = True, serve_args: dict = SERVE,
                           train: dict = LM_TRAIN, steps: int = TP_STEPS,
                           trace_steps: int = SERVE_TRACE_STEPS) -> None:
    """Phase (J): the tensor-parallel code on a (1, 1) mesh over a
    one-rank process group (see the module docstring); ``serve_x`` is
    phase (x)'s result.  ``full=False`` (the tests' rehearsal on the CPU,
    over gloo) uses the smoke configs."""
    import dataclasses
    import gc

    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs import registry
    from repro_torch.core.hlo_cost import ported_kernels
    from repro_torch.device import resolve_device
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed import sharding
    from repro_torch.launch import serve
    from repro_torch.launch import train as launcher
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm
    from repro_torch.serve.engine import Engine
    from repro_torch.train import data as data_lib
    from repro_torch.train import step as step_lib
    from repro_torch.tree import tree_leaves, tree_map

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    counted = ported_kernels()
    for fn in counted.values():
        fn.launches = 0
    shutil.rmtree(ckpt_root, ignore_errors=True)

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    def free():
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()

    def peak_reset():
        if on_card:
            torch.cuda.reset_peak_memory_stats()

    def peak():
        return torch.cuda.max_memory_allocated() if on_card \
            else "not measured"

    def host(tree):
        return tree_map(lambda t: t.detach().to("cpu", copy=True), tree)

    def identical(a, b) -> bool:
        la, lb = tree_leaves(a), tree_leaves(b)
        return len(la) == len(lb) and all(torch.equal(x, y.to(x.device))
                                          for x, y in zip(la, lb))

    group = one_rank_group(dev, ckpt_root / "group")
    backend = dist.get_backend()
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        require(mesh.groups["model"] is not None, "(J) no model group")
        entry = registry.get(LM_ARCH)
        cfg = entry.config if full else entry.smoke()
        want_calls = tp_calls_per_step(cfg)

        # ------------------------------------------------ (J.a) serving
        t_phase = time.perf_counter()
        B, P, N = (serve_args[k] for k in ("batch", "prompt_len",
                                           "new_tokens"))
        scfg, eng0, prompts = serve.build(serve.parse_args(
            ["--arch", SERVE_ARCH, "--batch", str(B), "--prompt-len",
             str(P), "--new-tokens", str(N), "--device", device]
            + ([] if full else ["--smoke"])))
        eng = Engine(scfg, eng0.model, eng0.scfg, device=device, mesh=mesh)
        del eng0
        require(eng.ctx.tp_group is not None, "(J.a) the engine's group")
        first = eng.generate(prompts)             # warm
        out = eng.generate(prompts)
        decode_ms = statistics.median(s * 1e3
                                      for s in eng.timings["step_s"][1:])
        require(out == first == serve_x["tokens"],
                "(J.a) tokens over the model group differ from (x)'s")
        with torch.no_grad():
            logits, cache = eng.prefill(torch.tensor(prompts, device=dev),
                                        P + trace_steps)
            sync()
            C.TP_CALLS.clear()
            cur = logits.argmax(-1)
            logits, _ = lm.decode_step(eng.model, cur[:, None], cache, P)
            serve_calls = dict(C.TP_CALLS)
            cur = logits.argmax(-1)

            def decode_steps():
                nonlocal cur
                for t in range(1, trace_steps):
                    lg, _ = lm.decode_step(eng.model, cur[:, None], cache,
                                           P + t)
                    cur = lg.argmax(-1)
            if on_card:
                trace = traced(decode_steps,
                               match={"nccl": ("nccl", "Nccl")})
                trace["device_ops_per_step"] = (trace["device_ops"]
                                                / (trace_steps - 1))
            else:
                decode_steps()
                trace = "not measured (CPU)"
        require(serve_calls == want_calls["decode"],
                f"(J.c) decode step's collectives {serve_calls} != "
                f"{want_calls['decode']}")
        emit({"phase": "tp_serve", "card": card, "backend": backend,
              "mesh": [1, 1], "arch": scfg.name, "dtype": scfg.param_dtype,
              "batch": B, "prompt_len": P, "new_tokens": N,
              "tokens_equal_phase_x": True,
              "decode_ms_per_token": {"phase_x": serve_x["decode_ms"],
                                      "tp_group": decode_ms},
              "prefill_s": eng.timings["prefill_s"],
              "collectives_per_decode_step": serve_calls,
              "traced_decode": trace, "traced_steps": trace_steps - 1,
              "phase_wall_s": time.perf_counter() - t_phase})
        del eng, cache, logits, cur
        free()

        # ----------------------------------------------- (J.b) training
        t_phase = time.perf_counter()
        args = ["--arch", LM_ARCH, "--steps", str(steps), "--batch",
                str(train["batch"]), "--seq", str(train["seq"]), "--lr",
                str(train["lr"]), "--device", device] \
            + ([] if full else ["--smoke"])
        runs = {}
        for name, extra in (("no_group", []),
                            ("tp_group", ["--mesh-shape", "1,1"])):
            tr = launcher.build(launcher.parse_args(args + extra))
            tr.tcfg.log_every = 1
            require((tr.ctx.tp_group is not None) == bool(extra),
                    f"(J.b) {name}: the trainer's model group")
            peak_reset()
            C.TP_CALLS.clear()
            hist = tr.run()
            sync()
            runs[name] = {"losses": [h["loss"] for h in hist],
                          "s_per_step": [h["dt"] for h in hist],
                          "peak": peak(), "calls": dict(C.TP_CALLS),
                          "params": host(tr.state["params"])}
            del tr, hist
            free()
        a, b = runs["no_group"], runs["tp_group"]
        require(a["losses"] == b["losses"] and identical(a["params"],
                                                         b["params"]),
                f"(J.b) the train step over the model group is not the "
                f"step without one: losses {a['losses']} {b['losses']}")
        train_calls = {k: v / steps for k, v in b["calls"].items()}
        require(not a["calls"] and train_calls == want_calls["train"],
                f"(J.c) train step's collectives {train_calls} != "
                f"{want_calls['train']}")
        emit({"phase": "tp_train", "card": card, "backend": backend,
              "mesh": [1, 1], "arch": cfg.name, "dtype": cfg.param_dtype,
              "optimizer": "adamw", "batch": train["batch"],
              "seq_len": train["seq"], "steps": steps,
              "loss_and_params_bit_identical_to_no_group": True,
              "losses": b["losses"],
              "s_per_step": {k: r["s_per_step"] for k, r in runs.items()},
              "peak_device_bytes": {k: r["peak"] for k, r in runs.items()},
              "collectives_per_train_step": train_calls,
              "phase_wall_s": time.perf_counter() - t_phase})
        emit({"phase": "tp_collectives", "card": card,
              "expected_from_code": want_calls,
              "measured": {"decode": serve_calls, "train": train_calls},
              "equal": True})
        del runs, a, b
        free()

        # ------------------------- (J.d) PerfFlags and other block kinds
        t_phase = time.perf_counter()
        S = train["seq"]
        flags = sharding.PerfFlags(moe_sp_dispatch=True, sp_residual=True)
        flag_cfgs = [entry.config if full else entry.smoke()]
        ocfg = registry.get("olmoe-1b-7b")
        ocfg = ocfg.config if full else ocfg.smoke()
        if full:
            ocfg = dataclasses.replace(ocfg, n_repeats=BOUND_MOE_REPEATS)
        flag_cfgs.append(ocfg)
        # the MoE's index_add sums with atomics on the card: bit identity
        # needs the deterministic implementations (as phase I.b)
        was = torch.are_deterministic_algorithms_enabled()
        torch.use_deterministic_algorithms(True, warn_only=True)
        flag_rows = []
        for fcfg in flag_cfgs:
            data = data_lib.SyntheticLM(data_lib.LMTaskConfig(
                vocab_size=fcfg.vocab_size, seq_len=S,
                global_batch=train["batch"], seed=0))
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in data.batch(0).items()}
            res = {}
            for name, fl in (("no_group", None), ("flags", flags)):
                model = lm.init_params(fcfg, 0, device)
                if fl is not None:
                    sharding.shard_params(model, sharding.make_ctx(
                        mesh, flags=fl))
                C.TP_CALLS.clear()
                t0 = time.perf_counter()
                total, metrics, grads = step_lib.value_and_grad(model, batch)
                sync()
                res[name] = (total.item(), host(grads),
                             time.perf_counter() - t0, dict(C.TP_CALLS))
                del model, total, metrics, grads
                free()
            (la, ga, sa, _), (lb, gb, sb, calls) = (res["no_group"],
                                                    res["flags"])
            require(la == lb and identical(ga, gb),
                    f"(J.d) {fcfg.name} under PerfFlags(True, True) over "
                    f"one rank differs from the path without a group")
            flag_rows.append({"config": fcfg.name,
                              "n_repeats": fcfg.n_repeats,
                              "dtype": fcfg.param_dtype, "loss": la,
                              "bit_identical": True,
                              "value_and_grad_s": {"no_group": sa,
                                                   "flags": sb},
                              "collectives": calls})
            del res, ga, gb
            free()
        torch.use_deterministic_algorithms(was)

        # smoke configs of the other block kinds: card against host
        fam_rows = []
        for arch in TP_SMOKE:
            fcfg = registry.get(arch).smoke()
            data = data_lib.SyntheticLM(data_lib.LMTaskConfig(
                vocab_size=fcfg.vocab_size, seq_len=16, global_batch=4,
                seed=0))
            hb = {k: torch.from_numpy(v) for k, v in data.batch(0).items()}
            host_m = lm.init_params(fcfg, 0, "cpu")
            hl, _, hg = step_lib.value_and_grad(host_m, hb)
            tree = lm.params_to_numpy(host_m)
            row = {"config": fcfg.name}
            for name, fl in (("tp", sharding.PerfFlags()), ("flags", flags)):
                model = lm.params_from_numpy(fcfg, tree, device)
                sharding.shard_params(model, sharding.make_ctx(mesh,
                                                               flags=fl))
                cl, _, cg = step_lib.value_and_grad(
                    model, {k: v.to(dev) for k, v in hb.items()})
                require(abs(cl.item() - hl.item())
                        <= LM_LOSS_RTOL * abs(hl.item()),
                        f"(J.d) {arch} {name}: loss {cl.item()} on the card "
                        f"vs {hl.item()} on the host")
                err = 0.0
                for g, h in zip(tree_leaves(cg), tree_leaves(hg)):
                    e = float((g.cpu() - h).abs().max())
                    scale = float(h.abs().max())
                    require(e <= LM_GRAD_ATOL * max(scale, 1e-30),
                            f"(J.d) {arch} {name}: a gradient {e} from the "
                            f"host's (largest {scale})")
                    err = max(err, e / max(scale, 1e-30))
                row[name] = {"loss_abs_diff": abs(cl.item() - hl.item()),
                             "max_grad_rel_diff": err}
            fam_rows.append(row)
        emit({"phase": "tp_flags", "card": card, "backend": backend,
              "mesh": [1, 1], "flags": dataclasses.asdict(flags),
              "batch": train["batch"], "seq_len": S,
              "full_width_bit_identical": flag_rows,
              "smoke_card_vs_host": fam_rows,
              "tol": {"loss_rtol": LM_LOSS_RTOL,
                      "grad_atol_of_leaf_max": LM_GRAD_ATOL},
              "phase_wall_s": time.perf_counter() - t_phase})
    finally:
        dist.destroy_process_group()
    launches = {k: fn.launches for k, fn in counted.items()}
    require(not any(launches.values()),
            f"(J) the tensor-parallel paths launched a ported kernel: "
            f"{launches}")


def neuron_scan_phase(*, card: str, T: int = SCAN_T, n: int = SCAN_N
                      ) -> dict:
    """Phase (L): the ssm state neurons' scan at one state layer of the
    ``mamba2-1.3b-6of48`` cell, (T, n) float32 pre-activations read as a
    row slice of a padded block, as ``EventCompute`` hands them over.
    The kernel's messages and final state against the loop on the card,
    bit for bit, for both ``force_active`` values; one launch a call; the
    launch alone (warm, and after an L2-evicting write), the wrapper and
    the loop timed beside the bytes bound.  Then one stream of the cell
    through ``run_batch`` (:func:`scan_cell_stream`).  Returns the
    kernel-table row, whose ``launches`` are that stream's."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.neuron_scan.ops import ssm_scan
    from repro_torch.kernels.neuron_scan.ref import ssm_scan_ref

    g = torch.Generator(device="cuda").manual_seed(5)
    wide = torch.randn((T, n + SCAN_PAD), generator=g, device="cuda")
    pre = wide[:, :n]
    x0 = torch.randn(n, generator=g, device="cuda")
    bits = lambda a: a.view(torch.int32)
    checked = {}
    for fa in (False, True):
        before = ssm_scan.launches
        y, x = ssm_scan(pre, x0, SCAN_DECAY, fa)
        require(ssm_scan.launches == before + 1,
                f"(L) ssm_scan launched {ssm_scan.launches - before} times")
        want_y, want_x = ssm_scan_ref(pre, x0, SCAN_DECAY, fa)
        torch.cuda.synchronize()
        same = (torch.equal(bits(y), bits(want_y))
                and torch.equal(bits(x), bits(want_x)))
        require(same, f"(L) force_active={fa}: the kernel is not the "
                      f"loop's bits")
        checked[str(fa)] = {"bit_identical": same,
                            "messages_nonzero": int((y != 0).sum())}
    lib = build.load()
    y_out, x_out = torch.empty((T, n), device="cuda"), torch.empty_like(x0)
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        lib.ssm_scan_launch(pre.data_ptr(), pre.stride(0), x0.data_ptr(),
                            y_out.data_ptr(), x_out.data_ptr(), T, n,
                            SCAN_DECAY, 1, stream)
    nbytes = 2 * (T + 1) * n * 4
    bound_ms = 1e3 * nbytes / PEAK_BYTES_PER_S
    ms, cold_ms = time_ms(launch), time_ms_cold(launch)
    row = {"name": "ssm_scan", "route": "cuda",
           "source": "src/repro_torch/csrc/neuron_scan.cu",
           "replaces": None, "ms": ms, "cold_ms": cold_ms,
           "bound_ms": bound_ms, "bound_by": "bytes",
           "plain_ms": time_ms(lambda: ssm_scan_ref(pre, x0, SCAN_DECAY,
                                                    True), reps=2,
                               batches=3),
           "library_ms": None,
           "wrapper_ms": time_ms(lambda: ssm_scan(pre, x0, SCAN_DECAY,
                                                  True))}
    del wide, pre, x0, y, x, want_y, want_x, y_out, x_out
    torch.cuda.empty_cache()
    stream_rec = scan_cell_stream()
    row["launches"] = stream_rec["launches"]
    row["cell_epilogue_launches"] = stream_rec["neuron_epilogue"]["launches"]
    emit({"phase": "neuron_scan", "card": card, "T": T, "n": n,
          "row_stride": n + SCAN_PAD, "decay": SCAN_DECAY,
          "bytes": nbytes, "checked": checked, **row,
          "roofline_pct": 100.0 * bound_ms / ms,
          "roofline_pct_cold": 100.0 * bound_ms / cold_ms,
          "cell_stream": stream_rec})
    return row


def neuron_epilogue_phase(*, card: str, T: int = SCAN_T,
                          n: int = SCAN_VOCAB) -> dict:
    """Phase (L)'s epilogue row: the neuron epilogue alone at the shape of
    the ``mamba2-1.3b-6of48`` cell's head (T x n, force-active, no bias or
    gate), ``pre`` and ``macs`` read as row slices of the padded product
    as ``EventCompute`` hands them over.  Its five outputs against the
    plain version on the card, bit for bit, for each neuron code; one
    launch a call; the launch alone (warm, and after an L2-evicting
    write), the wrapper and the plain version timed beside the bytes
    bound (read ``pre`` and ``macs``, write three maps).  Returns the
    kernel-table row."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.neuron_epilogue.ops import neuron_epilogue
    from repro_torch.kernels.neuron_epilogue.ref import (FORCE_ACTIVE,
                                                         IDENTITY, RELU,
                                                         neuron_epilogue_ref)

    padded = -(-n // TILE) * TILE
    g = torch.Generator(device="cuda").manual_seed(7)
    wide = torch.randn((T, padded), generator=g, device="cuda")
    wide_m = torch.randint(0, 3, (T, padded), generator=g,
                           device="cuda").to(torch.float32)
    pre, macs = wide[:, :n], wide_m[:, :n]
    bits = lambda a: a.view({8: torch.int64, 4: torch.int32}[
        a.element_size()])
    checked = {}
    for name, code in (("identity", IDENTITY), ("relu", RELU),
                       ("force_active", FORCE_ACTIVE)):
        before = neuron_epilogue.launches
        got = neuron_epilogue(pre, macs, None, None, code)
        require(neuron_epilogue.launches == before + 1,
                f"(L) neuron_epilogue launched "
                f"{neuron_epilogue.launches - before} times")
        want = neuron_epilogue_ref(pre, macs, None, None, code)
        torch.cuda.synchronize()
        for i, (a, b) in enumerate(zip(got, want)):
            exact(bits(a), bits(b), f"(L) epilogue {name}: output {i}")
        checked[name] = {"bit_identical": True,
                         "messages": int(got[3].to(torch.float64).sum())}
        del got, want
    lib = build.load()
    y, msgs, acts = (torch.empty((T, n), device="cuda") for _ in range(3))
    counts = torch.empty(T, device="cuda")
    counts64 = torch.empty(T, dtype=torch.float64, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        lib.neuron_epilogue_launch(
            pre.data_ptr(), pre.stride(0), macs.data_ptr(), macs.stride(0),
            None, None, y.data_ptr(), msgs.data_ptr(), acts.data_ptr(),
            counts.data_ptr(), counts64.data_ptr(), T, n, FORCE_ACTIVE,
            stream)
    nbytes = 5 * T * n * 4
    bound_ms = 1e3 * nbytes / PEAK_BYTES_PER_S
    ms, cold_ms = time_ms(launch), time_ms_cold(launch)
    row = {"name": "neuron_epilogue", "route": "cuda",
           "source": "src/repro_torch/csrc/neuron_epilogue.cu",
           "replaces": None, "ms": ms, "cold_ms": cold_ms,
           "bound_ms": bound_ms, "bound_by": "bytes",
           "plain_ms": time_ms(lambda: neuron_epilogue_ref(
               pre, macs, None, None, FORCE_ACTIVE), reps=5),
           "library_ms": None,
           "wrapper_ms": time_ms(lambda: neuron_epilogue(
               pre, macs, None, None, FORCE_ACTIVE))}
    emit({"phase": "neuron_epilogue", "card": card, "T": T, "n": n,
          "row_stride": padded, "bytes": nbytes, "checked": checked, **row,
          "roofline_pct": 100.0 * bound_ms / ms,
          "roofline_pct_cold": 100.0 * bound_ms / cold_ms})
    del wide, wide_m, pre, macs, y, msgs, acts, counts, counts64
    torch.cuda.empty_cache()
    return row


def scan_cell_stream() -> dict:
    """Phase (L)'s stream of ``mamba2-1.3b-6of48.ssm1024``: the registry's
    mamba2-1.3b cut to ``SCAN_BLOCKS`` blocks with the published
    ``SCAN_VOCAB``-wide head, T = ``SCAN_T``, through ``run_batch`` in
    kernel mode under a recording.  Requires one ``ssm_scan`` launch a
    state layer, ``neuron_scan.entries`` = state layers x T x n, and the
    output and every counter bit for bit with the same stream through
    the loop (``ssm_scan_ref`` in the scan's place), and each layer's
    float32 value product of the stream, launched again on its recorded
    operands, held to the float64 product and the plain version
    (:func:`f32_product_errors`).  Returns the record."""
    import dataclasses

    import torch
    from repro_torch import trace
    from repro_torch.configs import mamba2_1_3b
    from repro_torch.kernels.event_matmul.ops import (event_matmul2,
                                                      weight_block_occupancy)
    from repro_torch.kernels.neuron_epilogue.ops import neuron_epilogue
    from repro_torch.kernels.neuron_scan.ops import ssm_scan
    from repro_torch.kernels.neuron_scan.ref import ssm_scan_ref
    from repro_torch.neuromorphic import EventCompute, compile_network
    from repro_torch.neuromorphic import network as network_mod

    cfg = dataclasses.replace(mamba2_1_3b.CONFIG, n_repeats=SCAN_BLOCKS,
                              vocab_size=SCAN_VOCAB)
    t0 = time.perf_counter()
    cn = compile_network(cfg, seq_len=SCAN_T, smoke=False, seed=0,
                         device=DEVICE)
    compile_s = time.perf_counter() - t0
    state = [l for l in cn.net.layers if l.neuron_model == "ssm"]
    require(len(state) == SCAN_BLOCKS
            and all(l.n_neurons == SCAN_N for l in state),
            f"(L) {len(state)} state layers, widths "
            f"{sorted({l.n_neurons for l in state})}")
    xs = cn.inputs(SCAN_T, seed=5)
    calls = recorder()
    ssm_scan.launches = neuron_epilogue.launches = 0
    with trace.recording() as rec:
        out, cnts = cn.net.run_batch(xs, compute=calls)
    torch.cuda.synchronize()
    launches = ssm_scan.launches
    entries = rec.count("neuron_scan.entries")
    require(launches == len(state),
            f"(L) {launches} ssm_scan launches a stream, not {len(state)}")
    require(entries == len(state) * SCAN_T * SCAN_N,
            f"(L) neuron_scan.entries {entries}")
    # one neuron epilogue a layer, the wire handed on L - 1 times
    L = len(cn.net.layers)
    epilogues = neuron_epilogue.launches
    handoffs = rec.count("network.wire_handoffs")
    require(epilogues == L == 19 and handoffs == L - 1,
            f"(L) {epilogues} neuron_epilogue launches and {handoffs} "
            f"handoffs for {L} layers")
    require(rec.count("neuron_epilogue.entries")
            == SCAN_T * sum(l.n_neurons for l in cn.net.layers),
            "(L) neuron_epilogue.entries")
    errs, faults = [], []
    for layer, x, _, _ in calls.calls:
        occ = weight_block_occupancy(layer.weights)
        try:
            errs.append(f32_product_errors(
                event_matmul2(x, layer.weights, occ), x, layer.weights, occ,
                f"(L) {layer.name} values"))
        except RuntimeError as e:
            faults.append(str(e))
    require(not faults, "; ".join(faults))
    require(len(errs) == len(calls.calls) == len(cn.net.layers),
            f"(L) {len(errs)} value products checked, not "
            f"{len(calls.calls)} of {len(cn.net.layers)} layers")
    calls.calls.clear()
    network_mod.ssm_scan = ssm_scan_ref
    try:
        t0 = time.perf_counter()
        out_l, cnts_l = cn.net.run_batch(xs,
                                         compute=EventCompute(mode="kernel"))
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t0
    finally:
        network_mod.ssm_scan = ssm_scan
    require(ssm_scan.launches == launches,
            "(L) the loop's stream launched the scan")
    exact(out.view(torch.int32), out_l.view(torch.int32), "(L) output")
    for layer, a, b in zip(cn.net.layers, cnts, cnts_l):
        for f in FIELDS:
            exact(getattr(a, f), getattr(b, f), f"(L) {layer.name} {f}")
    del out_l, cnts_l
    parity = glue_parity(cn.net, xs, EventCompute(mode="kernel"),
                         (out, cnts), "(L) mamba2-1.3b-6of48")
    rec_out = {"config": f"mamba2-1.3b, {SCAN_BLOCKS} of "
                         f"{mamba2_1_3b.CONFIG.n_repeats} blocks, vocab "
                         f"{SCAN_VOCAB}",
               "layers": len(cn.net.layers), "state_layers": len(state),
               "T": SCAN_T, "launches": launches, "entries": entries,
               "neuron_epilogue": {"launches": epilogues,
                                   "wire_handoffs": handoffs,
                                   "against_the_eager_glue":
                                   "bit-identical", **parity},
               **{k: max(e[k] for e in errs) for k in errs[0]},
               "compile_s": compile_s, "loop_run_batch_s": loop_s,
               "output_and_counters": "bit-identical to the loop"}
    del cn, xs, out, cnts
    torch.cuda.empty_cache()
    return rec_out


def init_phase(*, device, card: str, full: bool = True,
               edge: int = INIT_EDGE) -> dict:
    """Phase (K): the LM weights from the reference's key on the card, held
    to the host's draw (see the module docstring).  ``full=False`` (the
    tests' rehearsal on the CPU) draws the smoke configs, the host standing
    in for the card.  Returns the emitted record."""
    import dataclasses

    import torch
    from repro_torch.configs import registry
    from repro_torch.core import prng
    from repro_torch.core.hlo_cost import ported_kernels
    from repro_torch.device import resolve_device
    from repro_torch.models import lm
    from repro_torch.models.layers import INIT_CHUNK, _init

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    counted = ported_kernels()
    for fn in counted.values():
        fn.launches = 0
    key = prng.PRNGKey(INIT_SEED)

    def bits(t):
        t = t.detach().cpu().contiguous()
        return t.view(torch.int16 if t.element_size() == 2 else torch.int32)

    def draw(cfg, whole) -> dict:
        """``cfg``'s weights from ``key`` on the card, timed and peaked;
        then the host draws the leaves ``whole(block, path)`` selects
        whole, and the first and last ``edge`` elements of the model's own
        leaves (``embed``, ``unembed``) from their offsets."""
        if on_card:
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = lm.init_params(cfg, key, device)
        if on_card:
            torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        model_bytes = sum(p.numel() * p.element_size()
                          for p in model.parameters())
        peak = (torch.cuda.max_memory_allocated() - held if on_card
                else "not measured")
        t0 = time.perf_counter()
        leaves = elements = 0
        for i, (m, kg) in enumerate(lm.draw_order(model, key)):
            blk = i - 1                     # the model's own leaves first
            for path, leaf, fan_in in m.weights():
                k = kg()
                flat = leaf.view(-1)
                if blk < 0:
                    spans = sorted({0, max(flat.numel() - edge, 0)})
                elif whole(blk, path):
                    spans = [0]
                else:
                    continue
                for s in spans:
                    n = flat.numel() if blk >= 0 else min(edge,
                                                          flat.numel() - s)
                    host = torch.empty(n, dtype=leaf.dtype)
                    _init(host, k, fan_in, s)
                    require(torch.equal(bits(flat[s:s + n]), bits(host)),
                            f"(K) {cfg.name} {'' if blk < 0 else blk} "
                            f"{path}[{s}:{s + n}]: the card's draw differs "
                            f"from the host's")
                    leaves, elements = leaves + 1, elements + n
        row = {"config": cfg.name, "param_dtype": cfg.param_dtype,
               "n_repeats": cfg.n_repeats, "parameters": sum(
                   p.numel() for p in model.parameters()),
               "init_s": init_s, "model_bytes": model_bytes,
               "peak_bytes_less_held": peak,
               "peak_over_model_bytes": (peak / model_bytes if on_card
                                         else "not measured"),
               "host_checked": {"leaf_spans": leaves, "elements": elements,
                                "host_s": time.perf_counter() - t0}}
        del model
        if on_card:
            torch.cuda.empty_cache()
            require(peak < INIT_PEAK_LIMIT,
                    f"(K) {cfg.name}: init peak {peak} bytes")
        return row

    t_phase = time.perf_counter()
    # one chunk's draw alone: its peak is what INIT_CHUNK trades for speed
    if on_card:
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    n = INIT_CHUNK if full else edge
    draw_chunk = prng.truncated_normal(key, -2.0, 2.0, (n,), dev)
    if on_card:
        torch.cuda.synchronize()
    chunk = {"elements": n, "s": time.perf_counter() - t0}
    if on_card:
        peak = torch.cuda.max_memory_allocated() - held
        chunk.update(peak_bytes_less_held=peak,
                     peak_bytes_per_element=peak / n)
    del draw_chunk
    gentry, oentry = registry.get(LM_ARCH), registry.get("olmoe-1b-7b")
    gcfg = gentry.config if full else gentry.smoke()
    ocfg = oentry.config if full else oentry.smoke()
    if full:
        ocfg = dataclasses.replace(ocfg, n_repeats=BOUND_MOE_REPEATS)
    P, J = len(gcfg.prefix), len(gcfg.pattern)
    last = len(gcfg.all_blocks()) - 1
    rows = [draw(gcfg, lambda b, path: P <= b < P + J or b == last),
            draw(ocfg, lambda b, path: path.endswith("router"))]
    launches = {k: fn.launches for k, fn in counted.items()}
    require(not any(launches.values()),
            f"(K) the init launched a ported kernel: {launches}")
    rec = {"phase": "init", "card": card, "seed": INIT_SEED,
           "chunk": chunk, "edge_elements": edge,
           "checked": {"gemma2": "every leaf of the first pattern repeat "
                                 "and of the last block, embed's ends",
                       "olmoe": "every block's float32 router, embed's "
                                "and unembed's ends"},
           "configs": rows, "ported_kernel_launches": launches,
           "peak_limit_bytes": INIT_PEAK_LIMIT,
           "phase_wall_s": time.perf_counter() - t_phase}
    emit(rec)
    return rec


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    try:
        from repro_torch.kernels import build
    except ImportError as e:
        print(f"chip_smoke: the port's package is missing ({e})",
              file=sys.stderr)
        return 2
    # Inductor and Triton (phase i's flex_attention) cache inside build/
    for var, sub in (("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, str(build.BUILD_DIR / sub))
    import repro_torch.kernels as kernels_api
    from repro_torch import trace
    from repro_torch.core.floorline import WorkloadPoint, fit_floorline
    from repro_torch.core.guidance import floorline_layer_guidance
    from repro_torch.core.partitioner import (SimEvaluator,
                                              optimize_partitioning)
    from repro_torch.kernels.event_matmul.ops import (
        KernelWeights, _compact_indices_joint, _pad_to, block_activity,
        event_matmul, event_matmul2, event_matmul_packed, event_matmul_pair,
        event_matmul_pair_packed, pad_compact, weight_block_occupancy)
    from repro_torch.kernels.event_matmul.ops import (
        bind_launch as em_bind_launch)
    from repro_torch.kernels.event_matmul.ref import (bind_ref,
                                                      event_matmul2_ref,
                                                      event_matmul_ref)
    from repro_torch.kernels.flash_attn.ops import (bind_launch,
                                                    flash_attention)
    from repro_torch.kernels.flash_attn.ref import flash_attention_ref
    from repro_torch.kernels.neuron_epilogue.ops import neuron_epilogue
    from repro_torch.kernels.neuron_scan.ops import ssm_scan
    from repro_torch.kernels.sigma_delta.ops import (sigma_delta_encode,
                                                     window_cumsum,
                                                     window_reconstruct)
    from repro_torch.kernels.sigma_delta.ref import (sigma_delta_ref,
                                                     window_cumsum_ref,
                                                     window_reconstruct_ref)
    from repro_torch.configs import registry
    from repro_torch.neuromorphic import (DenseCompute, EventCompute,
                                          attention_probe, compile_network,
                                          excluded_params, fc_network,
                                          loihi2_like, lowering_spec,
                                          make_inputs, minimal_partition,
                                          network_from_numpy,
                                          ordered_mapping,
                                          precompute_pricing,
                                          random_mapping, simulate,
                                          strided_mapping)
    from repro_torch.neuromorphic.compute import _im2col, _patch_weights
    from repro_torch.neuromorphic.frontend import PROBE_ATOL
    from repro_torch.sparsity import SparsityProfile
    import numpy as np
    import torch.nn.functional as F
    # the recipes of the golden fixtures, shared with the tests
    sys.path.insert(0, str(ROOT / "tests"))
    from _torch_workloads import conv_specs

    dev = torch.device(DEVICE)
    card = gpu_name_and_limit()

    # ------------------------------------------------------------ (a) build
    t0 = time.perf_counter()
    build.load()
    build_s = time.perf_counter() - t0
    log = (build.BUILD_DIR / "build.log")
    ptxas = ([l.strip() for l in log.read_text().splitlines()
              if "registers" in l or "spill" in l] if log.exists() else [])
    emit({"phase": "build", "seconds": build_s,
          "library": build.library_path().name, "ptxas": ptxas,
          "card": card, "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # -------------------------------------------------------- (b) main path
    sizes = list(SLICE1_SIZES)
    T = SLICE1_T
    net = fc_network(sizes, weight_density=0.5, neuron_model="sd_relu",
                     seed=0, device=DEVICE)
    for layer in net.layers:
        layer.threshold = 0.05
    xs = make_inputs(sizes[0], density=0.1, steps=T, seed=1,
                     device=DEVICE)
    prof = loihi2_like()
    part = minimal_partition(net, prof)
    n_delta = len(net.layers) - 1          # every layer after an sd_relu one
    # a value and a counter launch per layer, one value-only launch for
    # each delta layer's base rows
    expect = {"event_matmul2": 2 * len(net.layers) + n_delta,
              "window_cumsum": n_delta}
    counters = {"event_matmul2": event_matmul2,
                "window_cumsum": window_cumsum}
    rec = recorder()
    walls = {}

    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_k = net.run_batch(xs, compute=rec)
    torch.cuda.synchronize()
    walls["run_batch"] = time.perf_counter() - t0
    per_run = {k: fn.launches for k, fn in counters.items()}
    t0 = time.perf_counter()
    rep = simulate(net, xs, prof, part, precomputed=run_k)
    walls["simulate"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pts = []
    for dens in (0.8, 0.5, 0.3, 0.1, 0.05):
        xs_d = make_inputs(sizes[0], dens, T, seed=2, device=DEVICE)
        r = simulate(net, xs_d, prof, compute=EventCompute(mode="kernel"))
        pts.append(WorkloadPoint(r.max_synops, r.max_acts, r.time_per_step,
                                 r.energy_per_step, label=f"d={dens}"))
    model = fit_floorline(pts)
    state = model.classify(WorkloadPoint(rep.max_synops, rep.max_acts,
                                         rep.time_per_step))
    walls["floorline"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    evaluator = SimEvaluator(net, xs, prof, compute="event")
    res = optimize_partitioning(net, prof, evaluator, max_iters=8)
    torch.cuda.synchronize()
    walls["greedy"] = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}

    outputs = run_k[0]
    require(tuple(outputs.shape) == (T, sizes[-1]), "output shape")
    require(bool(torch.isfinite(outputs).all()), "non-finite outputs")
    require(np.isfinite(rep.time_per_step) and rep.time_per_step > 0,
            "time_per_step")
    require(np.isfinite(rep.energy_per_step) and rep.energy_per_step > 0,
            "energy_per_step")
    require(per_run == expect, f"launches per run_batch {per_run} != "
                               f"{expect}")
    require(all(n > 0 for n in launches.values()), f"launches {launches}")
    speedup = res.history[0].time / res.report.time_per_step
    emit({"phase": "main_path", "sizes": sizes, "T": T,
          "partition": list(part.cores), "cores_used": part.total_cores,
          "time_per_step": rep.time_per_step,
          "energy_per_step": rep.energy_per_step,
          "bottleneck_stage": rep.bottleneck_stage,
          "floorline_state": state.value,
          "greedy_speedup": speedup, "greedy_iters": len(res.history),
          "greedy_partition": list(res.partition.cores),
          "greedy_evals": evaluator.n_evals,
          "launches_per_run_batch": per_run, "launches": launches,
          "wall_s": walls})

    # ------------------------- where one run_batch's time goes (profiler)
    emit({"phase": "profile", "what": "one run_batch, kernel mode, traced",
          **traced(lambda: net.run_batch(
              xs, compute=EventCompute(mode="kernel")))})

    # ------------------------------------------- (c) kernels vs plain, card
    t0 = time.perf_counter()
    kernel_cc, dense_cc = EventCompute(mode="kernel"), DenseCompute()
    max_err = {"event_matmul2": 0.0, "window_cumsum": 0.0}
    checks = 0

    def check_matmul(x, w, occ, what, mask_operand=False):
        """The joint kernel against its plain version: masks exactly, as
        float32 (the float32 instance) and as int8 (the int8 one)."""
        nonlocal checks
        M, N = x.shape[0], w.shape[1]
        ops = [(x, w)] + ([(x.to(torch.int8), w.to(torch.int8))]
                          if mask_operand else [])
        for xo, wo in ops:
            y = event_matmul2(xo, wo, occ)
            y_ref = event_matmul2_ref(_pad_to(xo, (TILE, TILE)),
                                      _pad_to(wo, (TILE, TILE)), occ,
                                      threshold=0.0, bm=TILE, bk=TILE,
                                      bn=TILE)[:M, :N]
            require(y.dtype == torch.float32, f"{what}: type {y.dtype}")
            if mask_operand:
                exact(y, y_ref, f"{what} ({xo.dtype})")
            else:
                max_err["event_matmul2"] = max(
                    max_err["event_matmul2"],
                    close(y, y_ref, PRE_RTOL, PRE_ATOL, what))
            checks += 1
        return y

    def check_forward(layer, x, m, msgs, what):
        nonlocal checks
        pre_k, macs_k, fetch_k = kernel_cc.forward(layer, x, m, msgs)
        pre_d, macs_d, fetch_d = dense_cc.forward(layer, x, m, msgs)
        exact(macs_k, macs_d, f"{what} macs")
        exact(fetch_k, fetch_d, f"{what} fetches_dense")
        close(pre_k, pre_d, PRE_RTOL, PRE_ATOL, f"{what} pre")
        checks += 1
        return pre_d

    # teacher-forced at the main path's operands
    for i, (layer, x, m, msgs) in enumerate(rec.calls):
        check_forward(layer, x, m, msgs, f"fc call {i} ({layer.name})")
        occ = weight_block_occupancy(layer.weights)
        check_matmul(x, layer.weights, occ, f"fc call {i} values")
        check_matmul(m, layer.w_mask, occ, f"fc call {i} counters",
                     mask_operand=True)
    for layer, xb in rec.bases:            # the value-only base rows
        close(kernel_cc.value_forward(layer, xb), xb @ layer.weights,
              PRE_RTOL, PRE_ATOL, f"{layer.name} base rows")
        checks += 1
    # the joint product in bfloat16, on fc0's operands
    fc0_layer, fc0_x, _, _ = next(c for c in rec.calls
                                  if c[0] is net.layers[0]
                                  and c[1].shape[0] == T)
    fc0_w = fc0_layer.weights
    fc0_occ = weight_block_occupancy(fc0_w)
    xb, wb = fc0_x.to(torch.bfloat16), fc0_w.to(torch.bfloat16)
    yb = event_matmul2(xb, wb, fc0_occ)
    require(yb.dtype == torch.bfloat16, f"bf16 joint: type {yb.dtype}")
    bf16_err = close(yb.float(), event_matmul2_ref(
        xb, wb, fc0_occ, threshold=0.0, bm=TILE, bk=TILE, bn=TILE,
        out_dtype=torch.bfloat16).float(), *EM_TOL["bfloat16"],
        "fc0 joint bfloat16")
    checks += 1
    for layer, x_in, acc in rec.deltas:
        bases, xwin, new_acc = window_reconstruct(x_in, acc, window=TILE)
        rb, rx, ra = window_reconstruct_ref(x_in, acc, window=TILE)
        exact(bases, rb, f"{layer.name} bases")
        exact(new_acc, ra, f"{layer.name} new_acc")
        max_err["window_cumsum"] = max(max_err["window_cumsum"], close(
            xwin, rx, WIN_RTOL, WIN_ATOL, f"{layer.name} window_cumsum"))
        checks += 1

    # a strided conv stack through im2col: 3x3 stride-2 convs on a 64x64x2
    # input, channels 16 / 32 / 64, T = 32
    rng = np.random.default_rng(7)
    specs, h, c_prev = [], 64, 2
    for i, c in enumerate((16, 32, 64)):
        wgt = rng.normal(0, 1 / np.sqrt(9 * c_prev),
                         (3, 3, c_prev, c)).astype(np.float32)
        wgt *= (rng.random(wgt.shape) < 0.6)
        specs.append(dict(name=f"conv{i}", kind="conv", weights=wgt,
                          stride=2, in_hw=(h, h)))
        h, c_prev = h // 2, c
    conv_net = network_from_numpy(specs, 64 * 64 * 2, device=DEVICE)
    cur = make_inputs(64 * 64 * 2, 0.3, 32, seed=8, device=DEVICE)
    for layer in conv_net.layers:
        m = (cur != 0).to(torch.float32)
        pre = check_forward(layer, cur, m, m.sum(dim=1), layer.name)
        kh, kw = layer.weights.shape[:2]
        oh, ow = layer.out_hw
        x4 = cur.reshape(32, layer.weights.shape[2], *layer.in_hw)
        wf, wfm, _ = _patch_weights(layer)
        occ = weight_block_occupancy(wf)
        pat = _im2col(x4, kh, kw, layer.stride, oh, ow)
        check_matmul(pat, wf, occ, f"{layer.name} im2col values")
        check_matmul((pat != 0).to(torch.float32), wfm, occ,
                     f"{layer.name} im2col counters", mask_operand=True)
        cur = torch.clamp_min(pre, 0.0)   # relu, no bias or gate

    # edge cases: ragged M/K/N, all-zero activation and weight tiles, (m, n)
    # pairs with cnt == 0, a quiet window and ragged T
    g = torch.Generator(device="cpu").manual_seed(11)
    x = torch.randn(300, 333, generator=g).to(dev)
    w = torch.randn(333, 270, generator=g).to(dev)
    x[:128] = 0.0                          # first m-block: cnt == 0
    x[128:256, 128:256] = 0.0              # one dead activation tile
    w[256:, :] = 0.0                       # last k-block of weights dead
    w[:, 128:256] = 0.0                    # a whole n-block dead: cnt == 0
    occ = weight_block_occupancy(w)
    _, active, _, _ = pad_compact(x, 0.0)
    _, cnt = _compact_indices_joint(active, occ)
    require(int((cnt == 0).sum()) >= 3, "edge case lost its cnt == 0 pairs")
    y = check_matmul(x, w, occ, "edge ragged values")
    require(bool((y[:128] == 0).all()) and bool((y[:, 128:256] == 0).all()),
            "cnt == 0 tiles are not exact zeros")
    check_matmul((x != 0).to(torch.float32), (w != 0).to(torch.float32),
                 occ, "edge ragged counters", mask_operand=True)
    zocc = torch.zeros_like(occ)
    require(bool((event_matmul2(x, w, zocc) == 0).all()),
            "all-unoccupied weights must give exact zeros")
    xd = torch.randn(300, 200, generator=g).to(dev)
    xd[128:256] = 0.0                      # a quiet window in the middle
    for T_edge in (300, 256):
        xe = xd[:T_edge]
        acc = torch.randn(200, generator=g).to(dev)
        bases, xwin, new_acc = window_reconstruct(xe, acc, window=TILE)
        rb, rx, ra = window_reconstruct_ref(xe, acc, window=TILE)
        require(bool((xwin[128:256] == 0).all()),
                "quiet window is not exact zeros")
        max_err["window_cumsum"] = max(max_err["window_cumsum"], close(
            xwin, rx, WIN_RTOL, WIN_ATOL, f"ragged T={T_edge} window"))
        exact(bases, rb, "ragged bases")
        checks += 1
    # tiles other than the kernel's 128 (bm = 64): the dead tiles of x
    # are zeroed, then the 128-tile product runs at threshold 0.  Rows
    # 64-127 of the first m-block hold only sub-threshold entries.
    x64 = fc0_x.clone()
    x64[64:128] = (0.01 * torch.randn((64, x64.shape[1]), generator=g)
                   ).clamp(-0.04, 0.04).to(dev)
    bm64 = {}
    for what, fn in (("1-D", lambda: event_matmul(
            x64, fc0_w, threshold=THETA, bm=64, bk=TILE)),
                     ("joint", lambda: event_matmul2(
            x64, fc0_w, torch.ones_like(fc0_occ), threshold=THETA, bm=64,
            bk=TILE, bn=TILE))):
        y64 = fn()
        y64_ref = event_matmul_ref(x64, fc0_w, threshold=THETA, bm=64,
                                   bk=TILE)
        require(bool((y64[64:128] == 0).all()),
                "bm = 64: a dead tile is not exact zeros")
        bm64[what] = close(y64, y64_ref, *EM_TOL["float32"],
                           f"bm = 64 {what}")
        checks += 1
    # two launches of each instance, bit for bit: fc0's operands (one
    # block per output tile) and whisper-base's fc2 at M = 448 (a split
    # k list)
    xw = torch.relu(torch.randn((448, 2048), generator=g)).to(dev)
    ww = (torch.randn((2048, 512), generator=g) / 2048 ** 0.5).to(dev)
    repeats = {}
    for shape, (xs_, ws_) in (("fc0", (fc0_x, fc0_w)),
                              ("whisper fc2, M 448", (xw, ww))):
        occ_ = weight_block_occupancy(ws_)
        for dt in (torch.float32, torch.bfloat16, torch.int8):
            xo, wo = ((xs_ != 0).to(dt), (ws_ != 0).to(dt)) \
                if dt == torch.int8 else (xs_.to(dt), ws_.to(dt))
            for kind, o in (("1-D", None), ("joint", occ_)):
                launch, out, _ = em_bind_launch(xo, KernelWeights(wo, o))
                build.check(launch(), f"{shape} {kind} {dt}")
                first = out.clone()
                build.check(launch(), f"{shape} {kind} {dt}")
                torch.cuda.synchronize()
                exact(out, first, f"{shape} {kind} {dt}: two launches")
                repeats[f"{shape} {kind} {str(dt)[6:]}"] = launch.splits
                checks += 1
    # a layer's two products in one library call (the bind kernel, then
    # each product): values and wire events that differ (the delta
    # path's), at whisper-base's values map (K = 8 x 1,500, copied to a
    # padded layout), its fc2 (read in place) and ragged edges; values
    # within the float32 tolerance, counts and recorded counters exact
    pair_copies = {}
    for M_, K_, N_ in ((448, 12000, 512), (448, 2048, 512), (447, 333, 270),
                       (1, 27, 130)):
        xp_ = torch.relu(torch.randn((M_, K_), generator=g))
        xp_[:, TILE:2 * TILE] = 0.0
        mp_ = (torch.rand((M_, K_), generator=g) < 0.2).to(torch.float32)
        wp_ = torch.randn((K_, N_), generator=g) / K_ ** 0.5
        wp_[:, TILE:2 * TILE] = 0.0
        occ_ = weight_block_occupancy(wp_)
        w8_ = (wp_ != 0).to(torch.int8)
        with trace.recording() as rec_p:
            y_, macs_ = event_matmul_pair_packed(
                xp_.to(dev), mp_.to(dev),
                KernelWeights(wp_.to(dev), occ_.to(dev)),
                KernelWeights(w8_.to(dev), occ_.to(dev)))
        b_ = bind_ref(xp_, mp_)
        what = f"pair call {M_}x{K_}x{N_}"
        max_err["event_matmul2"] = max(max_err["event_matmul2"], close(
            y_, event_matmul2_ref(_pad_to(xp_, (TILE, TILE)),
                                  _pad_to(wp_, (TILE, TILE)), occ_,
                                  threshold=0.0, bm=TILE, bk=TILE,
                                  bn=TILE)[:M_, :N_].to(dev),
            *EM_TOL["float32"], what))
        exact(macs_, event_matmul2_ref(
            _pad_to((mp_ != 0).to(torch.int8), (TILE, TILE)),
            _pad_to(w8_, (TILE, TILE)), occ_, threshold=0.0, bm=TILE,
            bk=TILE, bn=TILE, out_dtype=torch.float32)[:M_, :N_].to(dev),
            f"{what} counts")
        live_ = sum(int(_compact_indices_joint(a, occ_)[1].sum())
                    for a in (b_.active, b_.mask_active))
        require(rec_p.count("event_matmul2.live_tiles") == live_
                and rec_p.count("event_matmul.padded_copies") == b_.copies,
                f"{what}: recorded live tiles or padded copies")
        pair_copies[what] = b_.copies
        checks += 1
    torch.cuda.synchronize()
    emit({"phase": "kernels", "checks": checks, "max_abs_err": max_err,
          "bf16_joint_max_abs_err": bf16_err, "bm64_max_abs_err": bm64,
          "repeat_launches_bit_identical": repeats,
          "pair_call_padded_copies": pair_copies,
          "tolerances": {"pre": [PRE_RTOL, PRE_ATOL],
                         "window_cumsum": [WIN_RTOL, WIN_ATOL],
                         "bfloat16": list(EM_TOL["bfloat16"]),
                         "bm64": list(EM_TOL["float32"]),
                         "counters": "bit-identical"},
          "wall_s": time.perf_counter() - t0})

    # ---------------------------------------- (d) end to end against dense
    t0 = time.perf_counter()
    run_d = net.run_batch(xs, compute="dense")
    rep_d = simulate(net, xs, prof, part, precomputed=run_d)
    rel_t = abs(rep.time_per_step - rep_d.time_per_step) / rep_d.time_per_step
    rel_e = (abs(rep.energy_per_step - rep_d.energy_per_step)
             / rep_d.energy_per_step)
    msgs_diff = [int((a.msgs_out != b.msgs_out).sum())
                 for a, b in zip(run_k[1], run_d[1])]
    emit({"phase": "dense", "time_per_step": rep_d.time_per_step,
          "energy_per_step": rep_d.energy_per_step,
          "rel_diff_time": rel_t, "rel_diff_energy": rel_e,
          "msgs_out_differing_per_layer": msgs_diff,
          "msgs_out_total_per_layer":
              [int(c.msgs_out.sum()) for c in run_d[1]],
          "wall_s": time.perf_counter() - t0})
    require(rel_t <= REPORT_RTOL and rel_e <= REPORT_RTOL,
            f"event vs dense report differs: time {rel_t}, energy {rel_e}")

    # ----------------------------------------------------------- (e) times
    lib = build.load()
    stream = torch.cuda.current_stream().cuda_stream

    def matmul_bound(M: int, N: int, live, elt: int, out_elt: int,
                     rate: float, products: int) -> dict:
        """Bytes and operations of one block-sparse product, from this
        call's live (Mb, Nb, Kb) tile products: every operand tile some
        live product needs read once (``elt`` bytes an element), the
        activity and occupancy bytes, the (M, N) output written once
        (``out_elt`` bytes), and ``products`` multiply-adds per live MAC at
        ``rate`` (3 at the TF32 rate for 3xTF32).  Also the bound at the
        fp32 FMA rate (one multiply-add per MAC)."""
        mb, nb, kb = live.shape
        macs = TILE ** 3 * int(live.sum())
        nbytes = elt * TILE * TILE * (int(live.any(dim=1).sum())
                                      + int(live.any(dim=0).sum()))
        nbytes += out_elt * M * N + mb * kb + kb * nb
        t_bytes = nbytes / PEAK_BYTES_PER_S
        t_ops = 2 * products * macs / rate
        return {"bytes": nbytes, "ops": 2 * products * macs,
                "bound_ms": 1e3 * max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes > t_ops else "operations",
                "fp32_fma_bound_ms": 1e3 * max(
                    t_bytes, 2 * macs / PEAK_FP32_FLOPS)}

    def time_matmul(x, w, counter: bool, what: str, name: str) -> dict:
        """Launch-alone, wrapper, plain and library times of one
        event_matmul2 call, with its bounds from this call's live tiles.
        Values are float32 (3xTF32), counters int8 0/1 masks (int8 rate,
        float32 out); the library call is ``torch.matmul`` for values and
        ``torch._int_mm`` for counters (``torch.matmul`` of the float
        masks beside it).  A value launch's output is held to the float64
        product and the plain version (:func:`f32_product_errors`)."""
        live, xp, active, occ = live_tiles(x, w)
        wp = _pad_to(w, (TILE, TILE))
        if counter:
            x, w = (x != 0).to(torch.int8), (w != 0).to(torch.int8)
        kw = KernelWeights(w, occ)
        launch, y, _ = em_bind_launch(x, kw)
        M, N = x.shape[0], w.shape[1]
        row = {"what": what, "layer": name, "M": M, "K": x.shape[1],
               "N": N, "dtype": str(x.dtype)[6:],
               "live_tile_products": int(live.sum()),
               "tile_products": live.numel(), "splits": launch.splits,
               **matmul_bound(M, N, live, x.element_size(), 4,
                              PEAK_INT8_OPS if counter else PEAK_TF32_FLOPS,
                              1 if counter else 3),
               "method": "int8" if counter else "3xTF32",
               "ms": time_ms(launch),
               "wrapper_ms": time_ms(lambda: event_matmul2(x, w, occ)),
               "packed_wrapper_ms": time_ms(
                   lambda: event_matmul_packed(x, kw)),
               "plain_ms": time_ms(lambda: event_matmul2_ref(
                   _pad_to(x, (TILE, TILE)), _pad_to(w, (TILE, TILE)), occ,
                   threshold=0.0, bm=TILE, bk=TILE, bn=TILE))}
        if not counter:  # the output of the launches timed above
            torch.cuda.synchronize()
            row.update(f32_product_errors(y[:M, :N], x, w, occ,
                                          f"(e) {name}"))
        if counter and M > 16:
            x8, w8 = _pad_to(x, (TILE, TILE)), _pad_to(w, (TILE, TILE))
            row["library_ms"] = time_ms(lambda: torch._int_mm(x8, w8))
            row["library_call"] = "torch._int_mm"
            xf, wf = xp != 0, wp != 0
            xf, wf = xf.to(torch.float32), wf.to(torch.float32)
            row["matmul_f32_ms"] = time_ms(lambda: torch.matmul(xf, wf))
        else:
            row["library_ms"] = time_ms(lambda: torch.matmul(xp, wp))
            row["library_call"] = "torch.matmul"
        return row

    # every main-path launch: (value, counter) live share per forward call
    live_share = []
    for layer, x, m, _ in rec.calls:
        live_share.append([float(live_tiles(a, b)[0].float().mean())
                           for a, b in ((x, layer.weights),
                                        (m, layer.w_mask))])
    mm_rows = []
    layer, x, m, _ = max(rec.calls, key=lambda c: c[1].numel()
                         * c[0].weights.shape[1])
    mm_rows.append(time_matmul(x, layer.weights, False, "largest value",
                               layer.name))
    mm_rows.append(time_matmul(m, layer.w_mask, True, "largest counter",
                               layer.name))
    layer, x, _, _ = min(rec.calls, key=lambda c: (c[0].weights.shape[1],
                                                   -c[1].shape[0]))
    mm_rows.append(time_matmul(x, layer.weights, False, "narrowest layer",
                               layer.name))
    layer, xb = rec.bases[0]
    mm_rows.append(time_matmul(xb, layer.weights, False,
                               "base-row value launch", layer.name))
    widest = max(rec.deltas, key=lambda d: d[1].numel())[0]
    layer, x, _, _ = next(c for c in rec.calls
                          if c[0] is widest and c[1].shape[0] == T)
    xq = x.clone().reshape(T // TILE, TILE, -1)
    xq[1::2] = 0.0                         # windows 1, 3, 5, 7 quiet
    mm_rows.append(time_matmul(xq.reshape(T, -1), layer.weights, False,
                               "widest xwin, half its windows quiet",
                               layer.name))
    mm_rows.append(time_matmul(xw, ww, False, "whisper-base fc2 shape, "
                               "M = 448 (random operands, seed 11)",
                               "whisper fc2"))
    gh = torch.Generator().manual_seed(13)
    xh = torch.randn((SCAN_T, 2048), generator=gh).to(dev)
    wh = (torch.randn((2048, SCAN_VOCAB), generator=gh) / 2048 ** 0.5
          ).to(dev)
    mm_rows.append(time_matmul(xh, wh, False, "mamba2-1.3b head, "
                               "1,024 x 2,048 x 50,277 (random operands, "
                               "seed 13)", "mamba2 head"))
    del xh, wh
    mm = {"name": "event_matmul2", "route": "cuda",
          "source": "src/repro_torch/csrc/event_matmul.cu",
          "replaces": "src/repro/kernels/event_matmul/kernel.py:52",
          "launches": launches["event_matmul2"],
          "max_abs_err": max_err["event_matmul2"],
          "float64_max_abs_err": max(r.get("float64_max_abs_err", 0.0)
                                     for r in mm_rows)}
    mm.update({k: mm_rows[0][k] for k in ("ms", "plain_ms", "bound_ms",
                                          "bound_by", "library_ms",
                                          "fp32_fma_bound_ms", "method")})

    # window_cumsum at the main path's widest delta stream
    layer, x_in, _ = max(rec.deltas, key=lambda d: d[1].numel())
    x_in = x_in.contiguous()
    Tp, D = x_in.shape
    xw = x_in.reshape(Tp // TILE, TILE, D)
    lv = (xw != 0).any(dim=2).any(dim=1).to(torch.int32)
    n_lw = int(lv.sum())
    bytes_wc = 4 * (n_lw * TILE * D + Tp * D) + 4 * lv.numel()
    ops_wc = n_lw * TILE * D
    out_wc = torch.empty_like(x_in)
    t_bytes, t_ops = bytes_wc / PEAK_BYTES_PER_S, ops_wc / PEAK_FP32_FLOPS
    wc = {"name": "window_cumsum", "route": "cuda",
          "source": "src/repro_torch/csrc/window_cumsum.cu",
          "replaces": "src/repro/kernels/sigma_delta/kernel.py:37",
          "launches": launches["window_cumsum"],
          "max_abs_err": max_err["window_cumsum"],
          "ms": time_ms(lambda: lib.window_cumsum_launch(
              x_in.data_ptr(), lv.data_ptr(), out_wc.data_ptr(),
              Tp // TILE, D, TILE, stream)),
          "plain_ms": time_ms(lambda: window_cumsum_ref(x_in, lv,
                                                        window=TILE)),
          "bound_ms": 1e3 * max(t_bytes, t_ops),
          "bound_by": "bytes" if t_bytes > t_ops else "operations",
          "library_ms": time_ms(lambda: torch.cumsum(xw, dim=1))}
    shape_wc = {"T": Tp, "D": D, "window": TILE, "live_windows": n_lw,
                "windows": lv.numel(), "bytes": bytes_wc, "adds": ops_wc,
                "wrapper_ms": time_ms(lambda: window_cumsum(x_in, lv,
                                                            window=TILE)),
                "layer": layer.name}
    emit({"phase": "times", "card": card,
          "peaks": {"bytes_per_s": PEAK_BYTES_PER_S,
                    "fp32_flops_per_s": PEAK_FP32_FLOPS,
                    "tf32_flops_per_s": PEAK_TF32_FLOPS,
                    "int8_ops_per_s": PEAK_INT8_OPS,
                    "source": "NVIDIA H100 SXM data sheet"},
          "event_matmul2": mm_rows,
          "event_matmul2_live_share_per_call": live_share,
          "window_cumsum": shape_wc})

    # ---------------------------------------- (f) frontend at full width
    # fc0's teacher-forced operands and fc1's input delta stream, for the
    # public kernel API phases (j)-(l)
    fc0_call = next(c for c in rec.calls
                    if c[0] is net.layers[0] and c[1].shape[0] == T)
    fc1_delta = next(d for d in rec.deltas if d[0] is net.layers[1])
    del rec, run_k, run_d
    torch.cuda.empty_cache()
    kernels = {"event_matmul2": event_matmul2, "window_cumsum": window_cumsum,
               "flash_attn": flash_attention, "ssm_scan": ssm_scan,
               "neuron_epilogue": neuron_epilogue}
    T_W = 448                               # whisper's n_text_ctx
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    cn = compile_network("whisper-base", smoke=False, seq_len=T_W, seed=0,
                         device=DEVICE, verify_attention=True)
    torch.cuda.synchronize()
    compile_s = time.perf_counter() - t0
    cfg = cn.cfg
    require(cn.param_layer_nnz() + excluded_params(cfg) == cfg.param_count(),
            "whisper-base: param identity")
    xs_w = cn.inputs(T_W, seed=5)
    rec_w = recorder()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_w, cnt_w = cn.net.run_batch(xs_w, compute=rec_w)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches_f = {k: fn.launches for k, fn in kernels.items()}
    n_fc = len(cn.net.layers)
    expect_f = {"event_matmul2": 2 * n_fc, "window_cumsum": 0,
                "flash_attn": len(cn.attn_specs), "ssm_scan": 0,
                "neuron_epilogue": n_fc}
    require(n_fc == 97 and len(cn.attn_specs) == 18,
            f"whisper-base lowered to {n_fc} layers, "
            f"{len(cn.attn_specs)} attention sites")
    require(launches_f == expect_f,
            f"frontend launches {launches_f} != {expect_f}")
    require(tuple(out_w.shape) == (T_W, cfg.vocab_size), "frontend shape")
    require(bool(torch.isfinite(out_w).all()), "frontend: non-finite")
    for spec, c in zip(cn.specs, cnt_w):
        require(int(c.macs.to(torch.float64).sum())
                == T_W * spec.macs_per_token, f"{spec.name}: MACs")
    parity_f = glue_parity(cn.net, xs_w, EventCompute(mode="kernel"),
                           (out_w, cnt_w), "(f) whisper-base")
    t0 = time.perf_counter()
    _, cnt_wd = cn.net.run_batch(xs_w, compute="dense")
    torch.cuda.synchronize()
    dense_w_s = time.perf_counter() - t0
    for layer, a, b in zip(cn.net.layers, cnt_w, cnt_wd):
        for f in FIELDS:
            exact(getattr(a, f), getattr(b, f), f"{layer.name} {f}")
    profile_w = traced(lambda: cn.net.run_batch(
        xs_w, compute=EventCompute(mode="kernel")))
    # one library call a layer: only the 12 values maps of K = 8 x 1,500
    # copy their operands (both products), the other fanins read in place
    with trace.recording() as rec_copies:
        cn.net.run_batch(xs_w, compute=EventCompute(mode="kernel"))
    copies_w = rec_copies.count("event_matmul.padded_copies")
    require(copies_w == 24, f"whisper-base: {copies_w} padded copies a "
            f"stream, not 24")
    attn_share = {layer.name: [float(live_tiles(a, b)[0].float().mean())
                               for a, b in ((x, layer.weights),
                                            (m, layer.w_mask))]
                  for layer, x, m, _ in rec_w.calls
                  if layer.name.endswith((".scores", ".values"))}
    emit({"phase": "frontend", "arch": "whisper-base", "seq_len": T_W,
          "fc_layers": n_fc,
          "weight_entries": sum(l.n_weights for l in cn.net.layers),
          "synapses": sum(l.w_nnz for l in cn.net.layers),
          "attention_sites": len(cn.attn_specs),
          "compile_s": compile_s, "compile_includes": "host build of the "
          "weights, copy to the card, 18 attention probes",
          "run_batch_s": run_s, "dense_run_batch_s": dense_w_s,
          "tokens": T_W, "macs_per_token": cn.macs_per_token(),
          "launches": launches_f,
          "counters": "bit-identical to dense; MACs == T * macs_per_token",
          "peak_device_bytes": torch.cuda.max_memory_allocated(),
          "traced_run_batch": profile_w, "padded_copies": copies_w,
          "neuron_epilogue": {"against_the_eager_glue": "bit-identical",
                              **parity_f},
          "live_share_value_counter": attn_share})
    del cn, xs_w, rec_w, out_w, cnt_w, cnt_wd
    torch.cuda.empty_cache()

    # ------------------------------------- (g) pricing of compiled nets
    # and of the three fixtures under the committed trained profile
    t0 = time.perf_counter()
    priced = {}
    trained = SparsityProfile.load(PROFILE_PATH)

    def compiled(arch, act_density=None):
        def build():
            cs = compile_network(arch, seed=0, device=DEVICE,
                                 act_density=act_density)
            return cs.net, cs.inputs(4, seed=5)
        return build

    def fc_profile_sparse():
        n = fc_network([32, 48, 48, 24], weight_density=1.0, seed=11,
                       device=DEVICE)
        return (trained.apply(n, seed=17),
                make_inputs(32, 0.3, 8, seed=12, device=DEVICE))

    def conv_fc_profile_event():
        specs_g = conv_specs(seed=23, fc_out=12, mask_density=None)
        n = trained.apply(network_from_numpy(specs_g, 8 * 8 * 2,
                                             device=DEVICE), seed=19)
        return n, make_inputs(n.in_size, 0.3, 6, seed=24, device=DEVICE)

    for arch, fixture, builder in (
            ("gemma2-2b", "model_lm_gemma2", compiled("gemma2-2b")),
            ("mamba2-1.3b", "model_ssm_mamba2", compiled("mamba2-1.3b")),
            ("olmoe-1b-7b", "model_moe_olmoe", compiled("olmoe-1b-7b")),
            ("whisper-base", "model_encdec_whisper",
             compiled("whisper-base")),
            ("fc_profile_sparse", "fc_profile_sparse", fc_profile_sparse),
            ("conv_fc_profile_event", "conv_fc_profile_event",
             conv_fc_profile_event),
            ("gemma2-2b, trained profile", "model_lm_gemma2_profile",
             compiled("gemma2-2b", trained))):
        golden = json.loads((ROOT / "tests" / "golden"
                             / f"{fixture}.json").read_text())
        net_g, xs_s = builder()
        require(golden["steps"] == xs_s.shape[0], f"{fixture}: steps")
        n_ssm = sum(l.neuron_model == "ssm" for l in net_g.layers)
        require((n_ssm > 0) == (fixture == "model_ssm_mamba2"),
                f"{fixture}: {n_ssm} ssm state layers")
        ssm_scan.launches = neuron_epilogue.launches = 0
        require([r["name"] for r in golden["layers"]]
                == [l.name for l in net_g.layers], f"{fixture}: layers")
        reps, runs = {}, {}
        for mode, cc in (("kernel", EventCompute(mode="kernel")),
                         ("dense", DenseCompute())):
            run = net_g.run_batch(xs_s, compute=cc)
            runs[mode] = (cc, run)
            for row, c in zip(golden["layers"], run[1]):
                for f in FIELDS:
                    require(row[f] == int(getattr(c, f).to(torch.float64)
                                          .sum()),
                            f"{fixture} {mode} {row['name']} {f}")
            reps[mode] = simulate(net_g, xs_s, prof, precomputed=run)
        # one scan a state layer and run_batch, whatever the synaptic
        # backend
        require(ssm_scan.launches == 2 * n_ssm,
                f"{fixture}: {ssm_scan.launches} ssm_scan launches over two "
                f"run_batch, not 2 x {n_ssm}")
        # one neuron epilogue a layer and run_batch, either backend
        epilogues = neuron_epilogue.launches
        require(epilogues == 2 * len(net_g.layers),
                f"{fixture}: {epilogues} neuron_epilogue launches over two "
                f"run_batch, not 2 x {len(net_g.layers)}")
        parity = {mode: glue_parity(net_g, xs_s, cc, run,
                                    f"(g) {fixture} {mode}")
                  for mode, (cc, run) in runs.items()}
        rk, rd = reps["kernel"], reps["dense"]
        rel_t = abs(rk.time_per_step - rd.time_per_step) / rd.time_per_step
        rel_e = (abs(rk.energy_per_step - rd.energy_per_step)
                 / rd.energy_per_step)
        require(rel_t <= REPORT_RTOL and rel_e <= REPORT_RTOL,
                f"{arch}: kernel vs dense report {rel_t}, {rel_e}")
        priced[arch] = {"fixture": fixture, "layers": len(net_g.layers),
                        "cores": rd.n_cores_active,
                        "time_per_step": rd.time_per_step,
                        "energy_per_step": rd.energy_per_step,
                        "bottleneck_stage": rd.bottleneck_stage,
                        "rel_diff_time": rel_t, "rel_diff_energy": rel_e,
                        "ssm_state_layers": n_ssm,
                        "ssm_scan_launches": ssm_scan.launches,
                        "neuron_epilogue_launches": epilogues,
                        "against_the_eager_glue": parity}
    emit({"phase": "pricing", "profile": prof.name, "archs": priced,
          "counters": "equal to tests/golden (all nine fixtures), kernel "
                      "and dense",
          "wall_s": time.perf_counter() - t0})

    # --------------------------------------------- (h) flash attention
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    flash_err, sites, probe_s = 0.0, {}, {}
    for arch, seq in (("whisper-base", 448), ("gemma2-2b", 8192)):
        _, attn = lowering_spec(registry.get(arch).config, seq_len=seq)
        t1 = time.perf_counter()
        for spec in attn:
            out, ref = attention_probe(spec, seed=0, device=DEVICE)
            require(bool(torch.isfinite(out).all()), f"{spec}: non-finite")
            err = close(out, ref, 0.0, PROBE_ATOL, f"{arch} {spec.name}")
            flash_err = max(flash_err, err)
            key = (f"{arch} S={spec.seq} H={spec.heads}/{spec.kv_heads} "
                   f"hd={spec.head_dim} causal={spec.causal} "
                   f"window={spec.window} softcap={spec.softcap}")
            row = sites.setdefault(key, {"sites": 0, "max_abs_err": 0.0})
            row["sites"] += 1
            row["max_abs_err"] = max(row["max_abs_err"], err)
        torch.cuda.synchronize()
        probe_s[arch] = time.perf_counter() - t1
    n_probes = sum(r["sites"] for r in sites.values())
    require(n_probes == 44, f"{n_probes} attention sites, not 18 + 26")
    gen = torch.Generator(device=dev).manual_seed(13)
    edges = {}

    def edge(what, B, Sq, Skv, H, K, hd, q_mul=1.0, float64=False, **kw):
        """The kernel against its plain version on random q (times q_mul),
        k and v; with float64 (non-causal, no cap, H == K), both against
        softmax attention in float64 too."""
        nonlocal flash_err
        q = q_mul * torch.randn((B, Sq, H, hd), generator=gen, device=dev)
        k = torch.randn((B, Skv, K, hd), generator=gen, device=dev)
        v = torch.randn((B, Skv, K, hd), generator=gen, device=dev)
        out = flash_attention(q, k, v, **kw)
        require(bool(torch.isfinite(out).all()), f"{what}: non-finite")
        plain = flash_attention_ref(q, k, v, **kw)
        err = close(out, plain, 0.0, PROBE_ATOL, what)
        flash_err = max(flash_err, err)
        edges[what] = {"B": B, "Sq": Sq, "Skv": Skv, "H": H, "K": K,
                       "hd": hd, "q_mul": q_mul, **kw, "max_abs_err": err}
        if float64:
            s64 = torch.einsum("bqhd,bkhd->bhqk", q.double(),
                               k.double()) / hd ** 0.5
            o64 = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s64, -1),
                               v.double())
            edges[what].update(
                kernel_vs_float64=(out.double() - o64).abs().max().item(),
                plain_vs_float64=(plain.double() - o64).abs().max().item())

    edge("window that bites", 1, 8192, 8192, 8, 4, 256, causal=True,
         window=4096, softcap=50.0)
    edge("ragged Sq != Skv, padded keys", 1, 300, 1000, 8, 2, 64,
         causal=False)
    edge("recurrentgemma GQA 10/1", 1, 4096, 4096, 10, 1, 256, causal=True,
         window=2048)
    edge("hd 112 (kimi-k2 heads)", 1, 1000, 1000, 64, 8, 112, causal=True)
    edge("B = 2", 2, 1500, 1500, 8, 8, 64, causal=False)
    # scores of std 4, as trained attention has: a one-pass TF32 kernel
    # misses the plain version here by ~3e-3 (tests/test_torch_flash.py)
    edge("peaked scores (whisper encoder, q x 4, no cap)", 1, 1500, 1500, 8,
         8, 64, q_mul=4.0, float64=True, causal=False)
    edge("hd 36 (k steps zero-filled)", 1, 1000, 1000, 8, 2, 36, causal=True)
    edge("hd 3 (under one 16-byte chunk a row)", 1, 500, 700, 4, 4, 3,
         causal=False)
    edge("ragged Sq = Skv = 1000, non-causal", 1, 1000, 1000, 8, 8, 64,
         causal=False)
    torch.cuda.synchronize()
    launches_h = flash_attention.launches
    require(launches_h == n_probes + len(edges),
            f"flash launches {launches_h} != {n_probes} + {len(edges)}")
    emit({"phase": "attention", "probes": n_probes, "sites": sites,
          "probe_s": probe_s, "edge_cases": edges, "launches": launches_h,
          "max_abs_err": flash_err, "atol": PROBE_ATOL,
          "wall_s": time.perf_counter() - t0})

    # ---------------------------------------------- (i) flash times
    def library_attention(q, k, v, causal, softcap):
        """One PyTorch call computing the same attention, as (name, call):
        scaled_dot_product_attention, or, for a tanh softcap, which it
        lacks, flex_attention compiled by Inductor with the cap as its
        score_mod and a causal block mask."""
        qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
        if softcap is None:
            return "scaled_dot_product_attention", lambda: (
                F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
                .transpose(1, 2))
        from torch.nn.attention.flex_attention import (create_block_mask,
                                                       flex_attention)
        mask = (create_block_mask(lambda b, h, i, j: i >= j, None, None,
                                  q.shape[1], k.shape[1], device=dev)
                if causal else None)

        def cap(s, b, h, i, j):
            return softcap * torch.tanh(s / softcap)
        flex = torch.compile(flex_attention, dynamic=False)
        return "flex_attention (torch.compile)", lambda: flex(
            qt, kt, vt, score_mod=cap, block_mask=mask,
            enable_gqa=q.shape[2] != k.shape[2]).transpose(1, 2)

    def time_flash(what, B, S, H, K, hd, causal, softcap, reps):
        """Launch-alone, wrapper, plain and library times of one attention
        call, with its bound: q, k, v read once, o written once, and
        4 * hd flops per live (query, key) pair per head."""
        g = torch.Generator(device=dev).manual_seed(17)
        q = torch.randn((B, S, H, hd), generator=g, device=dev)
        k = torch.randn((B, S, K, hd), generator=g, device=dev)
        v = torch.randn((B, S, K, hd), generator=g, device=dev)
        kw = dict(causal=causal, softcap=softcap)
        launch, out = bind_launch(q, k, v, **kw)
        build.check(launch(), "flash_attn")
        plain = flash_attention_ref(q, k, v, **kw)
        exact(out[:, :S], flash_attention(q, k, v, **kw), f"{what} launch")
        name, library = library_attention(q, k, v, causal, softcap)
        t1 = time.perf_counter()
        lib_err = close(library(), plain, 0.0, PROBE_ATOL, f"{what} {name}")
        torch.cuda.synchronize()
        lib_first_s = time.perf_counter() - t1
        del plain
        live = S * (S + 1) // 2 if causal else S * S
        flops = 4 * B * H * hd * live
        nbytes = 4 * (2 * B * S * H * hd + 2 * B * S * K * hd)
        # 3xTF32: three TF32 products per multiply-add
        t_bytes, t_ops = (nbytes / PEAK_BYTES_PER_S,
                          3 * flops / PEAK_TF32_FLOPS)
        return {"what": what, "B": B, "S": S, "H": H, "K": K, "hd": hd,
                "causal": causal, "softcap": softcap, "bytes": nbytes,
                "flops": flops, "live_pairs_per_head": live,
                "method": "3xTF32",
                "fp32_fma_bound_ms": 1e3 * max(t_bytes,
                                               flops / PEAK_FP32_FLOPS),
                "ms": time_ms(launch, reps),
                "wrapper_ms": time_ms(lambda: flash_attention(q, k, v, **kw),
                                      reps),
                "plain_ms": time_ms(lambda: flash_attention_ref(q, k, v,
                                                                **kw), reps),
                "bound_ms": 1e3 * max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes > t_ops else "operations",
                "library_ms": time_ms(library, reps), "library_call": name,
                "library_max_abs_err": lib_err,
                "library_first_call_s": lib_first_s}

    fa_rows = [time_flash("whisper encoder site", 1, 1500, 8, 8, 64, False,
                          None, 20),
               time_flash("whisper decoder self-attention site", 1, 448, 8,
                          8, 64, True, None, 20),
               time_flash("gemma2 global site", 1, 8192, 8, 4, 256, True,
                          50.0, 3)]
    emit({"phase": "times_flash", "card": card, "flash_attn": fa_rows,
          "ptxas": flash_ptxas(build.BUILD_DIR / "build.log")})
    fa = {"name": "flash_attn", "route": "cuda",
          "source": "src/repro_torch/csrc/flash_attn.cu",
          "replaces": "src/repro/kernels/flash_attn/kernel.py:29",
          "launches": launches_f["flash_attn"], "max_abs_err": flash_err}
    fa.update({k: fa_rows[0][k] for k in ("ms", "plain_ms", "bound_ms",
                                          "bound_by", "library_ms",
                                          "fp32_fma_bound_ms", "method")})

    # ------------------------------- (j) the public kernel API, driven
    # The reference's public entry point (repro.kernels) on the slice-1
    # cell's own streams: sigma-delta encode fc0's activations against the
    # state one step behind, then the event-driven products of the
    # messages (values and counters) with fc1's weights, and fc0's own
    # product, without weight-tile occupancy (the 1-D kernel).
    layer0, x0, m0, _ = fc0_call
    layer1, d1, acc1 = fc1_delta
    a_fc0 = acc1[None, :] + torch.cumsum(d1, dim=0)     # (T, 2048)
    s_fc0 = torch.cat([torch.zeros_like(a_fc0[:1]), a_fc0[:-1]])
    api = {"event_matmul2": event_matmul2, "window_cumsum": window_cumsum,
           "flash_attn": flash_attention, "event_matmul": event_matmul,
           "sigma_delta_encode": sigma_delta_encode}
    for fn in api.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    q_fc0, s_new = kernels_api.sigma_delta_encode(a_fc0, s_fc0, theta=THETA)
    y_q, macs_q = kernels_api.event_matmul_pair(
        q_fc0, (q_fc0 != 0).to(torch.float32), layer1.weights,
        layer1.w_mask)
    y_x0 = kernels_api.event_matmul(x0, layer0.weights)
    torch.cuda.synchronize()
    api_s = time.perf_counter() - t0
    launches_j = {k: fn.launches for k, fn in api.items()}
    expect_j = {"event_matmul2": 0, "window_cumsum": 0, "flash_attn": 0,
                "event_matmul": 3, "sigma_delta_encode": 1}
    require(launches_j == expect_j,
            f"kernel API launches {launches_j} != {expect_j}")
    n_msgs = int((q_fc0 != 0).sum())
    require(0 < n_msgs < q_fc0.numel(), "sigma-delta messages: none or all")
    exact(macs_q, (q_fc0 != 0).to(torch.float32) @ layer1.w_mask,
          "API counters vs dense")
    for v in (q_fc0, s_new, y_q, y_x0):
        require(bool(torch.isfinite(v).all()), "kernel API: non-finite")
    emit({"phase": "kernel_api", "entry": "repro_torch.kernels",
          "calls": ["sigma_delta_encode(fc0 activations, state one step "
                    "behind, theta=0.05)",
                    "event_matmul_pair(messages, fc1 weights), no w_occ",
                    "event_matmul(fc0 input, fc0 weights), no w_occ"],
          "shapes": {"a": list(a_fc0.shape), "fc1_w": list(
              layer1.weights.shape), "fc0_x": list(x0.shape)},
          "messages": n_msgs, "message_density": n_msgs / q_fc0.numel(),
          "launches": launches_j, "wall_s": api_s,
          "counters": "bit-identical to dense"})

    # -------------------------------- (k) kernels 3 and 4 vs plain, card
    t0 = time.perf_counter()
    em_err = {"float32": 0.0, "bfloat16": 0.0}
    rng = np.random.default_rng(21)
    keep = torch.as_tensor(rng.random((T // TILE, sizes[0] // TILE)) < 0.25,
                           device=dev)
    x_q = x0 * keep.repeat_interleave(TILE, 0).repeat_interleave(TILE, 1)
    gw = torch.Generator(device=dev).manual_seed(23)
    em_cases = {"fc0 float32, all live": (x0, layer0.weights),
                "fc0 float32, 25% live": (x_q, layer0.weights),
                "fc0 bfloat16, 25% live": (x_q.to(torch.bfloat16),
                                           layer0.weights.to(
                                               torch.bfloat16)),
                "whisper-base fc2 shape, M = 448, float32": (
                    torch.relu(torch.randn((448, 2048), generator=gw,
                                           device=dev)),
                    torch.randn((2048, 512), generator=gw, device=dev)
                    / 2048 ** 0.5)}
    em_rows = {}
    # phase (j)'s value product: fc1's shape on the encoded message stream
    em_err["float32"] = close(y_q, event_matmul_ref(
        _pad_to(q_fc0, (TILE, TILE)), _pad_to(layer1.weights, (TILE, TILE)),
        threshold=0.0, bm=TILE, bk=TILE)[:q_fc0.shape[0],
                                         :layer1.weights.shape[1]],
        *EM_TOL["float32"], "kernel API fc1 pair values")
    em_rows["fc1 pair (sigma-delta messages)"] = {
        "max_abs_err": em_err["float32"],
        "live_tile_share": float(block_activity(q_fc0, 0.0).float().mean())}
    for what, (xc, wc_) in em_cases.items():
        yk = event_matmul(xc, wc_)
        yp = event_matmul_ref(_pad_to(xc, (TILE, TILE)),
                              _pad_to(wc_, (TILE, TILE)), threshold=0.0,
                              bm=TILE, bk=TILE)[:xc.shape[0], :wc_.shape[1]]
        require(yk.dtype == xc.dtype, f"{what}: output type {yk.dtype}")
        dt = "bfloat16" if xc.dtype == torch.bfloat16 else "float32"
        rt, at = EM_TOL[dt]
        err = close(yk, yp, rt, at, f"event_matmul {what}")
        em_err[dt] = max(em_err[dt], err)
        live = float(block_activity(xc, 0.0).float().mean())
        em_rows[what] = {"max_abs_err": err, "live_tile_share": live}
    # the 1-D pair on fc0's teacher-forced value and counter operands
    ones = torch.ones((sizes[0] // TILE, sizes[1] // TILE), dtype=torch.bool,
                      device=dev)
    y1, macs1 = event_matmul_pair(x0, m0, layer0.weights, layer0.w_mask)
    y2, macs2 = event_matmul_pair(x0, m0, layer0.weights, layer0.w_mask, ones)
    exact(macs1, m0 @ layer0.w_mask, "1-D pair counters vs dense")
    exact(macs1, macs2, "1-D pair counters vs event_matmul2")
    em_err["float32"] = max(em_err["float32"], close(
        y1, event_matmul_ref(x0, layer0.weights, threshold=0.0, bm=TILE,
                             bk=TILE), *EM_TOL["float32"],
        "1-D pair values"))
    em_rows["fc0 pair (teacher-forced)"] = {
        "counters": "bit-identical to dense m @ wm and to event_matmul2",
        "values_bit_identical_to_event_matmul2": bool(torch.equal(y1, y2))}
    # kernel 4: fc0's activation stream and whisper-base's widest map
    a_w = torch.relu(torch.randn((1500, 2048), generator=gw, device=dev))
    s_w = torch.cat([torch.zeros_like(a_w[:1]), a_w[:-1]])
    sd_cases = {"fc0 activations (1024, 2048) float32": (a_fc0, s_fc0),
                "whisper (1500, 2048) float32": (a_w, s_w),
                "whisper (1500, 2048) bfloat16": (a_w.to(torch.bfloat16),
                                                  s_w.to(torch.bfloat16))}
    sd_rows, sd_err = {}, 0.0
    for what, (ac, sc) in sd_cases.items():
        qk, sk = sigma_delta_encode(ac, sc, theta=THETA)
        qp, sp = sigma_delta_ref(ac, sc, theta=THETA)
        exact(qk, qp, f"sigma_delta {what} q")
        exact(sk, sp, f"sigma_delta {what} s'")
        sd_err = max(sd_err, *(float((k_.float() - p_.float()).abs().max())
                               for k_, p_ in ((qk, qp), (sk, sp))))
        nz = int((qk != 0).sum())
        require(0 < nz < qk.numel(), f"sigma_delta {what}: q all or none")
        sd_rows[what] = {"messages": nz, "density": nz / qk.numel()}
    torch.cuda.synchronize()
    emit({"phase": "kernels_api_check", "event_matmul": em_rows,
          "event_matmul_max_abs_err": em_err,
          "tolerances": {k: list(v) for k, v in EM_TOL.items()},
          "sigma_delta_encode": sd_rows,
          "sigma_delta_tolerance": "q and s' bit-identical",
          "sigma_delta_max_abs_err": sd_err,
          "wall_s": time.perf_counter() - t0})

    # ------------------------------------------ (l) kernel 3 and 4 times
    def time_em(what, x, w) -> dict:
        """Launch-alone, wrapper, plain and torch.matmul times of one 1-D
        event_matmul call, with its bounds from this call's live tiles
        (:func:`matmul_bound`: every n tile of a live activation tile is
        live; float32 by 3xTF32 at the TF32 rate, bfloat16 at its own).
        The wrapper lays the weights out per call; ``ms`` is the launch
        alone on weights laid out once."""
        xp, wp = _pad_to(x, (TILE, TILE)), _pad_to(w, (TILE, TILE))
        active = block_activity(xp, 0.0)
        nb = wp.shape[1] // TILE
        live = active[:, None, :].expand(-1, nb, -1)
        bf = x.dtype == torch.bfloat16
        launch, _, _ = em_bind_launch(x, KernelWeights(w))
        return {"what": what, "M": x.shape[0], "K": x.shape[1],
                "N": w.shape[1], "dtype": str(x.dtype).split(".")[-1],
                "live_tiles": int(active.sum()), "tiles": active.numel(),
                "splits": launch.splits,
                **matmul_bound(x.shape[0], w.shape[1], live,
                               x.element_size(), x.element_size(),
                               PEAK_BF16_FLOPS if bf else PEAK_TF32_FLOPS,
                               1 if bf else 3),
                "method": "bf16" if bf else "3xTF32",
                "ms": time_ms(launch),
                "cold_l2_ms": time_ms_cold(launch),
                "wrapper_ms": time_ms(lambda: event_matmul(x, w)),
                "plain_ms": time_ms(lambda: event_matmul_ref(
                    xp, wp, threshold=0.0, bm=TILE, bk=TILE)),
                "library_ms": time_ms(lambda: torch.matmul(xp, wp)),
                "library_call": "torch.matmul"}

    def time_sd(what, a, s) -> dict:
        """Launch-alone, wrapper and plain times of one sigma_delta_encode
        call, with its bound: a and s read once, q and s' written once,
        six operations per element at the fp32 rate.  No single PyTorch
        call computes the encoder, so there is no library time.  ``ms`` is
        the launch with a cold L2: back to back, a working set under 50 MB
        stays in L2 and the warm time (``warm_l2_ms``) can beat the HBM
        bound."""
        q, so = torch.empty_like(a), torch.empty_like(s)
        n = a.numel()
        nbytes = 4 * n * a.element_size()
        ops = 6 * n
        t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_FP32_FLOPS
        bf = int(a.dtype == torch.bfloat16)

        def launch():
            return lib.sigma_delta_launch(a.data_ptr(), s.data_ptr(),
                                          q.data_ptr(), so.data_ptr(), n,
                                          THETA, bf, stream)
        return {"what": what, "shape": list(a.shape),
                "dtype": str(a.dtype).split(".")[-1], "bytes": nbytes,
                "ops": ops, "ms": time_ms_cold(launch),
                "warm_l2_ms": time_ms(launch),
                "wrapper_ms": time_ms(lambda: sigma_delta_encode(
                    a, s, theta=THETA)),
                "plain_ms": time_ms(lambda: sigma_delta_ref(a, s,
                                                            theta=THETA)),
                "bound_ms": 1e3 * max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes > t_ops else "operations",
                "library_ms": None,
                "library_call": "none: no single PyTorch call computes the "
                                "fused encoder"}

    em_times = [time_em(w, *em_cases[w]) for w in em_cases]
    sd_times = [time_sd(w, *sd_cases[w]) for w in sd_cases]
    emit({"phase": "times_api", "card": card,
          "peaks": {"bytes_per_s": PEAK_BYTES_PER_S,
                    "fp32_flops_per_s": PEAK_FP32_FLOPS,
                    "tf32_flops_per_s": PEAK_TF32_FLOPS,
                    "bf16_flops_per_s": PEAK_BF16_FLOPS,
                    "source": "NVIDIA H100 SXM data sheet"},
          "event_matmul": em_times, "sigma_delta_encode": sd_times})
    em1 = {"name": "event_matmul", "route": "cuda",
           "source": "src/repro_torch/csrc/event_matmul.cu",
           "replaces": "src/repro/kernels/event_matmul/kernel.py:33",
           "launches": launches_j["event_matmul"],
           "max_abs_err": em_err["float32"]}
    em1.update({k: em_times[0][k] for k in ("ms", "plain_ms", "bound_ms",
                                            "bound_by", "library_ms",
                                            "fp32_fma_bound_ms", "method")})
    sdk = {"name": "sigma_delta_encode", "route": "cuda",
           "source": "src/repro_torch/csrc/sigma_delta.cu",
           "replaces": "src/repro/kernels/sigma_delta/kernel.py:27",
           "launches": launches_j["sigma_delta_encode"],
           "max_abs_err": sd_err}
    sdk.update({k: sd_times[0][k] for k in ("ms", "plain_ms", "bound_ms",
                                            "bound_by", "library_ms")})

    # ----------------------- (m) population pricing at the slice-1 cell
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_p = net.run_batch(xs, compute=EventCompute(mode="kernel"))
    torch.cuda.synchronize()
    run_p_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cache = precompute_pricing(net, xs, prof, precomputed=run_p)
    torch.cuda.synchronize()
    cache_s = time.perf_counter() - t0
    parts = [part]
    for h in res.history:
        if h.partition not in parts:
            parts.append(h.partition)
    rng = np.random.default_rng(31)
    cands = [(p_, mk(p_, prof)) for p_ in parts
             for mk in (ordered_mapping, strided_mapping)]
    while len(cands) < K_POP:
        p_ = parts[len(cands) % len(parts)]
        cands.append((p_, random_mapping(p_, prof, rng)))
    ev_np = SimEvaluator(net, xs, prof, cache=cache)
    ev_dev = SimEvaluator(net, xs, prof, cache=cache,
                          population_backend="device")
    torch.cuda.reset_peak_memory_stats()
    pop_s = {}
    t0 = time.perf_counter()
    r_np = ev_np.evaluate_population(cands)
    torch.cuda.synchronize()
    pop_s["numpy"] = time.perf_counter() - t0
    peak_np = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    r_dev = ev_dev.evaluate_population(cands)
    torch.cuda.synchronize()
    pop_s["device_first"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    r_dev = ev_dev.evaluate_population(cands)
    torch.cuda.synchronize()
    pop_s["device"] = time.perf_counter() - t0
    peak_dev = torch.cuda.max_memory_allocated()
    require(ev_np.n_evals == K_POP and ev_dev.n_evals == 2 * K_POP,
            f"evaluations {ev_np.n_evals}, {ev_dev.n_evals}")
    require(ev_dev.demotions == [] and ev_dev.active_backend == "device",
            f"device pricing demoted: {ev_dev.demotions}")
    pop_err = reports_close(r_dev, r_np, POP_RTOL)
    spot = np.linspace(0, K_POP - 1, 16).astype(int)
    for i in spot:
        p_, m_ = cands[i]
        same = simulate(net, xs, prof, p_, m_, precomputed=run_p)
        require(reports_identical(r_np[i], same),
                f"candidate {i}: numpy backend is not simulate's bits")
    emit({"phase": "population", "candidates": K_POP,
          "partitions": [list(p_.cores) for p_ in parts],
          "mappings": "ordered and strided for each partition, the rest "
                      "random (numpy seed 31)",
          "functional_run_s": run_p_s, "cache_build_s": cache_s,
          "wall_s": pop_s,
          "candidates_per_s": {k: K_POP / v for k, v in pop_s.items()},
          "peak_device_bytes": {"numpy": peak_np, "device": peak_dev},
          "device_vs_numpy_max_rel_err": pop_err, "rtol": POP_RTOL,
          "simulate_bit_identical": len(spot),
          "n_evals": {"numpy": ev_np.n_evals, "device": ev_dev.n_evals},
          "best_time_per_step": min(r.time_per_step for r in r_np)})

    # ----------------------------------- (n) guidance at the slice-1 cell
    t0 = time.perf_counter()
    guide = {}
    for what, (p_, m_) in (("minimal, ordered", (part, None)),
                           ("greedy result", (res.partition, res.mapping))):
        gs = floorline_layer_guidance(net, xs, prof, p_, m_, cache=cache)
        w_ = np.array([g.weight for g in gs])
        require(np.isfinite(w_).all() and abs(w_.mean() - 1.0) < 1e-9,
                f"guidance weights {w_}")
        guide[what] = [{"layer": g.name, "state": g.state.value,
                        "weight": g.weight, "mem_time": g.stage.mem_time,
                        "act_time": g.stage.act_time,
                        "traffic_time": g.stage.traffic_time}
                       for g in gs]
    emit({"phase": "guidance", "layers": guide,
          "wall_s": time.perf_counter() - t0})

    # ------------- (o)-(q) trained profile, search, resume at the cell
    del cache, run_p, ev_np, ev_dev, r_np, r_dev
    torch.cuda.empty_cache()
    pnet, pcache, pgreedy = search_phases(net, xs, prof,
                                 ckpt_root=build.BUILD_DIR / "ckpt",
                                 expect_launches=expect, card=card)

    # --------- (u)-(w) sparsity-aware training and the iso-accuracy loop
    torch.cuda.empty_cache()
    training_phases(device=DEVICE, card=card,
                    ckpt_root=build.BUILD_DIR / "ckpt" / "train")

    # ---------------- (x)-(z) the model and serving stack at full width
    torch.cuda.empty_cache()
    serve_x = serve_phases(device=DEVICE, card=card)

    # ------------------ (A)-(D) training of the LM stack at full width
    torch.cuda.empty_cache()
    lm_a = lm_train_phases(device=DEVICE, card=card,
                           ckpt_root=build.BUILD_DIR / "ckpt" / "lm")

    # -------------- (E)-(F) the step's bound and the one-card dry-run
    torch.cuda.empty_cache()
    step_bound_phases(device=DEVICE, card=card, lm_a=lm_a)
    dryrun_phases(card=card)

    # ------------ (G)-(H) EventCompute's options, the vmap population
    torch.cuda.empty_cache()
    event_options_phase(device=DEVICE, card=card)
    vmap_pricing_phase(pnet, xs, prof, cache=pcache, cands=cands, card=card)

    # ---------------- (I) the data-parallel half over a one-rank group
    torch.cuda.empty_cache()
    data_parallel_phases(
        device=DEVICE, card=card, ckpt_root=build.BUILD_DIR / "ckpt" / "dp",
        lm_a=lm_a, islands_ctx=dict(
            pnet=pnet, xs=xs, chip=prof, cache=pcache, greedy=pgreedy,
            search=SEARCH, islands=ISLANDS,
            phase_s_dir=build.BUILD_DIR / "ckpt" / "r" / "islands"))

    # ------------- (J) tensor parallelism over a one-rank model group
    torch.cuda.empty_cache()
    tensor_parallel_phases(device=DEVICE, card=card,
                           ckpt_root=build.BUILD_DIR / "ckpt" / "tp",
                           serve_x=serve_x)

    # ------------------ (K) the weights from the reference's key
    torch.cuda.empty_cache()
    init_phase(device=DEVICE, card=card)

    # ----------------------------- (L) the ssm state neurons' scan
    ns = neuron_scan_phase(card=card)
    ne = neuron_epilogue_phase(card=card)
    ne["launches"] = ns["cell_epilogue_launches"]

    emit({"kernels": [mm, wc, fa, em1, sdk, ns, ne]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
