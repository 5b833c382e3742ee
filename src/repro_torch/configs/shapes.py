"""Shape cells and abstract input specs (PyTorch port of
``repro.configs.shapes``).

Each architecture is paired with its own shape set:

  train_4k     seq_len=4096    global_batch=256   -> a train step
  prefill_32k  seq_len=32768   global_batch=32    -> prefill
  decode_32k   seq_len=32768   global_batch=128   -> a serve step
                                                      (1 token, 32k KV cache)
  long_500k    seq_len=524288  global_batch=1     -> a serve step; only for
                                                      sub-quadratic archs

``input_specs`` returns :class:`TensorSpec` stand-ins (a shape and a
``torch.dtype``; the reference's ``jax.ShapeDtypeStruct``): nothing is
allocated.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.common import ModelCfg


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # "train" | "prefill" | "decode"


TRAIN_4K = ShapeSpec("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeSpec("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeSpec("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeSpec("long_500k", 524_288, 1, "decode")

FULL_ATTN_SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K)}
SUBQUAD_SHAPES = {s.name: s
                  for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    shape: tuple[int, ...]
    dtype: torch.dtype


def sds(shape, dtype: torch.dtype) -> TensorSpec:
    return TensorSpec(tuple(shape), dtype)


def lm_input_specs(cfg: ModelCfg, shape: ShapeSpec,
                   microbatch: int | None = None) -> dict:
    """Abstract inputs for a decoder-only LM cell.

    train/prefill: {"tokens", "labels"[, "frontend_embeds"]}
    decode:        {"tokens" (B, 1), "pos" scalar}.
    """
    B = microbatch or shape.global_batch
    S = shape.seq_len
    if shape.kind == "decode":
        return {"tokens": sds((B, 1), torch.int32),
                "pos": sds((), torch.int32)}
    specs = {}
    F = cfg.frontend_tokens if cfg.frontend != "none" else 0
    if F:
        specs["frontend_embeds"] = sds((B, F, cfg.d_model), torch.bfloat16)
    specs["tokens"] = sds((B, S - F), torch.int32)
    specs["labels"] = sds((B, S), torch.int32)
    return specs


def encdec_input_specs(cfg, shape: ShapeSpec,
                       microbatch: int | None = None) -> dict:
    B = microbatch or shape.global_batch
    S = shape.seq_len
    if shape.kind == "decode":
        return {"tokens": sds((B, 1), torch.int32),
                "pos": sds((), torch.int32)}
    return {"frontend_embeds": sds((B, cfg.n_frames, cfg.d_model),
                                   torch.bfloat16),
            "tokens": sds((B, S), torch.int32),
            "labels": sds((B, S), torch.int32)}
