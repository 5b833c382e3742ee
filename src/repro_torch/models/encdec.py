"""Encoder-decoder configuration (whisper-base).

The audio frontend (log-mel + conv downsampling) is a stub: the encoder
sees ``n_frames`` precomputed frame embeddings.  Only the configuration
lives here; the model-zoo frontend lowers it onto the simulator.
"""

from __future__ import annotations

import dataclasses

from repro_torch.models.common import ModelCfg


@dataclasses.dataclass(frozen=True)
class EncDecCfg:
    name: str
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    vocab_size: int
    d_ff: int
    n_enc_layers: int
    n_dec_layers: int
    n_frames: int = 1500
    act_fn: str = "gelu"
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    remat: str = "block"

    @property
    def mc(self) -> ModelCfg:
        """Inner ModelCfg view of the shared attention/MLP widths."""
        return ModelCfg(
            name=self.name, d_model=self.d_model, n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads, head_dim=self.head_dim,
            vocab_size=self.vocab_size, act_fn=self.act_fn,
            rope_theta=self.rope_theta, norm_eps=self.norm_eps,
            tie_embeddings=True, param_dtype=self.param_dtype,
            compute_dtype=self.compute_dtype)

    @property
    def n_layers(self) -> int:
        return self.n_enc_layers + self.n_dec_layers

    def param_count(self) -> int:
        d, ff = self.d_model, self.d_ff
        attn = d * (self.n_heads + 2 * self.n_kv_heads) * self.head_dim \
            + self.n_heads * self.head_dim * d
        enc = self.n_enc_layers * (attn + 3 * d * ff + 2 * d)
        dec = self.n_dec_layers * (2 * attn + 3 * d * ff + 3 * d)
        return self.vocab_size * d + enc + dec + 2 * d
