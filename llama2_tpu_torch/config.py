"""Model and generation configuration.

Mirrors the reference's ``Config`` struct (main.zig:40-49): seven integers read
from the llama2.c checkpoint header. A copy of ``llama2_tpu/config.py``: the
torch package imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The seven-field llama2.c model config (main.zig:17-25).

    ``head_size = dim // n_heads``; GQA/MQA when ``n_kv_heads < n_heads``
    (group factor ``n_heads // n_kv_heads``, main.zig:291).
    """

    dim: int
    hidden_dim: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    vocab_size: int
    seq_len: int
    # rmsnorm epsilon: 1e-5 in llama2.c/the reference (main.zig:452-454);
    # HF Llama checkpoints carry their own (usually 1e-6 or 1e-5) — set by
    # the importer. Not part of the v0 header, so not serialized to .bin.
    norm_eps: float = 1e-5

    @property
    def head_size(self) -> int:
        return self.dim // self.n_heads

    @property
    def kv_dim(self) -> int:
        return (self.dim * self.n_kv_heads) // self.n_heads

    @property
    def kv_groups(self) -> int:
        """Query heads per KV head (``kv_mul`` in the reference, main.zig:291)."""
        return self.n_heads // self.n_kv_heads

    def __post_init__(self):
        if self.dim % self.n_heads != 0:
            raise ValueError(f"dim={self.dim} not divisible by n_heads={self.n_heads}")
        if self.n_heads % self.n_kv_heads != 0:
            raise ValueError(
                f"n_heads={self.n_heads} not divisible by n_kv_heads={self.n_kv_heads}"
            )


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    """Sampling and loop parameters, defaults matching the reference *code*
    (not its usage text, which disagrees — main.zig:840-843 vs main.zig:807):
    temperature 1.0, top_p 0.9 (clamped to [0,1]), steps 0 = model max.
    """

    temperature: float = 1.0
    top_p: float = 0.9
    steps: int = 0
    seed: int | None = None

    def resolve_steps(self, model_seq_len: int) -> int:
        """``-n 0`` → model max; always clamped to [1, seq_len] (main.zig:992-993)."""
        steps = self.steps if self.steps != 0 else model_seq_len
        return max(1, min(steps, model_seq_len))
