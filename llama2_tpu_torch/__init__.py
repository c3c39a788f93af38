"""llama2_tpu_torch — the Llama-2 inference engine in PyTorch for NVIDIA Hopper.

A port of the JAX package ``llama2_tpu`` (which stays the reference it is
tested against): llama2.c ``.bin`` checkpoints, ``tokenizer.bin`` BPE, the
fp32/bf16 forward pass with GQA/MQA attention over a layer-stacked KV cache,
argmax / multinomial / top-p sampling, the reference generation loop and
CLI. Attention runs through hand-written CUDA kernels for ``sm_90a``
(``csrc/``, built with ``nvcc`` at first use). Entry points run on the card
unless the caller asks for the CPU. This package imports nothing of
``llama2_tpu`` and no JAX.
"""

from llama2_tpu_torch.config import GenerationConfig, ModelConfig
from llama2_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
from llama2_tpu_torch.tokenizer.tokenizer import Tokenizer

__version__ = "0.1.0"

__all__ = [
    "ModelConfig",
    "GenerationConfig",
    "load_checkpoint",
    "save_checkpoint",
    "Tokenizer",
]
