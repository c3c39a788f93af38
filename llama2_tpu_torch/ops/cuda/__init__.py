"""Hand-written CUDA kernels (``csrc/``) with their wrappers and plain
versions. ``SOURCES`` names every kernel source; ``build.build_all(SOURCES)``
builds them all at once."""

SOURCES = ("prefill_attention", "decode_attention", "attention_q8", "quant_matmul", "mlp_block")
