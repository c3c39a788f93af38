"""Offline checkpoint converter: fp32 v0 ``.bin`` -> INT8 ak42 v2.

The llama2.c-runq-style quantizer as a tool:

    python -m llama2_tpu_torch.quant.convert model.bin model-q8.bin [--group-size 64]
"""

from __future__ import annotations

import sys

import numpy as np


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    group_size = 64
    args: list[str] = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "--group-size":
            i += 1
            group_size = int(argv[i])
        elif a.startswith("--group-size="):
            group_size = int(a.split("=", 1)[1])
        else:
            args.append(a)
        i += 1
    if len(args) != 2:
        print(__doc__, file=sys.stderr)
        return 1
    src, dst = args

    from llama2_tpu_torch.io.checkpoint import load_checkpoint
    from llama2_tpu_torch.io.quantized import save_quantized_checkpoint
    from llama2_tpu_torch.quant.q8 import quantize_params

    config, params, shared = load_checkpoint(src)
    if config.dim % group_size or config.hidden_dim % group_size:
        # shrink to a divisor of both (llama2.c requires divisibility)
        g = int(np.gcd(np.gcd(config.dim, config.hidden_dim), group_size))
        print(f"group size {group_size} does not divide dims; using {g}", file=sys.stderr)
        group_size = g
    qparams = quantize_params(params, group_size)
    # v2 stores a classifier section only when unshared
    save_quantized_checkpoint(dst, config, qparams, shared, group_size)
    print(f"wrote {dst} (group size {group_size})", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
