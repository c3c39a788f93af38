"""Perplexity evaluation — the INT8 quality regression gate.

Port of ``llama2_tpu/tools/perplexity.py``: token-level perplexity of a text
under a checkpoint (fp32 v0, INT8 ak42 v2 or a param-cache directory),
teacher-forcing ``[BOS] + text`` through chunked prefill and scoring each
next token. Each chunk's classifier runs over every position of the chunk,
so on ``cuda`` the INT8 classifier (K5) takes its M > 8 tile at M = chunk.
Runs on the card unless ``--platform cpu`` asks for the CPU.

    python -m llama2_tpu_torch.tools.perplexity <ckpt.bin | cache dir> -z tokenizer.bin \\
        (-i "text" | -f file.txt) [--chunk 256] [--platform cpu|gpu]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from llama2_tpu_torch.models.llama import activation_dtype, forward, init_cache, logits_from_hidden


def token_nlls(config, params: dict, tokens: list[int], chunk: int = 256, backend: str = "cuda") -> np.ndarray:
    """The float32 negative log-likelihood of every scored token of ``[BOS] +
    tokens`` (cut to ``seq_len``), in order. ``params``: tensors on one
    device (``runtime/generator.py::prepare_params``); the KV cache is made
    there, in the activations' dtype."""
    feed = [1] + list(tokens)
    seq = min(len(feed), config.seq_len)
    feed = feed[:seq]
    device = params["tok_emb"].device
    cache = init_cache(config, 1, activation_dtype(params), device)
    nll = []
    pos = 0
    while pos < seq - 1:
        n = min(chunk, seq - pos)  # positions pos .. pos+n-1
        seg = torch.as_tensor(np.asarray(feed[pos : pos + n], np.int64)[None], device=device)
        hidden = forward(params, cache, seg, pos, config, backend)
        logits = logits_from_hidden(params, hidden[0], backend)  # (n, V) float32
        logp = torch.log_softmax(logits, dim=-1)
        # targets: the next fed token for every position except the last fed
        upto = min(n, seq - 1 - pos)
        targets = torch.as_tensor(np.asarray(feed[pos + 1 : pos + 1 + upto], np.int64), device=device)
        nll.append(-logp[:upto].gather(1, targets[:, None])[:, 0].cpu().numpy())
        pos += n
    return np.concatenate(nll) if nll else np.zeros(0, np.float32)


def perplexity(config, params: dict, tokens: list[int], chunk: int = 256, backend: str = "cuda") -> dict:
    """Mean NLL + perplexity of ``tokens`` under the model (BOS prepended):
    ``{"nll", "ppl", "tokens"}`` (:func:`token_nlls`)."""
    all_nll = token_nlls(config, params, tokens, chunk, backend)
    mean = float(all_nll.mean()) if all_nll.size else float("nan")
    return {"nll": mean, "ppl": float(np.exp(mean)), "tokens": int(all_nll.size)}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    path = None
    tok_path = "tokenizer.bin"
    text = None
    chunk = 256
    platform = "gpu"
    i = 0
    while i < len(argv):
        a = argv[i]
        if a in ("-z", "-i", "-f", "--chunk", "--platform") and i + 1 >= len(argv):
            print(f"missing argument for {a}", file=sys.stderr)
            return 1
        if a == "-z":
            i += 1
            tok_path = argv[i]
        elif a == "-i":
            i += 1
            text = argv[i]
        elif a == "-f":
            i += 1
            with open(argv[i], encoding="utf-8") as f:
                text = f.read()
        elif a == "--chunk":
            i += 1
            try:
                chunk = int(argv[i])
            except ValueError:
                chunk = 0
            if chunk < 1:
                print(f"--chunk must be a positive integer (got {argv[i]!r})", file=sys.stderr)
                return 1
        elif a == "--platform":
            i += 1
            platform = argv[i]
            if platform not in ("cpu", "gpu"):
                print("--platform must be cpu or gpu", file=sys.stderr)
                return 1
        elif not a.startswith("-") and path is None:
            path = a
        else:
            print(f"unknown argument {a}", file=sys.stderr)
            return 1
        i += 1
    if path is None or text is None:
        print(__doc__, file=sys.stderr)
        return 1
    if platform == "gpu" and not torch.cuda.is_available():
        print("no CUDA device available; pass --platform cpu to run on the CPU", file=sys.stderr)
        return 1

    from llama2_tpu_torch.io import load_any
    from llama2_tpu_torch.runtime.generator import prepare_params
    from llama2_tpu_torch.tokenizer.fast import load_tokenizer

    device = torch.device("cuda" if platform == "gpu" else "cpu")
    config, params, _ = load_any(path)
    tokenizer = load_tokenizer(tok_path, config.vocab_size)
    tokens = tokenizer.encode(text)
    params = prepare_params(params, torch.float32, "cuda", device)
    out = perplexity(config, params, tokens, chunk=chunk)
    print(f"tokens: {out['tokens']}  nll: {out['nll']:.4f}  ppl: {out['ppl']:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
