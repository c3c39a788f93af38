"""Sequence-sharded decode: decoding over a KV cache cut over ``seq``.

Counterpart of ``llama2_tpu/parallel/ring_decode.py``, and the path of the
CLI's ``--seq-shards N``. The KV cache's sequence axis is cut over the
``seq`` axis of a mesh, so the context a rank holds is ``seq_len / sp``
rows: the resident context grows with the ranks.

Distributed flash-decode, not a rotating ring: decode attends one query row
against the whole cache, so every rank keeps its rows resident and the
ranks merge online-softmax statistics:

* rank ``i`` owns the global rows ``[i * S/sp, (i + 1) * S/sp)`` of every
  (batch, kv head) plane and computes its scores and weighted values over
  the rows up to the query's position (:func:`seq_decode_attention`; a rank
  whose rows all lie past it contributes the neutral statistics);
* the ranks merge the running max, the denominator and the weighted
  accumulator: one all-gather a layer of every rank's ``(max, denominator,
  accumulator)``, then on every rank the global max and the sums of the
  denominators and accumulators weighted by ``exp(m_rank - m_global)``, in
  rank order (the per-element values of the JAX ``pmax`` and its two
  ``psum`` calls, one collective where they are three: on gloo each costs
  a device sync and a host round trip);
* the merged output equals dense masked attention up to the order of the
  sums.

Every position-local op (norms, the QKV and FFN products, RoPE, sampling)
is replicated over ``seq``: the logits are equal on every rank, so every
rank picks the same token with no broadcast. A KV row is written on the one
rank that owns its position (:func:`_append_local`). With a ``model`` axis
(``sp.make_sp_tp_mesh``) the kv heads are cut over it as in
``parallel/tp.py``, and wo's and w2's partial outputs are all-reduced over
the model group: the two axes touch different tensors.

The fp path, as in the JAX package (fp weights, float32 cache, plain
PyTorch on the mesh's device, no kernel of ``ops/cuda``).
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

from llama2_tpu_torch.ops import ref, sampling
from llama2_tpu_torch.parallel.ring import NEG_INF
from llama2_tpu_torch.parallel.sp import LAYER_KEYS, SEQ_AXIS, rank_params
from llama2_tpu_torch.parallel.tp import add_reduced, local_config
from llama2_tpu_torch.tokenizer.tokenizer import BOS


def seq_decode_attention(q, k_cache, v_cache, pos: int, group, s_local: int, scale: float) -> torch.Tensor:
    """GQA decode attention over a cache cut over ``seq``, merged over the
    ``group``'s ranks (None: one rank, no collective).

    q: (B, T, H, hs), T = 1 or a short window; k_cache, v_cache: (B, KVH,
    S/sp, hs), this rank's rows (global rows offset by its index times
    ``s_local``); ``pos``: the last query row's global position (query row
    ``t`` attends to rows ``<= pos - (T - 1) + t``). Returns (B, T, H, hs),
    equal on every rank of the group."""
    B, T, H, hs = q.shape
    KVH = k_cache.shape[1]
    G = H // KVH
    my = 0 if group is None else dist.get_rank(group)
    off = my * s_local
    n = min(s_local, max(0, pos + 1 - off))  # the rows of this rank the window may attend
    if n:
        k_pos = off + torch.arange(n, device=q.device)
        q_pos = pos - (T - 1) + torch.arange(T, device=q.device)
        mask = (k_pos[None, :] <= q_pos[:, None])[None, None, None]  # (1, 1, 1, T, n)
        qg = q.reshape(B, T, KVH, G, hs)
        scores = torch.einsum("btkgd,bksd->bkgts", qg, k_cache[:, :, :n]).float() * scale
        scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
        m_l = scores.amax(dim=-1)  # (B, KVH, G, T)
        p = torch.where(mask, torch.exp(scores - m_l[..., None]), torch.zeros_like(scores))
        s_l = p.sum(dim=-1)
        acc_l = torch.einsum("bkgts,bksd->bkgtd", p.to(v_cache.dtype), v_cache[:, :, :n]).float()
    else:  # every row of this rank lies past the window: merge weight exp(NEG_INF - m_global) = 0
        m_l = torch.full((B, KVH, G, T), NEG_INF, dtype=torch.float32, device=q.device)
        s_l = torch.zeros_like(m_l)
        acc_l = torch.zeros((B, KVH, G, T, hs), dtype=torch.float32, device=q.device)
    stats = torch.cat([m_l[..., None], s_l[..., None], acc_l], dim=-1)  # (B, KVH, G, T, 2 + hs)
    if group is not None:
        parts = [torch.empty_like(stats) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, stats, group=group)
        stats = torch.stack(parts)  # (S, B, KVH, G, T, 2 + hs), in rank order
    else:
        stats = stats[None]
    m_r, s_r, acc_r = stats[..., 0], stats[..., 1], stats[..., 2:]
    w = torch.exp(m_r - m_r.amax(dim=0))  # a rank whose rows all lie past the window weighs 0
    s_g = (s_r * w).sum(dim=0)
    acc_g = (acc_r * w[..., None]).sum(dim=0)
    out = acc_g / s_g[..., None]  # rank 0 holds row 0: every query row attends to one at least
    return out.permute(0, 3, 1, 2, 4).reshape(B, T, H, hs).to(q.dtype)


def _append_local(cache: torch.Tensor, rows: torch.Tensor, pos: int, my_off: int, s_local: int) -> torch.Tensor:
    """Write ``rows (B, KVH, T, hs)``, the global positions ``pos - (T - 1)
    .. pos``, into this rank's plane ``cache (B, KVH, S/sp, hs)`` in place,
    each row only where this rank owns it: a window straddling the boundary
    of two ranks leaves each its own rows (the positions are the host's, so
    the JAX clamp and ownership mask are a branch a row). Returns
    ``cache``."""
    T = rows.shape[2]
    first = pos - (T - 1) - my_off  # the local row of the window's first token
    for t in range(T):
        if 0 <= first + t < s_local:
            cache[:, :, first + t] = rows[:, :, t]
    return cache


def _layer_seq(x, lp: dict, k_c, v_c, pos: int, cos, sin, config, seq_group, my_off: int, s_local: int,
               model_group):
    """One decoder layer of a decode step over the ``seq``-cut cache:
    ``models/llama.py``'s plain layer with the KV write on the owning rank
    and the attention merged over ``seq``. ``config`` holds the LOCAL head
    counts under a model group."""
    B, T, _ = x.shape
    H, KVH, hs = config.n_heads, config.n_kv_heads, config.head_size
    xb = ref.rmsnorm(x, lp["rms_att"], config.norm_eps)
    q = ref.apply_rope((xb @ lp["wq"]).reshape(B, T, H, hs), cos, sin)
    k = ref.apply_rope((xb @ lp["wk"]).reshape(B, T, KVH, hs), cos, sin)
    v = (xb @ lp["wv"]).reshape(B, T, KVH, hs)
    _append_local(k_c, k.transpose(1, 2), pos, my_off, s_local)
    _append_local(v_c, v.transpose(1, 2), pos, my_off, s_local)
    att = seq_decode_attention(q, k_c, v_c, pos, seq_group, s_local, 1.0 / hs**0.5).reshape(B, T, H * hs)
    x = add_reduced(x, att @ lp["wo"], model_group)
    xb = ref.rmsnorm(x, lp["rms_ffn"], config.norm_eps)
    return add_reduced(x, ref.swiglu(xb @ lp["w1"], xb @ lp["w3"]) @ lp["w2"], model_group)


def _forward_step_seq(params: dict, cache_k, cache_v, token: torch.Tensor, pos: int, config, seq_group,
                      my_off: int, s_local: int, model_group) -> torch.Tensor:
    """One T = 1 step: ``token (B,)`` at global position ``pos`` through every
    layer, its KV row written on the owning rank; returns the float32
    logits ``(B, V)``, equal on every rank."""
    x = params["tok_emb"][token[:, None]]  # (B, 1, D)
    cos, sin = ref.rope_angles(torch.tensor([pos], dtype=torch.int32, device=x.device), config.head_size)
    for i in range(config.n_layers):
        lp = {k: params[k][i] for k in LAYER_KEYS}
        x = _layer_seq(x, lp, cache_k[i], cache_v[i], pos, cos, sin, config, seq_group, my_off, s_local,
                       model_group)
    x = ref.rmsnorm(x, params["rms_final"], config.norm_eps)
    wcls = params.get("wcls", params["tok_emb"].T)
    return (x[:, -1, :] @ wcls).float()


class SeqShardedDecoder:
    """Decoding with the KV cache cut over ``seq`` (and kv heads over
    ``model`` on a ``(seq, model)`` mesh): batched prompts, the reference's
    sampling policy (argmax, temperature, top-p, seeded), reachable from
    the CLI's ``--seq-shards``. Every rank of the mesh builds it and calls
    the same methods with the same arguments.

    ``params``: the whole fp tree (numpy arrays or tensors); the rank keeps
    its slices (``sp.rank_params``: replicated over ``seq``, cut over
    ``model``) on the mesh's device in fp32, and its cache of ``seq_len /
    sp`` rows."""

    def __init__(self, config, params: dict, mesh):
        if SEQ_AXIS not in mesh.shape:
            raise ValueError(f"mesh must have a '{SEQ_AXIS}' axis, got {tuple(mesh.shape)}")
        self.sp = mesh.shape[SEQ_AXIS]
        self.tp = mesh.tp
        if config.seq_len % self.sp:
            raise ValueError(f"seq_len={config.seq_len} not divisible by sp={self.sp}")
        if self.tp > 1 and (config.n_heads % self.tp or config.n_kv_heads % self.tp):
            raise ValueError(f"tp={self.tp} does not divide the head counts")
        self.config = config
        self.mesh = mesh
        self.s_local = config.seq_len // self.sp
        self.local_config = local_config(config, self.tp)
        self.params = rank_params(params, mesh, model_axis=True)
        self._seq_group = mesh.group(SEQ_AXIS)
        self._model_group = mesh.model_group if self.tp > 1 else None
        self._my_off = mesh.index(SEQ_AXIS) * self.s_local

    def _cache(self, batch: int) -> tuple[torch.Tensor, torch.Tensor]:
        """This rank's zeroed float32 K and V planes, ``(L, B, KVH / tp,
        seq_len / sp, hs)``."""
        c = self.local_config
        shape = (c.n_layers, batch, c.n_kv_heads, self.s_local, c.head_size)
        return (torch.zeros(shape, dtype=torch.float32, device=self.mesh.device),
                torch.zeros(shape, dtype=torch.float32, device=self.mesh.device))

    def step(self, cache: tuple, token: torch.Tensor, pos: int) -> torch.Tensor:
        """One T = 1 forward step of every row: ``token (B,)`` on the mesh's
        device at global position ``pos``, its KV rows written into
        ``cache`` (:meth:`_cache`'s pair) on the owning rank. Returns the
        float32 logits ``(B, V)``."""
        return _forward_step_seq(self.params, cache[0], cache[1], token, pos, self.local_config,
                                 self._seq_group, self._my_off, self.s_local, self._model_group)

    def generate(self, prompt_tokens: list[int], n_steps: int) -> list[int]:
        """Greedy decode of one prompt (BOS first, as the reference loop):
        the emitted tokens (prompt echo and generated), cut at the first
        emitted BOS."""
        from llama2_tpu_torch.config import GenerationConfig

        return self.generate_batch([prompt_tokens], GenerationConfig(temperature=0.0, steps=int(n_steps),
                                                                     seed=0))[0]

    def generate_batch(self, prompts: list[list[int]], gen) -> list[list[int]]:
        """Decode a batch of prompts with the reference's sampling policy
        (``gen``: a GenerationConfig; argmax at temperature 0, else the
        temperature-scaled softmax with optional top-p).

        A Python loop of T = 1 steps on every rank: step ``i`` feeds the
        token at position ``i`` (the row's prompt while inside it, BOS
        first; teacher forcing), then the next is the prompt's or the
        sampled one. Row ``b`` samples with the draw
        ``runtime/generator.py::uniform_draw(seed + b, i)``: a row seeded
        like a ``Generator`` run reproduces its stream. Returns each row's
        emitted tokens (positions 1 .. steps: prompt echo and generated),
        cut at its first emitted BOS."""
        from llama2_tpu_torch.runtime.generator import uniform_draw

        c = self.config
        n_steps = gen.resolve_steps(c.seq_len)
        rows = []
        for p in prompts:
            if len(p) + 1 > c.seq_len:
                raise ValueError(f"prompt of {len(p)} tokens (+ BOS) exceeds seq_len={c.seq_len}")
            rows.append([BOS] + list(p))
        B = len(rows)
        mode = sampling.choose_mode(gen.temperature, gen.top_p)
        seed = gen.seed if gen.seed is not None else time.time_ns() % (2**63)
        temperature = gen.temperature if gen.temperature != 0 else 1.0
        top_p = min(max(gen.top_p, 0.0), 1.0)
        cache = self._cache(B)
        dev = self.mesh.device
        token = torch.tensor([r[0] for r in rows], dtype=torch.int64, device=dev)
        emitted = [[] for _ in range(B)]
        for i in range(n_steps):
            logits = self.step(cache, token, i)
            if mode == sampling.ARGMAX:
                drawn = sampling.sample_argmax(logits).tolist()
            else:
                drawn = [int(sampling.sample(logits[b], mode, temperature, top_p, uniform_draw(seed + b, i)))
                         for b in range(B)]
            nxt = [rows[b][i + 1] if i + 1 < len(rows[b]) else drawn[b] for b in range(B)]
            for b in range(B):
                emitted[b].append(nxt[b])
            if all(BOS in e for e in emitted):  # every row has stopped: the rest is cut anyway
                break
            token = torch.tensor(nxt, dtype=torch.int64, device=dev)
        return [e[: e.index(BOS)] if BOS in e else e for e in emitted]
