"""The whole decode layer over the INT8 KV cache in one launch (kernel K13).

``layer_block_stacked`` runs, for decoder layer ``l`` of layer-stacked INT8
weights and caches::

    att  = attention(rope(qkv3), int8 cache; append this step's rows)
    r    = x + att @ wo[l]
    out  = r + swiglu(rmsnorm(r, rms_ffn[l]) @ w1[l], .. @ w3[l]) @ w2[l]
    qkv' = rmsnorm(out, rms_att[l']) @ wqkv[l'],   l' = min(l + 1, L - 1)  (with_qkv)

as ONE cooperative launch of the kernel of ``csrc/mlp_block.cu`` with its
attention phase (the split decode loop of ``csrc/attention_q8.cuh`` over the
dense planes, launched as :func:`launch_plans` says), replacing
``llama2_tpu/ops/pallas/layer_block.py::layer_block_stacked``. It is the
glue-fused int8 attention (K9) followed by the wo/FFN/next-QKV megakernel
(K12, or K11 without ``qkv'``), with the two differences the Pallas kernel
has: the cache is read with the strict mask ``t < pos`` and this step's row
joins as a virtual row whose value is the float32 dequantized row (not
rounded to bf16); and ``att`` stays float32 into the wo phase, rounded to
bf16 only where it is used. So K13 agrees with K9 + K12 to a tolerance, and
its cache appends equal K9's bit for bit.

``layer_block_stacked_plain`` is the same function in plain PyTorch: the
wrapper takes it for CPU tensors, and ``chip_smoke.py`` holds the kernel
against it on the card. On a CUDA tensor the wrapper launches or raises.
"""

from __future__ import annotations

import functools

import torch

from llama2_tpu_torch.ops.cuda import build
from llama2_tpu_torch.ops.cuda import mlp_block as mb
from llama2_tpu_torch.ops.cuda.attention_q8 import (
    Q8_WARPS,
    _check_stacked,
    _sms,
    append_rows,
    q8_plan,
    rope_quantize_plain,
)
from llama2_tpu_torch.ops.cuda.quant_matmul import _check_layer


def layer_block_supported(wo, w1, w3, w2, wqkv, config) -> bool:
    """Whether ``layer_block_stacked`` takes these weights for ``config``:
    what ``layer_tail_qkv_stacked`` takes (``mb.layer_tail_qkv_supported``),
    query heads spanning the model width (``H * hs == D``), ``wqkv`` the fused
    (H + 2*KVH) * hs outputs, the head sizes of its one attention loop (a
    multiple of 16 up to 128, ``H % KVH == 0``; other heads take K9 + K12),
    and whole ``wo`` quant groups a head."""
    if not mb.layer_tail_qkv_supported(wo, w1, w3, w2, wqkv):
        return False
    H, KVH, hs = config.n_heads, config.n_kv_heads, config.head_size
    if H * hs != w1.q.shape[1] or H % KVH != 0 or hs > 128 or hs % 16 != 0:
        return False
    return wqkv.q.shape[2] == (H + 2 * KVH) * hs and hs % wo.group_size == 0


@functools.lru_cache(maxsize=None)
def launch_plans(B: int, D: int, HD: int, Dq: int, groups: tuple, H: int, KVH: int, S: int, hs: int,
                 device_index: int) -> tuple[dict, dict]:
    """The launch of K13 on this device, from the shapes alone: the
    megakernel's plan (``mb.launch_plan`` with the attention phase, whose
    cooperative grid keeps the instance's warp accumulators resident) and
    the attention phase's (:func:`q8_plan` over the dense planes, reach S,
    its work items dealt over that grid, in the megakernel's one loop; two
    warp loads a pass where three blocks share an SM's registers, the FMA
    form at 1-2 rows). Cached: a decode step asks 32 times."""
    sms = _sms(device_index)
    p = mb.launch_plan(B, D, HD, Dq, groups, device_index, att=Q8_WARPS * hs)  # one query row a block
    unroll1 = 2 if p["variant"] == "fma" and p["mt"] <= 2 else 4
    return p, q8_plan(B, H, KVH, S, hs, sms, blocks=p["grid"], unroll1=unroll1, megakernel=True)


def _virtual_attend_plain(q, k8, ks, v8, vs, rows, pos, scale: float) -> torch.Tensor:
    """K13's attention on one layer's cache (B, KVH, S, hs): keys t < pos_b,
    then this step's row (``rows``: int8 (B, KVH, hs) K and V rows and their
    (B, KVH) scales) as one more online-softmax update with the float32
    dequantized V row. q (B, H, hs) float32. Returns float32 (B, H * hs)."""
    B, H, hs = q.shape
    KVH = k8.shape[1]
    kn8, kns, vn8, vns = rows
    qb = q.to(torch.bfloat16).float().reshape(B, KVH, H // KVH, hs)
    sv = torch.einsum("bkgd,bkd->bkg", qb, kn8.float()) * (kns[..., None] * scale)
    vd = vn8.float() * vns[..., None]  # (B, KVH, hs) float32
    n = int(pos.max())
    if n > 0:
        s = torch.einsum("bkgd,bksd->bkgs", qb, k8[:, :, :n].float()) * (ks[:, :, None, :n] * scale)
        live = torch.arange(n, device=q.device)[None, :] < pos.long()[:, None]  # (B, n)
        s = s.masked_fill(~live[:, None, None], float("-inf"))
        mx = s.amax(dim=-1)
        p = torch.where(mx[..., None] == float("-inf"), 0.0, torch.exp(s - mx[..., None]))
        l = p.sum(dim=-1)
        pv = (p * vs[:, :, None, :n]).to(torch.bfloat16).float()
        acc = torch.einsum("bkgs,bksd->bkgd", pv, v8[:, :, :n].float())
    else:
        mx = torch.full_like(sv, float("-inf"))
        l = torch.zeros_like(sv)
        acc = torch.zeros((*sv.shape, hs), device=q.device)
    m = torch.maximum(mx, sv)
    alpha = torch.exp(mx - m)
    p_new = torch.exp(sv - m)
    att = (acc * alpha[..., None] + p_new[..., None] * vd[:, :, None, :]) / (l * alpha + p_new)[..., None]
    return att.reshape(B, H * hs)


def layer_block_stacked_plain(
    qkv3, x, k8, k_scale, v8, v_scale, cos_il, sin_il, wo, rms_ffn, w1, w3, w2, rms_att, wqkv,
    layer, pos, *, n_heads: int, eps: float = 1e-5, scale: float | None = None, with_qkv: bool = True,
):
    """The kernel's arithmetic in plain PyTorch; arguments as the wrapper's."""
    layer = int(layer)
    hs = qkv3.shape[-1]
    scale = 1.0 / hs**0.5 if scale is None else float(scale)
    q, rows = rope_quantize_plain(qkv3, cos_il, sin_il, n_heads)
    att = _virtual_attend_plain(q, k8[layer], k_scale[layer], v8[layer], v_scale[layer], rows, pos, scale)
    append_rows(k8, k_scale, v8, v_scale, rows, layer, pos)
    if with_qkv:
        return mb.layer_tail_qkv_plain(att, x, wo, rms_ffn, w1, w3, w2, rms_att, wqkv, layer, eps)
    return mb.attn_mlp_block_plain(att, x, wo, rms_ffn[layer], w1, w3, w2, layer, eps), None


def layer_block_stacked(
    qkv3, x, k8, k_scale, v8, v_scale, cos_il, sin_il, wo, rms_ffn, w1, w3, w2, rms_att, wqkv,
    layer, pos, *, n_heads: int, eps: float = 1e-5, scale: float | None = None, with_qkv: bool = True,
):
    """One whole decoder layer at T = 1 over the layer-stacked INT8 cache.

    qkv3 (B, H + 2*KVH, hs): this layer's raw pre-RoPE QKV rows (the previous
    layer's ``qkv'``, or layer 0's projection), in x's dtype; x (B, D) the
    residual stream entering the layer, float32 or bf16; k8/v8
    (L, B, KVH, S, hs) int8 and k_scale/v_scale (L, B, KVH, S) float32, updated
    IN PLACE at ``[layer, b, :, pos[b]]``; cos_il/sin_il (B, hs) float32, each
    pair's value on both of its elements; rms_ffn/rms_att (L, D) in x's dtype;
    weights layer-stacked QuantTensors (see :func:`layer_block_supported`);
    ``pos`` an int32 (B,) tensor. Returns ``(out (B, D), qkv' (B, Dq) or
    None)``; the last layer passes ``with_qkv=False``.

    CPU tensors take the plain version; CUDA tensors launch the kernel (and
    count the launch in ``layer_block_stacked.launches``, and by form as
    ``ops/cuda/mlp_block.py``'s wrappers do) or raise.
    """
    layer = int(layer)
    if qkv3.ndim != 3 or x.ndim != 2:
        raise ValueError(f"want qkv3 (B,H+2*KVH,hs) and x (B,D); got {tuple(qkv3.shape)}, {tuple(x.shape)}")
    B, rows, hs = qkv3.shape
    H = int(n_heads)
    KVH = _check_stacked(B, H, hs, k8, k_scale, v8, v_scale, layer, pos)
    if rows != H + 2 * KVH:
        raise ValueError(f"qkv rows {rows} != n_heads {H} + 2*KVH {2 * KVH}")
    mb._check("layer_block", mb.layer_tail_qkv_supported(wo, w1, w3, w2, wqkv), (wo, w1, w3, w2, wqkv))
    L, D, HD = w1.q.shape
    _check_layer(layer, L)
    if k8.shape[0] != L or x.shape != (B, D) or H * hs != D or wqkv.q.shape[2] != rows * hs:
        raise ValueError(f"shapes disagree: x {tuple(x.shape)}, caches {tuple(k8.shape)}, "
                         f"w1 {tuple(w1.q.shape)}, wqkv {tuple(wqkv.q.shape)}")
    for name, t in (("cos_il", cos_il), ("sin_il", sin_il)):
        if tuple(t.shape) != (B, hs) or t.dtype != torch.float32:
            raise ValueError(f"{name} {t.dtype} {tuple(t.shape)}: want float32 {(B, hs)}")
    if x.device.type == "cpu":
        return layer_block_stacked_plain(
            qkv3, x, k8, k_scale, v8, v_scale, cos_il, sin_il, wo, rms_ffn, w1, w3, w2, rms_att,
            wqkv, layer, pos, n_heads=H, eps=eps, scale=scale, with_qkv=with_qkv,
        )
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in build.DTYPE_CODES:
        raise ValueError(f"x dtype {x.dtype}: want one of f32, bf16")
    for name, t in (("qkv3", qkv3), ("rms_ffn", rms_ffn), ("rms_att", rms_att)):
        if t.dtype != x.dtype:
            raise ValueError(f"{name} {t.dtype}: want {x.dtype}")
    if tuple(rms_ffn.shape) != (L, D) or tuple(rms_att.shape) != (L, D):
        raise ValueError(f"rms_ffn {tuple(rms_ffn.shape)}, rms_att {tuple(rms_att.shape)}: want {(L, D)}")
    operands = [qkv3, x, k8, k_scale, v8, v_scale, cos_il, sin_il, rms_ffn, rms_att, pos]
    for w in (wo, w1, w3, w2, wqkv):
        operands += [w.q, w.scale]
        if w.q.data_ptr() % 16 or w.scale.data_ptr() % 16:
            raise ValueError("q and scale must be 16-byte aligned")
    if any(t.device != x.device for t in operands):
        raise ValueError("all operands must be on one device")
    if not all(t.is_contiguous() for t in operands):
        raise ValueError("operands must be contiguous")
    if k8.data_ptr() % 16 or v8.data_ptr() % 16 or hs % 16 or hs > 128:
        raise ValueError(f"the kernel takes 16-byte aligned int8 caches and hs % 16 == 0, hs <= 128 (hs={hs})")
    S = k8.shape[3]
    Dq = wqkv.q.shape[2] if with_qkv else 0
    groups = (wo.group_size, w1.group_size, w2.group_size, wqkv.group_size if with_qkv else 0)
    device = torch.device("cuda", x.device.index if x.device.index is not None else torch.cuda.current_device())
    p, q = launch_plans(B, D, HD, Dq, groups, H, KVH, S, hs, device.index)
    ws_floats = p["ws_floats"] + B * D + q["ws_floats"]
    if -(-max(D, HD, Dq) // 128) + q["tickets"] > build.MAX_TICKETS:
        raise ValueError("more column strips and (b, kv head) pairs than the tickets cover")
    ws, tickets = build.workspace(device, ws_floats)
    out = torch.empty((B, D), dtype=x.dtype, device=x.device)
    qkv = torch.empty((B, Dq), dtype=x.dtype, device=x.device) if with_qkv else None
    scale = 1.0 / hs**0.5 if scale is None else float(scale)
    err = mb._entries()[2](
        qkv3.data_ptr(), cos_il.data_ptr(), sin_il.data_ptr(), k8.data_ptr(), k_scale.data_ptr(),
        v8.data_ptr(), v_scale.data_ptr(), pos.data_ptr(), x.data_ptr(), wo.q.data_ptr(),
        wo.scale.data_ptr(), rms_ffn.data_ptr(), w1.q.data_ptr(), w1.scale.data_ptr(),
        w3.q.data_ptr(), w3.scale.data_ptr(), w2.q.data_ptr(), w2.scale.data_ptr(),
        rms_att.data_ptr(), wqkv.q.data_ptr(), wqkv.scale.data_ptr(), out.data_ptr(),
        None if qkv is None else qkv.data_ptr(), ws.data_ptr(), tickets.data_ptr(), ws.numel(),
        tickets.numel(), build.DTYPE_CODES[x.dtype], layer, L, B, D, HD, Dq, *groups, *p["ksplit"],
        p["mt"], int(p["variant"] == "mma"), p["grid"], float(eps), H, KVH, S, hs, q["splits"], q["nq"],
        q["vb"], q["chunk"], scale, torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(err, "layer_block_stacked")
    mb.count(layer_block_stacked, p["variant"])
    return out, qkv


layer_block_stacked.launches = layer_block_stacked.launches_mma = layer_block_stacked.launches_fma = 0
