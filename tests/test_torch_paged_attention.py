"""The torch port's paged decode attention (K15-K18) against the JAX package.

Seeded numpy pools, tables and rows go through the JAX functions of
``llama2_tpu/ops/pallas/paged_attention.py`` (the Pallas kernels in interpret
mode on the CPU, as ``tests/test_paged.py`` runs them) and through the port's
wrappers on CPU tensors, which run the plain versions.

Inputs: B = 3 slots; H = KVH and GQA (H = 4, KVH = 2); head sizes 48 and 128;
pages of 16 and 128 rows (128 only for the int8 pools, whose JAX kernels
require it); a two-layer pool whose pages are handed out shuffled; two calls,
layer 0 with the slots at positions 0, page - 1 and page, and layer L - 1
with a mid-page position, a third page's row and an inactive slot whose
all-zero table row reads and writes the scratch page 0.

Held: the attention output within ``ATOL`` (float32; the two sides differ in
the order of float32 sums); the returned pools EQUAL to JAX's, bit for bit
(the appended rows and scales, and nothing else of the pools touched), but
for the glue-fused kernels' rotated K rows (1e-6) and int8 scales (one
float32 ulp), see ``ROPED``; each
plain version against ``paged_attention_oracle`` over the gathered pages
(fp: ``ATOL``; int8: the JAX test's 3e-2, the kernels round the query and
``p * v_scale`` to bf16); and the glue-fused forms against RoPE (and the row
quantization) followed by the stacked forms.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama2_tpu.ops import xla as jops
from llama2_tpu.ops.pallas import attention_q8 as jq8
from llama2_tpu.ops.pallas import paged_attention as jpa
from llama2_tpu_torch.ops import ref
from llama2_tpu_torch.ops.cuda import attention_q8 as tq8
from llama2_tpu_torch.ops.cuda import paged_attention as tpa

ATOL = 1e-5
L, B, MAX_PAGES = 2, 3, 4
LAYOUTS = {"mha": (2, 2), "gqa": (4, 2)}  # (H, KVH)


def _t(a):
    return torch.from_numpy(np.array(a))


def _setup(rng, page):
    """A shuffled table (pages 1.. in a random order, none ascending) and the
    two calls' (layer, pos, table, write_page, write_row)."""
    P = 1 + B * MAX_PAGES
    tables = rng.permutation(np.arange(1, P)).reshape(B, MAX_PAGES).astype(np.int32)
    calls = []
    for layer, pos in ((0, [0, page - 1, page]), (L - 1, [page // 2 + 1, 2 * page + 3, 5])):
        table = tables.copy()
        if layer == L - 1:
            table[2] = 0  # an inactive slot: the scratch page
        pos = np.asarray(pos, np.int32)
        wpage = table[np.arange(B), pos // page].astype(np.int32)
        calls.append((layer, pos, table, wpage, (pos % page).astype(np.int32)))
    return P, calls


def _rope_tables(pos, hs):
    cos, sin = jops.rope_angles(jnp.asarray(pos)[:, None], hs)  # (B, 1, hs/2)
    return (np.asarray(jnp.repeat(cos[:, 0], 2, -1)), np.asarray(jnp.repeat(sin[:, 0], 2, -1)),
            cos, sin)


# the glue-fused kernels' appended rows: the JAX kernels rotate K as
# x * cos + swap(x) * sin, which XLA on the CPU contracts to FMAs, where the
# port (plain and CUDA) rounds each product as the plain rope does: the
# rotated K rows to 1e-6 (as K4's in tests/test_torch_attention.py), their
# int8 scales to one float32 ulp (as K9's); V rows and int8 bytes exact
ROPED = dict(rtol=1e-6, atol=1e-6)


def _assert_pools(got, want, before, wpage, wrow, layer, tols=()):
    """Port pools == JAX pools, bit for bit where ``tols[i]`` is None, and
    only the write rows moved."""
    for i, (g, w, b0) in enumerate(zip(got, want, before)):
        tol = tols[i] if i < len(tols) else None
        if tol is None:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)
        changed = np.argwhere((g.numpy() != b0).reshape(*b0.shape[:4], -1).any(-1))
        for lyr, pg, _, row in changed:
            assert lyr == layer and (pg, row) in set(zip(wpage.tolist(), wrow.tolist()))


FP_CASES = [(lay, hs, page) for lay in LAYOUTS for hs in (48, 128) for page in (16, 128)]


@pytest.mark.parametrize("layout,hs,page", FP_CASES)
def test_fp_paged_kernels_match_jax(layout, hs, page):
    """K15 and K17 plain against the Pallas kernels; both against the oracle."""
    H, KVH = LAYOUTS[layout]
    rng = np.random.default_rng(hs + page + H)
    P, calls = _setup(rng, page)
    k_pool = rng.standard_normal((L, P, KVH, page, hs)).astype(np.float32)
    v_pool = rng.standard_normal((L, P, KVH, page, hs)).astype(np.float32)
    for layer, pos, table, wpage, wrow in calls:
        # K15: roped q and the rows, given
        q = rng.standard_normal((B, H, hs)).astype(np.float32)
        kn = rng.standard_normal((B, KVH, 1, hs)).astype(np.float32)
        vn = rng.standard_normal((B, KVH, 1, hs)).astype(np.float32)
        tk, tv = _t(k_pool.copy()), _t(v_pool.copy())
        att, tk2, tv2 = tpa.paged_decode_attention_stacked(
            _t(q), tk, tv, _t(table), _t(kn), _t(vn), _t(wpage), _t(wrow), layer, _t(pos))
        assert tk2 is tk and tv2 is tv  # updated in place and returned
        ja, jk, jv = jpa.paged_decode_attention_stacked(
            jnp.asarray(q), jnp.asarray(k_pool), jnp.asarray(v_pool), jnp.asarray(table),
            jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(wpage), jnp.asarray(wrow), layer,
            jnp.asarray(pos), interpret=True)
        np.testing.assert_allclose(att.numpy(), np.asarray(ja), atol=ATOL, rtol=ATOL)
        _assert_pools((tk, tv), (jk, jv), (k_pool, v_pool), wpage, wrow, layer)
        oracle = tpa.paged_attention_oracle(_t(q), tk[layer], tv[layer], _t(table), _t(pos))
        np.testing.assert_allclose(att.numpy(), oracle.numpy(), atol=ATOL, rtol=ATOL)

        # K17: the raw QKV rows, RoPE inside
        qkv = rng.standard_normal((B, H + 2 * KVH, hs)).astype(np.float32)
        cos_il, sin_il, cos, sin = _rope_tables(pos, hs)
        tk, tv = _t(k_pool.copy()), _t(v_pool.copy())
        att, _, _ = tpa.paged_decode_attention_fused(
            _t(qkv), tk, tv, _t(table), _t(cos_il), _t(sin_il), _t(wpage), _t(wrow), layer,
            _t(pos), n_heads=H)
        ja, jk, jv = jpa.paged_decode_attention_fused(
            jnp.asarray(qkv), jnp.asarray(k_pool), jnp.asarray(v_pool), jnp.asarray(table),
            jnp.asarray(cos_il), jnp.asarray(sin_il), jnp.asarray(wpage), jnp.asarray(wrow), layer,
            jnp.asarray(pos), n_heads=H, interpret=True)
        np.testing.assert_allclose(att.numpy(), np.asarray(ja), atol=ATOL, rtol=ATOL)
        _assert_pools((tk, tv), (jk, jv), (k_pool, v_pool), wpage, wrow, layer, (ROPED,))
        q_rot = ref.apply_rope(_t(qkv)[:, None, :H], _t(np.asarray(cos)), _t(np.asarray(sin)))
        oracle = tpa.paged_attention_oracle(q_rot, tk[layer], tv[layer], _t(table), _t(pos))
        np.testing.assert_allclose(att.numpy(), oracle[:, 0].numpy(), atol=ATOL, rtol=ATOL)


def _quantized(rng, shape):
    q, s = jq8.quantize_kv_rows(jnp.asarray(rng.standard_normal(shape).astype(np.float32)))
    return np.asarray(q), np.asarray(s)


Q8_CASES = [(lay, hs) for lay in LAYOUTS for hs in (48, 128)]


@pytest.mark.parametrize("layout,hs", Q8_CASES)
def test_q8_paged_kernels_match_jax(layout, hs):
    """K16 and K18 plain against the Pallas kernels (page 128); both against
    the dequantizing oracle."""
    H, KVH = LAYOUTS[layout]
    page = 128
    rng = np.random.default_rng(hs + H)
    P, calls = _setup(rng, page)
    k8, ks = _quantized(rng, (L, P, KVH, page, hs))
    v8, vs = _quantized(rng, (L, P, KVH, page, hs))
    pools = (k8, ks, v8, vs)
    for layer, pos, table, wpage, wrow in calls:
        q = rng.standard_normal((B, H, hs)).astype(np.float32)
        kn8, kns = _quantized(rng, (B, KVH, 1, hs))
        vn8, vns = _quantized(rng, (B, KVH, 1, hs))
        tp = [_t(a.copy()) for a in pools]
        att, *out = tpa.paged_decode_attention_q8_stacked(
            _t(q), *tp, _t(table), _t(kn8), _t(kns), _t(vn8), _t(vns), _t(wpage), _t(wrow), layer,
            _t(pos))
        assert all(a is b for a, b in zip(out, tp))
        ja, *jp = jpa.paged_decode_attention_q8_stacked(
            jnp.asarray(q), *(jnp.asarray(a) for a in pools), jnp.asarray(table),
            jnp.asarray(kn8), jnp.asarray(kns), jnp.asarray(vn8), jnp.asarray(vns),
            jnp.asarray(wpage), jnp.asarray(wrow), layer, jnp.asarray(pos), interpret=True)
        np.testing.assert_allclose(att.numpy(), np.asarray(ja), atol=ATOL, rtol=ATOL)
        _assert_pools(tp, jp, pools, wpage, wrow, layer)
        oracle = tpa.paged_attention_oracle(_t(q), tp[0][layer], tp[2][layer], _t(table), _t(pos),
                                            ks_pool=tp[1][layer], vs_pool=tp[3][layer])
        np.testing.assert_allclose(att.numpy(), oracle.numpy(), atol=3e-2)

        qkv = rng.standard_normal((B, H + 2 * KVH, hs)).astype(np.float32)
        cos_il, sin_il, cos, sin = _rope_tables(pos, hs)
        tp = [_t(a.copy()) for a in pools]
        att, *_ = tpa.paged_decode_attention_q8_fused(
            _t(qkv), *tp, _t(table), _t(cos_il), _t(sin_il), _t(wpage), _t(wrow), layer, _t(pos),
            n_heads=H)
        ja, *jp = jpa.paged_decode_attention_q8_fused(
            jnp.asarray(qkv), *(jnp.asarray(a) for a in pools), jnp.asarray(table),
            jnp.asarray(cos_il), jnp.asarray(sin_il), jnp.asarray(wpage), jnp.asarray(wrow), layer,
            jnp.asarray(pos), n_heads=H, interpret=True)
        np.testing.assert_allclose(att.numpy(), np.asarray(ja), atol=ATOL, rtol=ATOL)
        ulp = dict(rtol=2**-23, atol=0)
        _assert_pools(tp, jp, pools, wpage, wrow, layer, (None, ulp, None, ulp))
        q_rot = ref.apply_rope(_t(qkv)[:, None, :H], _t(np.asarray(cos)), _t(np.asarray(sin)))
        oracle = tpa.paged_attention_oracle(q_rot, tp[0][layer], tp[2][layer], _t(table), _t(pos),
                                            ks_pool=tp[1][layer], vs_pool=tp[3][layer])
        np.testing.assert_allclose(att.numpy(), oracle[:, 0].numpy(), atol=3e-2)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_forms_equal_rope_then_stacked(int8, dtype):
    """K17 = RoPE + K15 and K18 = RoPE + quantize + K16 on the same pools:
    the same outputs and pool bytes (``tests/test_paged.py``'s fused-vs-
    composed contracts; page 16, which no TPU rule allows for int8)."""
    H, KVH, hs, page = 4, 2, 32, 16
    rng = np.random.default_rng(3)
    P, calls = _setup(rng, page)
    layer, pos, table, wpage, wrow = calls[1]
    qkv = _t(rng.standard_normal((B, H + 2 * KVH, hs)).astype(np.float32)).to(dtype)
    cos_il, sin_il, cos, sin = (_t(np.asarray(a)) for a in _rope_tables(pos, hs))
    coords = (_t(wpage), _t(wrow), layer, _t(pos))
    if int8:
        k8, ks = _quantized(rng, (L, P, KVH, page, hs))
        v8, vs = _quantized(rng, (L, P, KVH, page, hs))
        fused, composed = ([_t(a.copy()) for a in (k8, ks, v8, vs)] for _ in range(2))
        att_f, *_ = tpa.paged_decode_attention_q8_fused(
            qkv, *fused, _t(table), cos_il, sin_il, *coords, n_heads=H)
        q, (kq, ksq, vq, vsq) = tq8.rope_quantize_plain(qkv, cos_il, sin_il, H)
        att_c, *_ = tpa.paged_decode_attention_q8_stacked(
            q.to(dtype), *composed, _t(table), kq[:, :, None], ksq[:, :, None], vq[:, :, None],
            vsq[:, :, None], *coords)
    else:
        init = [_t(rng.standard_normal((L, P, KVH, page, hs)).astype(np.float32)).to(dtype)
                for _ in range(2)]
        fused, composed = ([t.clone() for t in init] for _ in range(2))
        att_f, *_ = tpa.paged_decode_attention_fused(
            qkv, *fused, _t(table), cos_il, sin_il, *coords, n_heads=H)
        q = ref.apply_rope(qkv.float()[:, None, :H], cos, sin)[:, 0]
        k = ref.apply_rope(qkv.float()[:, None, H : H + KVH], cos, sin)[:, 0].to(dtype)
        att_c, *_ = tpa.paged_decode_attention_stacked(
            q, *composed, _t(table), k[:, :, None], qkv[:, H + KVH :, None], *coords)
    torch.testing.assert_close(att_f.float(), att_c.to(dtype).float(), atol=ATOL, rtol=ATOL)
    for a, b in zip(fused, composed):
        assert torch.equal(a, b)


def test_wrappers_reject_what_the_kernels_do_not_take():
    """The port's own limits, checked on CPU tensors too: T = 1, an even head
    size of at most 256, H % KVH == 0, int32 coordinates, matching shapes."""
    z = torch.zeros
    pools = (z(1, 3, 2, 16, 32), z(1, 3, 2, 16, 32))
    table, coord = z(2, 2, dtype=torch.int32), z(2, dtype=torch.int32)
    rows = (z(2, 2, 1, 32), z(2, 2, 1, 32))
    ok = (z(2, 4, 32), *pools, table, *rows, coord, coord, 0, coord)
    tpa.paged_decode_attention_stacked(*ok)  # the shapes it takes
    bad = [
        (z(2, 2, 4, 32), *pools, table, *rows, coord, coord, 0, coord),  # T = 2
        (z(2, 3, 32), *pools, table, *rows, coord, coord, 0, coord),  # H % KVH
        (z(2, 4, 32), *pools, table.long(), *rows, coord, coord, 0, coord),  # int64 table
        (z(2, 4, 32), *pools, table, *rows, coord, coord, 1, coord),  # layer out of range
        (z(2, 4, 32), *pools, table, z(2, 2, 1, 31), rows[1], coord, coord, 0, coord),
    ]
    for args in bad:
        with pytest.raises(ValueError):
            tpa.paged_decode_attention_stacked(*args)
    odd = (z(1, 3, 2, 16, 33), z(1, 3, 2, 16, 33))
    with pytest.raises(ValueError, match="even hs"):
        tpa.paged_decode_attention_fused(z(2, 8, 33), *odd, table, z(2, 33), z(2, 33), coord, coord,
                                         0, coord, n_heads=4)
    with pytest.raises(ValueError, match="int8"):
        tpa.paged_decode_attention_q8_stacked(
            z(2, 4, 32), pools[0], z(1, 3, 2, 16), pools[1], z(1, 3, 2, 16), table, *rows, *rows,
            coord, coord, 0, coord)
