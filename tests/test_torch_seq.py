"""The port's ``seq`` families in spawned gloo ranks on the CPU
(``parallel/distributed.py::launch`` with ``axis="seq"``), fp32, against
their JAX twins on the 8-device virtual mesh, under the JAX tests' own
tolerances:

* ``parallel/ring.py``: ``ring_attention`` at S = 2 and 4, with and
  without GQA (2e-5), at S = 1, the indivisible ``ValueError``, the hops
  (S - 1 a call);
* ``parallel/sp.py``: ``sp_prefill`` at S = 2 and 4 (hidden 3e-5, KV
  2e-5) and at seq x model 2x2, ``cache_from_segments`` (over ``seq``, and
  over ``model`` where the kv heads are cut), then a greedy decode from the
  gathered cache token-identical to the port ``Generator``;
* ``parallel/ring_decode.py``: ``SeqShardedDecoder`` at sp = 2, 4 and 2x2
  token-identical to the JAX decoder and to the port ``Generator``; a rank's
  cache rows ``seq_len / sp``; the empty prompt and the BOS stop; the
  indivisible ``seq_len``; the overlong prompt; batched rows equal to
  per-prompt runs; sampled rows equal to the port ``Generator`` at ``seed +
  b``; ``_append_local`` on a window straddling two ranks;
* the CLI's ``--seq-shards 2 --platform cpu``: the plain run's bytes;
  ``--quant int8`` exits 1 with the JAX message;
* a ``seq`` mesh handed to the engines raises.

The three launches (2, 4 and 2x2 ranks) start together from one module
fixture; the rank functions import nothing of JAX (the ranks import this
module), and get the seeded numpy params as arguments."""

import numpy as np
import pytest
import torch

from llama2_tpu_torch.config import GenerationConfig, ModelConfig
from llama2_tpu_torch.parallel import distributed

DEADLINE = 120.0  # a launch's ranks, all together
TIMEOUT = 30.0  # a collective

# conftest's tiny_config: 3 layers, 4 heads over 2 kv heads, seq_len 96
CFG = dict(dim=64, hidden_dim=172, n_layers=3, n_heads=4, n_kv_heads=2, vocab_size=512, seq_len=96)
PROMPT = [5, 9, 301, 77]
STEPS = 40
BATCH = [[5, 9, 301, 77], [11], [], [42, 8, 13, 200, 6]]
BATCH_STEPS = 28
SAMPLED = dict(temperature=0.8, top_p=0.9, steps=24, seed=13)
SAMPLED_PROMPTS = [[5, 9, 301], [42, 8]]
SP_PROMPT_LEN = 15  # [BOS] + 15 tokens: a 16-token segment, then greedy decode to position 24
SP_DECODE_TO = 24
LAUNCHES = {"2": (2, 1), "4": (4, 1), "2x2": (2, 2)}


def qkv(B, T, H, KVH, hs, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s, dtype=np.float32) for s in ((B, T, H, hs), (B, T, KVH, hs), (B, T, KVH, hs))]


def segment(seed: int, T: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, CFG["vocab_size"], (1, T)).astype(np.int64)


def sp_prompt() -> list[int]:
    return [int(t) for t in np.random.default_rng(11).integers(2, CFG["vocab_size"], SP_PROMPT_LEN)]


# ---- what the ranks run ----


def ring_math(mesh) -> dict:
    """ring_attention at this S, without and with GQA, and its hops."""
    from llama2_tpu_torch.parallel import ring

    out = {}
    for gqa in (False, True):
        q, k, v = qkv(2, 32, 4, 2 if gqa else 4, 16)
        h0 = ring.hops
        out[gqa] = ring.ring_attention(q, k, v, mesh).numpy()
        out["hops", gqa] = ring.hops - h0
    return out


def sp_then_decode(mesh, params) -> dict:
    """sp_prefill of [BOS] + the prompt, its segments gathered into a dense
    cache, then greedy decode from it on this rank alone."""
    from llama2_tpu_torch.io.convert import params_from_numpy
    from llama2_tpu_torch.models.llama import forward, init_cache, logits_from_hidden
    from llama2_tpu_torch.parallel import ring
    from llama2_tpu_torch.parallel.sp import SEQ_AXIS, cache_from_segments, sp_prefill
    from llama2_tpu_torch.parallel.tp import gather

    config = ModelConfig(**CFG)
    feed = np.asarray([[1] + sp_prompt()])
    h0 = ring.hops
    hidden, k_seg, v_seg = sp_prefill(params, feed, config, mesh)
    hops = ring.hops - h0
    hidden = gather(hidden, mesh.group(SEQ_AXIS), 1)
    cache = cache_from_segments(init_cache(config, 1), k_seg, v_seg, mesh)
    tp = params_from_numpy(params, "cpu")
    tok = int(torch.argmax(logits_from_hidden(tp, hidden[:, -1])[0]))
    generated = []
    for pos in range(feed.shape[1], SP_DECODE_TO + 1):
        if tok == 1:
            break
        generated.append(tok)
        if pos == SP_DECODE_TO:
            break
        h = forward(tp, cache, torch.tensor([[tok]]), pos, config, "torch")
        tok = int(torch.argmax(logits_from_hidden(tp, h[:, -1])[0]))
    return {"generated": generated, "prefill_hops": hops}


def seq_rank(mesh, params) -> dict:
    from llama2_tpu_torch.parallel.ring_decode import SeqShardedDecoder
    from llama2_tpu_torch.parallel.sp import cache_from_segments, sp_prefill
    from llama2_tpu_torch.models.llama import init_cache

    torch.manual_seed(0)
    config = ModelConfig(**CFG)
    sp, tp = mesh.shape["seq"], mesh.tp
    out = {"coord": mesh.coord}
    dec = SeqShardedDecoder(config, params, mesh)
    out["stream"] = dec.generate(PROMPT, STEPS)
    out["cache_shape"] = tuple(dec._cache(1)[0].shape)
    if tp == 1:
        out["ring"] = ring_math(mesh)
        hidden, k_seg, v_seg = sp_prefill(params, segment(7, 32), config, mesh)
        out["sp"] = (hidden.numpy(), k_seg.numpy(), v_seg.numpy())
    else:
        hidden, k_seg, v_seg = sp_prefill(params, segment(13, 16), config, mesh, model_axis=True)
        filled = cache_from_segments(init_cache(config, 1), k_seg, v_seg, mesh)
        out["sp"] = (hidden.numpy(), k_seg.numpy(), v_seg.numpy())
        out["filled"] = (filled["k"][:, :, :, :16].numpy(), filled["v"][:, :, :, :16].numpy())
    if sp == 2 and tp == 1:
        out["empty"] = dec.generate([], 24)
        out["sampled"] = dec.generate_batch(SAMPLED_PROMPTS, GenerationConfig(**SAMPLED))
        out["distinct"] = dec.generate_batch([[7, 7], [7, 7]], GenerationConfig(temperature=1.0, top_p=0.9,
                                                                                  steps=20, seed=3))
        out.update(sp_then_decode(mesh, params))
    if sp == 4:
        out["batch"] = dec.generate_batch(BATCH, GenerationConfig(temperature=0.0, steps=BATCH_STEPS, seed=0))
    return out


# ---- the launches, and the references in this process ----


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The one-card references run on one thread, as the ranks do."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def params():
    from conftest import random_params, tiny_config

    return random_params(tiny_config())


def jax_references(params) -> dict:
    """Every JAX result the file holds the port to, one call a shape."""
    import jax.numpy as jnp
    from conftest import tiny_config

    from llama2_tpu.models.llama import forward, init_cache
    from llama2_tpu.parallel.ring import ring_attention
    from llama2_tpu.parallel.ring_decode import SeqShardedDecoder
    from llama2_tpu.parallel.sp import make_seq_mesh, make_sp_tp_mesh, sp_prefill

    config = tiny_config()
    pj = {k: jnp.asarray(v) for k, v in params.items()}
    out = {}
    for S in (2, 4):
        for gqa in (False, True):
            q, k, v = (jnp.asarray(a) for a in qkv(2, 32, 4, 2 if gqa else 4, 16))
            out["ring", S, gqa] = np.asarray(ring_attention(q, k, v, make_seq_mesh(S)))
        out["sp", S] = [np.asarray(a) for a in sp_prefill(pj, jnp.asarray(segment(7, 32), jnp.int32), config,
                                                          make_seq_mesh(S))]
    tokens = jnp.asarray(segment(13, 16), jnp.int32)
    out["sp", "2x2"] = [np.asarray(a) for a in sp_prefill(pj, tokens, config, make_sp_tp_mesh(2, 2),
                                                          model_axis="model")]
    _, cache = forward(pj, init_cache(config, 1), tokens, 0, config)
    out["dense-2x2"] = (np.asarray(cache["k"][:, :, :, :16]), np.asarray(cache["v"][:, :, :, :16]))
    for name, (sp, tp) in LAUNCHES.items():
        mesh = make_seq_mesh(sp) if tp == 1 else make_sp_tp_mesh(sp, tp)
        out["decoder", name] = SeqShardedDecoder(config, params, mesh).generate(PROMPT, STEPS)
    return out


@pytest.fixture(scope="module")
def ranks(params):
    """``({launch name: the ranks' results}, the JAX references)``: every
    launch started together, the references computed while the ranks run."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=len(LAUNCHES)) as pool:
        futures = {name: pool.submit(distributed.launch, seq_rank, sp, tp, "cpu", params, axis="seq",
                                     deadline=DEADLINE, timeout=TIMEOUT, libraries=())
                   for name, (sp, tp) in LAUNCHES.items()}
        refs = jax_references(params)
        return {name: f.result() for name, f in futures.items()}, refs


_REF: dict = {}


def generator_stream(params, prompt, gen: dict) -> list[int]:
    """The port Generator's stream (fp32, ``backend="torch"``, the CPU)."""
    from llama2_tpu_torch.runtime.generator import Generator

    key = (tuple(prompt), tuple(sorted(gen.items())))
    if key not in _REF:
        g = Generator(ModelConfig(**CFG), params, backend="torch", device="cpu")
        _REF[key] = g.generate(prompt, GenerationConfig(**gen)).tokens
    return _REF[key]


def rows_of(whole: np.ndarray, i: int, n: int, axis: int) -> np.ndarray:
    c = whole.shape[axis] // n
    return np.take(whole, range(i * c, (i + 1) * c), axis=axis)


@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("gqa", [False, True])
def test_ring_attention_matches_jax(ranks, S, gqa):
    results, refs = ranks
    want = refs["ring", S, gqa]
    for i, res in enumerate(results[str(S)]):
        np.testing.assert_allclose(res["ring"][gqa], rows_of(want, i, S, 1), atol=2e-5)


def test_ring_attention_single_shard_and_hops(ranks):
    from llama2_tpu_torch.parallel.mesh import make_seq_mesh
    from llama2_tpu_torch.parallel.ring import dense_causal_attention, ring_attention

    q, k, v = (torch.from_numpy(a) for a in qkv(1, 8, 2, 2, 8, seed=3))
    np.testing.assert_allclose(ring_attention(q, k, v, make_seq_mesh(1, "cpu")).numpy(),
                               dense_causal_attention(q, k, v).numpy(), atol=2e-5)
    results, _ = ranks
    for S in (2, 4):
        for res in results[str(S)]:
            assert res["ring"]["hops", False] == res["ring"]["hops", True] == S - 1
    L = CFG["n_layers"]
    assert all(res["prefill_hops"] == L * 1 for res in results["2"])


def test_ring_attention_rejects_indivisible():
    from llama2_tpu_torch.parallel.mesh import Mesh
    from llama2_tpu_torch.parallel.ring import ring_attention

    q, k, v = qkv(1, 30, 2, 2, 8)
    with pytest.raises(ValueError, match="not divisible"):
        ring_attention(q, k, v, Mesh(4, 1, 0, "cpu", axis="seq"))


@pytest.mark.parametrize("S", [2, 4])
def test_sp_prefill_matches_jax(ranks, S):
    results, refs = ranks
    hidden, k_seg, v_seg = refs["sp", S]
    for i, res in enumerate(results[str(S)]):
        h, k, v = res["sp"]
        np.testing.assert_allclose(h, rows_of(hidden, i, S, 1), atol=3e-5)
        np.testing.assert_allclose(k, rows_of(k_seg, i, S, 3), atol=2e-5)
        np.testing.assert_allclose(v, rows_of(v_seg, i, S, 3), atol=2e-5)


def test_sp_tp_prefill_and_gathered_cache_match_jax(ranks):
    """seq x model 2x2: each rank's hidden rows and its kv heads' KV rows
    against JAX's ``make_sp_tp_mesh(2, 2)`` run; the gathered cache against
    the JAX dense forward's."""
    results, refs = ranks
    hidden, k_seg, v_seg = refs["sp", "2x2"]
    k_dense, v_dense = refs["dense-2x2"]
    for res in results["2x2"]:
        s, t = res["coord"]
        h, k, v = res["sp"]
        np.testing.assert_allclose(h, rows_of(hidden, s, 2, 1), atol=3e-5)
        np.testing.assert_allclose(k, rows_of(rows_of(k_seg, s, 2, 3), t, 2, 2), atol=2e-5)
        np.testing.assert_allclose(v, rows_of(rows_of(v_seg, s, 2, 3), t, 2, 2), atol=2e-5)
        np.testing.assert_allclose(res["filled"][0], k_dense, atol=2e-5)
        np.testing.assert_allclose(res["filled"][1], v_dense, atol=2e-5)


def test_cache_from_segments_then_decode_matches_generator(ranks, params):
    want = generator_stream(params, sp_prompt(), dict(temperature=0.0, steps=SP_DECODE_TO))[SP_PROMPT_LEN:]
    assert want
    for res in ranks[0]["2"]:
        assert res["generated"] == want


@pytest.mark.parametrize("name", ["2", "4", "2x2"])
def test_seq_decoder_matches_jax_and_generator(ranks, params, name):
    results, refs = ranks
    want = generator_stream(params, PROMPT, dict(temperature=0.0, steps=STEPS))
    assert want == refs["decoder", name]
    for res in results[name]:
        assert res["stream"] == want


def test_cache_rows_a_rank(ranks):
    """A rank's cache: ``seq_len / sp`` rows of its ``n_kv_heads / tp``
    heads, on every rank alike."""
    c = ModelConfig(**CFG)
    for name, (sp, tp) in LAUNCHES.items():
        for res in ranks[0][name]:
            assert res["cache_shape"] == (c.n_layers, 1, c.n_kv_heads // tp, c.seq_len // sp, c.head_size)


def test_empty_prompt_and_bos_stop(ranks, params):
    want = generator_stream(params, [], dict(temperature=0.0, steps=24))
    for res in ranks[0]["2"]:
        assert res["empty"] == want


def test_indivisible_seq_len_and_overlong_prompt_rejected(params):
    from llama2_tpu_torch.parallel.mesh import Mesh
    from llama2_tpu_torch.parallel.ring_decode import SeqShardedDecoder

    config = ModelConfig(**CFG)  # seq_len 96; 96 % 5 != 0
    with pytest.raises(ValueError, match="not divisible"):
        SeqShardedDecoder(config, params, Mesh(5, 1, 0, "cpu", axis="seq"))
    dec = SeqShardedDecoder(config, params, Mesh(2, 1, 0, "cpu", axis="seq"))
    with pytest.raises(ValueError, match="exceeds"):
        dec.generate(list(range(3, 3 + config.seq_len)), 4)
    with pytest.raises(ValueError, match="'seq' axis"):
        SeqShardedDecoder(config, params, Mesh(2, 1, 0, "cpu"))


def test_batched_streams_match_per_prompt_runs(ranks, params):
    for res in ranks[0]["4"]:
        for p, row in zip(BATCH, res["batch"]):
            assert row == generator_stream(params, p, dict(temperature=0.0, steps=BATCH_STEPS)), p


def test_sampled_rows_match_generator_at_seed_plus_b(ranks, params):
    for res in ranks[0]["2"]:
        for b, (p, row) in enumerate(zip(SAMPLED_PROMPTS, res["sampled"])):
            assert row == generator_stream(params, p, dict(SAMPLED, seed=SAMPLED["seed"] + b)), b
        a, b = res["distinct"]
        assert a != b  # row b draws with seed + b


def test_append_local_straddle_window():
    """A 3-row window at global rows 6-8 over two ranks of 8 rows each: each
    rank keeps exactly its own rows, as the JAX ``_append_local`` does."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from llama2_tpu.parallel.ring_decode import _append_local as jax_append
    from llama2_tpu.parallel.sp import SEQ_AXIS, make_seq_mesh

    from llama2_tpu_torch.parallel.ring_decode import _append_local

    sp, S, T = 2, 16, 3
    s_local = S // sp
    rows = np.broadcast_to(np.arange(1.0, T + 1, dtype=np.float32)[None, None, :, None], (1, 1, T, 4))
    got = np.concatenate([_append_local(torch.zeros(1, 1, s_local, 4), torch.from_numpy(rows.copy()), 8,
                                        i * s_local, s_local).numpy() for i in range(sp)], axis=2)

    def region(c, r):
        return jax_append(c, r, jnp.int32(8), my_off=jax.lax.axis_index(SEQ_AXIS) * s_local, s_local=s_local)

    jax_out = jax.jit(jax.shard_map(region, mesh=make_seq_mesh(sp),
                                    in_specs=(P(None, None, SEQ_AXIS, None), P(None, None, None, None)),
                                    out_specs=P(None, None, SEQ_AXIS, None), check_vma=False))(
        jnp.zeros((1, 1, S, 4), jnp.float32), jnp.asarray(rows))
    want = np.zeros(S, np.float32)
    want[6], want[7], want[8] = 1.0, 2.0, 3.0
    np.testing.assert_array_equal(got[0, 0, :, 0], want)
    np.testing.assert_array_equal(got, np.asarray(jax_out))


def run_main(capsys, *argv):
    from llama2_tpu_torch import cli

    try:
        rc = cli.main(list(argv))
    except SystemExit as e:
        rc = e.code
    out = capsys.readouterr()
    return rc, out.out, out.err


def test_cli_seq_shards_matches_plain(capsys, tiny_checkpoint):
    """``--seq-shards 2 --platform cpu`` prints the plain run's bytes, and
    logs the shards and the rows a shard."""
    from conftest import TOKENIZER_BIN

    args = [tiny_checkpoint[0], "-t", "0", "-n", "24", "-z", TOKENIZER_BIN, "--platform", "cpu"]
    rc, want, _ = run_main(capsys, *args)
    assert rc == 0 and want
    rc, got, err = run_main(capsys, *args, "--seq-shards", "2", "-v", "--kernels", "cuda")
    assert rc == 0 and got == want, err
    assert "seq shards: 2 (rows per shard: 48)" in err and "tokens per second" in err
    assert "--kernels does not apply to --seq-shards" in err


def test_cli_seq_shards_refuses_int8(capsys, tiny_checkpoint):
    rc, out, err = run_main(capsys, tiny_checkpoint[0], "--quant", "int8", "--seq-shards", "2", "--platform", "cpu")
    assert rc == 1 and out == ""
    assert "--quant int8 is not supported on this path" in err


def test_seq_mesh_is_never_a_data_mesh(params):
    """The mesh names its leading axis; the engines refuse a ``seq`` mesh;
    the builders need as many ranks as the mesh has."""
    from llama2_tpu_torch.parallel.mesh import Mesh, make_seq_mesh, make_sp_tp_mesh
    from llama2_tpu_torch.runtime.batch_engine import BatchEngine
    from llama2_tpu_torch.runtime.paged_engine import PagedBatchEngine

    mesh = Mesh(2, 2, 3, "cpu", axis="seq")
    assert mesh.shape == {"seq": 2, "model": 2} and mesh.index("seq") == 1 and mesh.index("model") == 1
    with pytest.raises(KeyError):
        mesh.group("data")
    config = ModelConfig(**CFG)
    for make in (lambda: BatchEngine(config, params, batch_size=2, backend="torch", device="cpu", mesh=mesh),
                 lambda: PagedBatchEngine(config, params, batch_size=2, backend="torch", device="cpu", mesh=mesh,
                                          page_size=8, n_pages=8)):
        with pytest.raises(ValueError, match="leads with 'seq'"):
            make()
    assert make_seq_mesh(1, "cpu").shape == {"seq": 1, "model": 1}
    with pytest.raises(ValueError, match="needs 4 ranks"):
        make_sp_tp_mesh(2, 2, "cpu")
