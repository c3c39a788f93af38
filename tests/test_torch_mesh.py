"""The port's tensor- and data-parallel layout against the JAX package's, in
one process (no ranks spawned): the partition specs, every rank's slices of
params, Q8 params and caches against the JAX ``addressable_shards`` at its
mesh coordinate (8 virtual CPU devices), the shard-blocked fused layout,
``local_config`` and the support predicates' reasons, the sharded cache
load's read plan, the backend rule and the mesh's coordinates, and the
mesh entry points' refusals. The spawned ranks are in
``tests/test_torch_mesh_engine.py``."""

import dataclasses

import numpy as np
import pytest
import torch

from llama2_tpu.config import ModelConfig
from llama2_tpu.io.cache import shard_read_plan as jax_read_plan
from llama2_tpu.models import llama as jm
from llama2_tpu.parallel import sharding as js
from llama2_tpu.parallel import tp as jtp
from llama2_tpu.parallel.mesh import make_mesh as jax_mesh
from llama2_tpu.quant.q8 import quantize_params as jax_quantize
from llama2_tpu_torch.config import ModelConfig as TorchModelConfig
from llama2_tpu_torch.io import is_quantized
from llama2_tpu_torch.io.cache import load_cache_sharded, save_cache, shard_read_plan
from llama2_tpu_torch.models import llama as tm
from llama2_tpu_torch.parallel import distributed, sharding, tp
from llama2_tpu_torch.parallel.mesh import Mesh, make_mesh
from llama2_tpu_torch.quant.q8 import QuantTensor, quantize_params

MESHES = [(1, 2), (2, 2), (2, 4)]

# uneven on purpose: vocab 510 splits 2 ways but not 4, kv heads 2 give the
# head size the ways past them at tp 4, and at group 32 w2's (L, 6, D)
# scales split 2 ways but replicate at tp 4
CFG = ModelConfig(dim=64, hidden_dim=192, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=510, seq_len=16)
GROUP = 32


def tree(config=CFG, seed=0) -> dict:
    rng = np.random.default_rng(seed)

    def r(*s):
        return rng.standard_normal(s, np.float32) * 0.05

    L, D, HD, V, KV = config.n_layers, config.dim, config.hidden_dim, config.vocab_size, config.kv_dim
    return {
        "tok_emb": r(V, D), "rms_att": 1 + r(L, D), "wq": r(L, D, D), "wk": r(L, D, KV), "wv": r(L, D, KV),
        "wo": r(L, D, D), "rms_ffn": 1 + r(L, D), "w1": r(L, D, HD), "w2": r(L, HD, D), "w3": r(L, D, HD),
        "rms_final": 1 + r(D), "wcls": r(D, V),
    }


def port_config(c: ModelConfig) -> TorchModelConfig:
    return TorchModelConfig(**dataclasses.asdict(c))


def q8_trees(config=CFG, seed=0):
    """The same Q8 bytes in both packages: (JAX tree, port tree)."""
    t = tree(config, seed)
    return jax_quantize(t, group_size=GROUP), quantize_params({k: torch.from_numpy(v) for k, v in t.items()}, GROUP)


def caches(config=CFG, batch=4):
    rng = np.random.default_rng(7)
    shape = (config.n_layers, batch, config.n_kv_heads, config.seq_len, config.head_size)
    return {
        "fp": {"k": rng.standard_normal(shape, np.float32), "v": rng.standard_normal(shape, np.float32)},
        "int8": {
            "k": rng.integers(-127, 128, shape, dtype=np.int8), "k_scale": rng.random(shape[:-1], np.float32),
            "v": rng.integers(-127, 128, shape, dtype=np.int8), "v_scale": rng.random(shape[:-1], np.float32),
        },
    }


def jax_spec(spec, ndim: int) -> tuple:
    s = tuple(spec)
    return s + (None,) * (ndim - len(s))


def coord_of(mesh, device) -> tuple[int, int]:
    d, t = np.argwhere(mesh.devices == device)[0]
    return int(d), int(t)


def shards_of(array, mesh):
    """``{(data, model) coordinate: numpy shard}`` of a JAX global array."""
    return {coord_of(mesh, s.device): np.asarray(s.data) for s in array.addressable_shards}


@pytest.mark.parametrize("dp,tpn", MESHES)
def test_specs_equal_jax(dp, tpn):
    jmesh = jax_mesh(dp, tpn)
    t = tree()
    jq, pq = q8_trees()
    want = js.param_specs(t, jmesh)
    got = sharding.param_specs(t, (dp, tpn))
    assert got == {k: jax_spec(v, t[k].ndim) for k, v in want.items()}
    for k, v in pq.items():  # a QuantTensor's q and scale spec'd each by its own shape
        if isinstance(v, QuantTensor):
            for a, b in ((v.q, jq[k].q), (v.scale, jq[k].scale)):
                assert sharding.leaf_spec(k, a.shape, (dp, tpn)) == jax_spec(js.leaf_spec(k, b.shape, jmesh), b.ndim)
    if tpn == 4:  # the sidecar case: w2's scale groups do not split, the q does
        assert sharding.leaf_spec("w2", pq["w2"].scale.shape, (dp, tpn)) == (None, None, None)
        assert sharding.leaf_spec("w2", pq["w2"].q.shape, (dp, tpn)) == (None, "model", None)
    for c in caches().values():
        assert sharding.cache_specs(c, (dp, tpn)) == {
            k: jax_spec(v, c[k].ndim) for k, v in js.cache_specs(c, jmesh).items()
        }


@pytest.mark.parametrize("dp,tpn", MESHES)
def test_every_rank_slice_equals_the_jax_shard(dp, tpn):
    jmesh = jax_mesh(dp, tpn)
    t = tree()
    jq, pq = q8_trees()
    jt, jqs = js.shard_params(t, jmesh), js.shard_params(jq, jmesh)
    for rank in range(dp * tpn):
        mesh = Mesh(dp, tpn, rank, device="cpu")
        coord = mesh.coord
        fp, q8 = sharding.shard_params(t, mesh), sharding.shard_params(pq, mesh)
        assert q8.mesh_shape == (dp, tpn) and q8.coord == coord
        for k in t:
            np.testing.assert_array_equal(fp[k], shards_of(jt[k], jmesh)[coord])
            np.testing.assert_array_equal(
                sharding.local_slice(t[k], sharding.leaf_spec(k, t[k].shape, mesh), coord, mesh), fp[k]
            )
            if isinstance(pq[k], QuantTensor):
                np.testing.assert_array_equal(q8[k].q.numpy(), shards_of(jqs[k].q, jmesh)[coord])
                np.testing.assert_array_equal(q8[k].scale.numpy(), shards_of(jqs[k].scale, jmesh)[coord])
                assert q8[k].q.is_contiguous() and q8[k].group_size == GROUP
        for c in caches().values():
            jc = js.shard_cache(c, jmesh)
            local = sharding.shard_cache(c, mesh)
            for k in c:
                np.testing.assert_array_equal(local[k], shards_of(jc[k], jmesh)[coord])


@pytest.mark.parametrize("shards", [2, 4])
def test_fuse_shard_blocked_equals_jax_and_rank_fuse_is_its_chunk(shards):
    jq, pq = q8_trees()
    want = jm.fuse_layer_params(jq, "pallas", shards)
    got = tm.fuse_layer_params(pq, "cuda", shards)
    assert set(got) == set(want) and "w13" not in got
    for k in ("wqkv", "w1", "w3"):
        np.testing.assert_array_equal(got[k].q.numpy(), np.asarray(want[k].q))
        np.testing.assert_array_equal(got[k].scale.numpy(), np.asarray(want[k].scale))
    n = got["wqkv"].q.shape[-1] // shards
    for t in range(shards):
        local = tm.fuse_layer_params(sharding.shard_params(pq, Mesh(1, shards, t, device="cpu")), "cuda")
        assert isinstance(local, sharding.LocalParams) and local.coord == (0, t)
        np.testing.assert_array_equal(local["wqkv"].q.numpy(), got["wqkv"].q[..., t * n : (t + 1) * n].numpy())
        np.testing.assert_array_equal(
            local["wqkv"].scale.numpy(), got["wqkv"].scale[..., t * n : (t + 1) * n].numpy()
        )


def test_local_config_and_support_reasons_match_jax():
    for c, n in ((CFG, 2), (dataclasses.replace(CFG, n_kv_heads=4), 4)):
        assert dataclasses.asdict(tp.local_config(port_config(c), n)) == dataclasses.asdict(jtp.local_config(c, n))
    jq, pq = q8_trees()
    t = tree()
    cases = [
        (CFG, jq, pq, 2),  # shards
        (dataclasses.replace(CFG, n_kv_heads=4), jq, pq, 4),  # wo's scale groups do not split
        (CFG, t, {k: torch.from_numpy(v) for k, v in t.items()}, 2),  # fp weights
        (dataclasses.replace(CFG, n_heads=2, n_kv_heads=2), jq, pq, 4),  # heads
        (dataclasses.replace(CFG, n_kv_heads=1), jq, pq, 2),  # kv heads
        (dataclasses.replace(CFG, hidden_dim=190), jq, pq, 4),  # hidden
    ]
    reasons = []
    for c, jp, pp, n in cases:
        want = jtp.tp_pallas_supported(jp, c, jax_mesh(1, n))
        got = tp.tp_cuda_supported(pp, port_config(c), (1, n))
        assert got == want
        reasons.append(got[1])
        # the plain path's (and the ring's) rule: divisibility alone, fp or Q8 weights
        assert tp.tp_ring_supported(pp, port_config(c), (1, n)) == jtp.tp_ring_supported(jp, c, jax_mesh(1, n))
    assert reasons[0] == "" and "wo scale groups" in reasons[1] and "QuantTensor" in reasons[2]
    # the plain path shards the fp tree and the Q8 one at tp 2, not at tp 4 (wo's scales)
    assert tp.tp_ring_supported(t, port_config(CFG), (1, 2)) == (True, "")
    assert tp.tp_ring_supported(pq, port_config(dataclasses.replace(CFG, n_kv_heads=4)), (1, 4)) == (
        False, "wo scales not divisible by tp=4")


def test_shard_read_plan_and_sharded_load_equal_jax(tmp_path):
    jq, pq = q8_trees()
    save_cache(str(tmp_path), port_config(CFG), pq)
    for dp, tpn in ((1, 2), (2, 2), (2, 4)):
        assert shard_read_plan(str(tmp_path), (dp, tpn)) == jax_read_plan(str(tmp_path), jax_mesh(dp, tpn))
        for rank in range(dp * tpn):
            mesh = Mesh(dp, tpn, rank, device="cpu")
            config, local, shared = load_cache_sharded(str(tmp_path), mesh)
            assert config == port_config(CFG) and not shared and local.coord == mesh.coord
            for k, v in pq.items():
                if isinstance(v, QuantTensor):
                    for part, whole in ((local[k].q, v.q), (local[k].scale, v.scale)):
                        spec = sharding.leaf_spec(k, whole.shape, mesh)
                        assert torch.equal(part, sharding.local_slice(whole, spec, mesh.coord, mesh))
                else:
                    spec = sharding.leaf_spec(k, v.shape, mesh)
                    np.testing.assert_array_equal(local[k], sharding.local_slice(v, spec, mesh.coord, mesh))
    # a Q8 cache is served under --mesh --quant int8; an fp32 one is refused
    assert is_quantized(str(tmp_path))
    save_cache(str(tmp_path / "fp"), port_config(CFG), tree())
    assert not is_quantized(str(tmp_path / "fp"))
    # the bytes a rank reads: its slices only
    plan = shard_read_plan(str(tmp_path), (1, 2))
    wq = next(p for p in plan if p.endswith("wq.q.npy"))
    assert plan[wq] == {0: pq["wq"].q.numel() // 2, 1: pq["wq"].q.numel() // 2}


def test_backend_rule_mesh_coordinates_and_rows():
    assert distributed.backend_rule(2, "cuda", cards=1) == ("gloo", "[mesh] 2 ranks share cuda:0: gloo")
    assert distributed.backend_rule(4, "cuda", cards=1)[0] == "gloo"
    assert distributed.backend_rule(4, "cuda", cards=2) == ("gloo", "[mesh] 4 ranks share 2 cards: gloo")
    assert distributed.backend_rule(2, "cuda", cards=4) == ("nccl", "[mesh] 2 ranks on 4 cards, one each: nccl")
    assert distributed.backend_rule(4, "cpu") == ("gloo", "[mesh] 4 ranks on the CPU: gloo")
    assert distributed.rank_device(3, "cpu") == torch.device("cpu")
    # no process group here: one rank
    assert make_mesh(1, 1, "cpu").shape == {"data": 1, "model": 1} and make_mesh(device="cpu").coord == (0, 0)
    with pytest.raises(ValueError, match="needs 2 ranks"):
        make_mesh(1, 2, "cpu")
    with pytest.raises(ValueError, match="not divisible by dp=3"):
        make_mesh(3, device="cpu")
    m = Mesh(2, 2, rank=3, device="cpu")
    assert m.coord == (1, 1) and m.size == 4
    r = m.replicated_over_model()
    assert (r.dp, r.tp, r.coord) == (2, 1, (1, 0))
    assert tp.batch_rows(8, m) == slice(4, 8) and tp.batch_rows(1, m) == slice(0, 1)
    with pytest.warns(UserWarning, match="does not divide dp=2"):
        assert tp.batch_rows(3, m) == slice(0, 3)
    assert tp.batch_rows(8, Mesh(1, 2, rank=1, device="cpu")) == slice(0, 8)


def test_mesh_entry_points_refuse(tiny_checkpoint, capsys):
    from llama2_tpu_torch.runtime import server as srv
    from llama2_tpu_torch.runtime.batch_engine import BatchEngine
    from llama2_tpu_torch.runtime.paged_engine import PagedBatchEngine

    path, _, _ = tiny_checkpoint
    for flags, msg in (
        # the paged engine serves a mesh now; the ring still needs one
        (["--paged", "--collective-matmul"], "--collective-matmul requires --mesh"),
        (["--mesh", "2x"], "--mesh must look like 2x4"),
        (["--mesh", "1x2", "--precompile", "8"], "--precompile"),
        (["--collective-matmul"], "--collective-matmul requires --mesh"),
        # quantizing would put the whole fp32 model on the device once a rank
        (["--mesh", "1x2", "--quant", "int8"], "write a Q8 param cache first"),
    ):
        assert srv.main([path, "--platform", "cpu", *flags]) == 1
        assert msg in capsys.readouterr().err
    if not torch.cuda.is_available():  # without a card the mesh never runs on the CPU
        assert srv.main([path, "--mesh", "1x2"]) == 1
        assert "no CUDA device" in capsys.readouterr().err
        _, pq = q8_trees()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            BatchEngine(port_config(CFG), pq, mesh=Mesh(1, 1, device=torch.device("cuda")))
    _, pq = q8_trees()
    # the ring runs now; a model whose heads do not split over tp is refused, with the JAX reason
    with pytest.raises(ValueError, match="collective='ring' unsupported here: tp=2 does not divide the head counts"):
        BatchEngine(port_config(dataclasses.replace(CFG, n_kv_heads=1)), pq, device="cpu",
                    mesh=Mesh(1, 2, device="cpu"), collective="ring")
    with pytest.raises(ValueError, match="unknown collective 'tree'"):
        BatchEngine(port_config(CFG), pq, device="cpu", mesh=Mesh(1, 1, device="cpu"), collective="tree")
    # a paged engine's ring needs the paged mesh path, which a 1x1 mesh does not take
    with pytest.raises(ValueError, match="requires the paged mesh path"):
        PagedBatchEngine(port_config(CFG), pq, device="cpu", page_size=8, mesh=Mesh(1, 1, device="cpu"),
                         collective="ring")
    # the engine takes the whole tree and cuts a rank's slices itself
    with pytest.raises(TypeError, match="whole param tree"):
        BatchEngine(port_config(CFG), sharding.shard_params(pq, Mesh(1, 1, device="cpu")), device="cpu",
                    mesh=Mesh(1, 1, device="cpu"))
    # the classifier under a tensor-parallel mesh reads a rank's record
    with pytest.raises(ValueError, match="shards"):
        tm.logits_from_hidden(pq, torch.zeros(1, CFG.dim), "torch", Mesh(1, 2, device="cpu"))


def test_parallel_entry_points_default_to_the_card():
    """The card unless the caller asks for the CPU: without one,
    ``distributed.initialize``'s device rule, ``make_mesh``,
    ``single_device_mesh`` and ``Mesh`` raise (the counterpart of the
    engine's check above); with ``device="cpu"`` they run here."""
    from llama2_tpu_torch.parallel.mesh import single_device_mesh

    if torch.cuda.is_available():
        pytest.skip("a card is here: the default is it")
    for build in (lambda: distributed.initialize(), lambda: make_mesh(1, 1), single_device_mesh,
                  lambda: Mesh(1, 2, rank=1)):
        with pytest.raises(RuntimeError, match="no CUDA device available; pass device='cpu'"):
            build()
    distributed.initialize(device="cpu")  # one rank: a no-op
    assert make_mesh(1, 1, "cpu").device == single_device_mesh("cpu").device == torch.device("cpu")
