"""The production launch stack of the port against the JAX package's:
the model's sharding specs (``param_specs``, ``cache_specs``,
``batch_specs``) equal ``param_pspecs``, ``cache_pspecs`` and
``batch_pspecs`` read as tuples for every arch, specs only (no XLA
compile); ``plan_decode``, ``train_seq_len``, the score-traffic estimate,
the model-FLOP counts and the roofline equal JAX's on the same inputs;
``placements`` on a (2, 4, 2) mesh; and the dry run on torch's fake
process group: its per-device argument bytes equal a count from JAX's
specs and shapes, every reduced family's train and decode steps count
FLOPs on a (4, 2) mesh, and the gossip schedule exchanges point to point
where the dense one all-gathers.  ``constrain`` returns a plain tensor
itself."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from jax.sharding import PartitionSpec as P  # noqa: E402

from _jax_caches import fresh_jax_caches  # noqa: E402,F401
from _port_session import port_background_jobs  # noqa: E402,F401
from repro.configs import ALIASES  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.launch import hlo_analysis as jha  # noqa: E402
from repro.launch import shapes as jshapes  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.optim import AdamWConfig as JAdamWConfig  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.launch import (cost, dryrun, mesh, shapes,  # noqa: E402
                                sharding)
from repro_torch.launch.shapes import InputShape  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.common import constrain  # noqa: E402

ARCHS = sorted(set(ALIASES.values()))
FAMILIES = ("llama3_8b", "olmoe_1b_7b", "xlstm_1_3b", "recurrentgemma_2b",
            "qwen2_vl_7b", "musicgen_medium")
SMALL = (4, 2)                         # (data, model), as the JAX test's


def as_tuples(tree):
    return jax.tree_util.tree_map(tuple, tree,
                                  is_leaf=lambda s: isinstance(s, P))


@pytest.fixture(scope="module")
def fake_world():
    """The fake process group, torn down after the module."""
    import torch.distributed as dist
    yield dryrun.init_fake
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_equal_jax(arch):
    jm = JModel(jget(arch, "full"))
    tm = Model(tget(arch, "full"), device="meta")
    assert tm.param_specs() == as_tuples(jm.param_pspecs())
    assert tm.cache_specs() == as_tuples(jm.cache_pspecs())
    for mode in ("train", "decode"):
        assert tm.batch_specs(mode) == as_tuples(jm.batch_pspecs(mode))
    # the module's own weights: one spec each, the stacked one's without
    # its repetition dim
    named = dict(tm.named_parameters())
    specs = tm.specs()
    assert specs.keys() == named.keys()
    assert all(len(specs[k]) == named[k].dim() for k in named)


@pytest.mark.parametrize("arch", ARCHS)
def test_stacked_specs_equal_jax(arch):
    """The agent-stacked parameter and cache specs and the global-batch
    specs on a one-pod and a two-pod mesh (the specs read only the mesh's
    axis names)."""
    from types import SimpleNamespace
    from repro.launch import sharding as jsharding
    jm = JModel(jget(arch, "full"))
    tm = Model(tget(arch, "full"), device="meta")
    for names in (("data", "model"), ("pod", "data", "model")):
        jmesh = SimpleNamespace(axis_names=names)
        tmesh = SimpleNamespace(mesh_dim_names=names)
        assert sharding.stacked_param_specs(tm, tmesh) == \
            as_tuples(jsharding.stacked_param_specs(jm, jmesh))
        assert sharding.stacked_cache_specs(tm, tmesh) == \
            as_tuples(jsharding.stacked_cache_specs(jm, jmesh))
        for mode in ("train", "decode"):
            assert sharding.batch_specs(tm, tmesh, mode) == \
                as_tuples(jsharding.batch_specs(jm, jmesh, mode))


@pytest.mark.parametrize("arch", ARCHS)
def test_plans_equal_jax(arch):
    jc, tc = jget(arch, "full"), tget(arch, "full")
    assert list(shapes.SHAPES) == list(jshapes.SHAPES)
    for name, js in jshapes.SHAPES.items():
        ts = shapes.SHAPES[name]
        assert (ts.name, ts.seq_len, ts.global_batch, ts.mode) == \
            (js.name, js.seq_len, js.global_batch, js.mode)
        assert shapes.train_seq_len(tc, ts) == jshapes.train_seq_len(jc, js)
        if js.mode == "decode":
            jp, tp = jshapes.plan_decode(jc, js), shapes.plan_decode(tc, ts)
            assert (tp.cache_len, tp.ring, tp.window) == \
                (jp.cache_len, jp.ring, jp.window)


def test_cost_formulas_equal_jax(monkeypatch):
    for arch in ARCHS:
        jc, tc = jget(arch, "full"), tget(arch, "full")
        for name, js in jshapes.SHAPES.items():
            for A, tp in ((16, 16), (32, 16), (4, 2)):
                assert cost.score_traffic_estimate(
                    tc, shapes.SHAPES[name], A, tp) == \
                    jha.score_traffic_estimate(jc, js, A, tp)
    for n, t, a in ((8_030_000_000, 1_048_576, 0),
                    (6_900_000_000, 256, 1_300_000_000)):
        assert cost.model_flops_train(n, t, a) == \
            jha.model_flops_train(n, t, a)
        assert cost.model_flops_decode(n, t, a) == \
            jha.model_flops_decode(n, t, a)
    coll = {k: {"count": 3, "result_bytes": 1e9, "wire_bytes": 1e9 * f}
            for k, f in cost.WIRE_FACTOR.items()}
    assert cost.WIRE_FACTOR == jha._WIRE_FACTOR
    c = {"flops": 3.2e14, "bytes accessed": 7.5e12}
    # the port's own rates are an H100's
    h = cost.roofline_terms(c, coll, 256).as_dict()
    assert h["compute_s"] == c["flops"] / 989e12
    assert h["memory_s"] == c["bytes accessed"] / 3.35e12
    assert h["collective_s"] == sum(v["wire_bytes"] for v in coll.values()) \
        / 50e9
    # at the JAX package's rates, the JAX formula
    monkeypatch.setattr(cost, "PEAK_FLOPS", jha.PEAK_FLOPS)
    monkeypatch.setattr(cost, "HBM_BW", jha.HBM_BW)
    monkeypatch.setattr(cost, "LINK_BW", jha.ICI_BW)
    assert cost.roofline_terms(c, coll, 256, links_per_chip=2.0).as_dict() \
        == jha.roofline_terms(c, coll, 256).as_dict()
    assert cost.collective_stats([("all-gather", 8.0), ("all-reduce", 4.0)]
                                 )["all-reduce"] == \
        {"count": 1, "result_bytes": 4.0, "wire_bytes": 8.0}


def test_placements_on_a_two_pod_mesh(fake_world):
    from torch.distributed.tensor import Replicate, Shard
    fake_world(16)
    m = mesh.make_debug_mesh(4, 2, multi_pod=True, device_type="cpu")
    assert m.mesh_dim_names == ("pod", "data", "model")
    assert mesh.n_agents_of(m) == 8
    assert sharding.agent_axes_of(m) == ("pod", "data")
    tree = {"w": (("pod", "data"), None, "model"), "b": ("model",),
            "r": (None,), "g": [((("pod", "data"), "model"))]}
    got = sharding.placements(tree, m)
    assert got["w"] == (Shard(0), Shard(0), Shard(2))
    assert got["b"] == (Replicate(), Replicate(), Shard(0))
    assert got["r"] == (Replicate(),) * 3
    assert got["g"] == [(Shard(0), Shard(0), Shard(1))]
    # on one pod the pod axis drops out
    fake_world(8)
    one = mesh.make_debug_mesh(4, 2, device_type="cpu")
    assert sharding.placements(tree, one)["w"] == (Shard(0), Shard(2))
    assert sharding.resolve((("pod", "data"), "model"), one) == \
        ("data", "model")
    assert sharding.resolve((("pod", "data"), "model"), one, batch_to=()) \
        == (None, "model")


def jax_local_bytes(shape, spec, sizes):
    """A leaf's per-device elements: each dim divided by its axes' sizes."""
    n = 1
    for d, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        axes = entry if isinstance(entry, tuple) else (entry,)
        n *= -(-d // math.prod(sizes.get(a, 1) for a in axes if a))
    return n


@pytest.mark.parametrize("arch", ["llama3_8b", "olmoe_1b_7b"])
def test_argument_bytes_count_jax_specs(fake_world, arch):
    cfg = tget(arch, "reduced")
    m = dryrun.production_mesh(False, SMALL)
    sizes = {"data": SMALL[0], "model": SMALL[1]}
    A = SMALL[0]
    shape = InputShape("t", 64, 8, "train")
    run, args, _ = dryrun.build_train(cfg, shape, m, "dense", "mp")
    jm = JModel(jget(arch, "reduced"))
    specs = jax.tree_util.tree_leaves(jm.param_pspecs(),
                                      is_leaf=lambda s: isinstance(s, P))
    leaves = jax.tree_util.tree_leaves(jm.abstract_params())
    mom = np.dtype(JAdamWConfig().moment_dtype).itemsize
    per_elem = 4 + 4 + 2 * mom          # params, anchor, m, v
    want = sum(per_elem * jax_local_bytes((A,) + tuple(leaf.shape),
                                          (("pod", "data"),) + tuple(s),
                                          sizes)
               for leaf, s in zip(leaves, specs))
    want += 4 + 4                       # the step counts
    batch = jm.input_specs(shape.global_batch, shape.seq_len, "train")
    bspecs = jm.batch_pspecs("train")
    want += sum(np.dtype(b.dtype).itemsize
                * jax_local_bytes(b.shape, bspecs[k], sizes)
                for k, b in batch.items())
    got = dryrun.measure(run, args, m)
    assert got["argument_size_in_bytes"] == want
    assert got["peak_size_in_bytes"] > want


@pytest.mark.parametrize("mode", ["train", "decode"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_dryrun_small_mesh_counts_flops(fake_world, arch, mode):
    """As the JAX package's tests/test_dryrun_small.py: each reduced
    family's train and decode step on a (4, 2) mesh."""
    cfg = tget(arch, "reduced")
    m = dryrun.production_mesh(False, SMALL)
    if mode == "train":
        # xLSTM's training step runs its sLSTM one token at a time under
        # the recorder (8 s at 64 tokens on 8 CPU cores): 16 tokens give
        # the same positive counts
        seq = 16 if arch == "xlstm_1_3b" else 64
        run, args, _ = dryrun.build_train(cfg, InputShape("t", seq, 8, mode),
                                          m, "dense", "mp")
    else:
        run, args, _ = dryrun.build_decode(cfg, InputShape("d", 64, 8, mode),
                                           m)
    rec = dryrun.measure(run, args, m)
    assert rec["cost_flops"] > 0 and rec["cost_bytes"] > 0
    assert rec["temp_size_in_bytes"] > 0


def test_gossip_exchanges_and_dense_gathers(fake_world):
    cfg = tget("llama3_8b", "reduced")
    m = dryrun.production_mesh(False, SMALL)
    shape = InputShape("t", 64, 8, "train")
    by = {}
    for schedule in ("gossip", "dense"):
        run, args, model = dryrun.build_train(cfg, shape, m, schedule, "mp")
        by[schedule] = dryrun.measure(run, args, m)["collectives_by_axis"]
    leaves = len(jax.tree_util.tree_leaves(
        JModel(jget("llama3_8b", "reduced")).param_pspecs(),
        is_leaf=lambda s: isinstance(s, P)))
    graph = dryrun.coupling_state(SMALL[0], 0.99).send_to
    matchings = sum(1 for row in graph if row[0] >= 0)
    assert by["gossip"]["agents"] == {"collective-permute":
                                      leaves * matchings}
    assert by["dense"]["agents"] == {"all-gather": leaves}
    assert by["gossip"]["model"] == by["dense"]["model"]


def test_constrain_returns_a_plain_tensor_itself():
    x = torch.ones(2, 3)
    assert constrain(x, (("pod", "data"), "model")) is x
    assert constrain(x, (None, None)) is x
