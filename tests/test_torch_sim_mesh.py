"""The port's sim meshes (``repro_torch.launch.sim_mesh``) and sharded
dispatch implementations on the CPU.

* ``HaloCodec`` encode, decode and ``row_nbytes`` bit for bit against
  JAX's for all three codecs, zero rows included; ``halo_payload_bytes``
  and ``shard_read_route`` equal;
* the halo exchange on a ``LocalMesh``: every fetchable row of every
  shard's ext buffer holds its agent's value, under ring and all_gather;
* meshes made without ``device=`` on a host without CUDA raise;
* the sharded dispatch implementations against their inner ones (the
  JAX multi-device subprocess's checks, tests/test_partition.py);
* one subprocess running JAX at 4 fake host devices (MP with the f32 and
  int8 codecs and the ring exchange; CL), held against the port's
  ``LocalMesh`` of 4 shards on JAX's events: equal overflow and counters,
  theta_hist within the port-vs-JAX bar (1e-5; 1e-4 under int8, whose
  codes can round apart where the inputs differ in the last bit);
* one 4-rank gloo process group running MP, CL, joint learning, the
  sharded sweep, the gossip coupling and the dense coupling of every mode
  (all-gathered, the stacked operator, this rank's row) on a
  ``DistMesh``, bit for bit against the ``LocalMesh`` of 4 shards, whose
  dense coupling is the tree operators on the stacked leaves.
"""

import os
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.launch import sim_mesh as jsm  # noqa: E402
from repro.simulate import scheduler as jsched  # noqa: E402
from repro.simulate import topology as jtopo  # noqa: E402

import _dist_worker as dw  # noqa: E402
import _port_session  # noqa: E402
from _jax_caches import fresh_jax_caches  # noqa: E402,F401
from _port_session import port_background_jobs  # noqa: E402,F401
from repro_torch import convert  # noqa: E402
from repro_torch.coupling import (CouplingConfig,  # noqa: E402
                                  consensus_mean_tree, dense_mix_tree,
                                  laplacian_pull_tree)
from repro_torch.kernels import dispatch, ref  # noqa: E402
from repro_torch.kernels import sparse_mix as tsm  # noqa: E402
from repro_torch.kernels.sharded import sharded_sparse_mix  # noqa: E402
from repro_torch.launch import (DistMesh, HaloCodec, LocalMesh,  # noqa: E402
                                halo_exchange_fn, halo_payload_bytes,
                                make_sim_mesh, shard_read_route, use_mesh)
from repro_torch.simulate import partition as tpart  # noqa: E402
from repro_torch.simulate import sparse_sync_mp  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"


# ---------------------------------------------------------------------------
# wire formats and routing against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", HaloCodec.NAMES)
def test_halo_codec_matches_jax(name):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((6, 5, 9)) * 10 ** rng.uniform(
        -3, 3, (6, 5, 1))).astype(np.float32)
    x[2] = 0.0                                  # zero rows: scale 1.0
    x[4, 1] = 0.0
    jc, tc = jsm.HaloCodec(name), HaloCodec(name)
    jw, tw = jc.encode(jnp.asarray(x)), tc.encode(torch.as_tensor(x))
    assert len(jw) == len(tw)
    for a, b in zip(jw, tw):
        assert str(np.asarray(a).dtype) == str(b.dtype).split(".")[-1]
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      b.float().numpy())
    np.testing.assert_array_equal(np.asarray(jc.decode(jw)),
                                  tc.decode(tw).numpy())
    for shape in ((4,), (55, 32), (3, 7)):
        assert tc.row_nbytes(shape) == jc.row_nbytes(shape)
    if name == "int8":
        assert (tw[1][2] == 1.0).all()


def test_payload_bytes_and_read_route_match_jax():
    for args in ((8, 100, 132, 0), (8, 100, 132, 7), (4, 3, 33, 1)):
        assert halo_payload_bytes(*args) == jsm.halo_payload_bytes(*args)
    rng = np.random.default_rng(2)
    owner = rng.integers(0, 4, 50)
    pos = rng.integers(0, 13, 50)
    users = rng.integers(0, 50, 30)
    for a, b in zip(shard_read_route(owner, pos, users),
                    jsm.shard_read_route(owner, pos, users)):
        np.testing.assert_array_equal(a, np.asarray(b))
        assert a.dtype == np.int32


def test_halo_exchange_fills_every_fetchable_row():
    topo, *_ = dw.problem()
    part = tpart.GraphPartition.build(
        topo, tpart.greedy_partition(topo, 4), 4)
    m, H = part.shard_size, part.halo_size
    vals = torch.arange(topo.n, dtype=torch.float32)[:, None] + 1.0
    x = torch.as_tensor(part.shard_rows(vals.numpy())).reshape(4, m, 1)
    mesh = LocalMesh(4, CPU)
    got = [halo_exchange_fn(part.bnd_pos, part.halo_src_shard,
                            part.halo_src_pos, H, mesh, ex)(x)
           for ex in ("all_gather", "ring")]
    for ext in got:            # (pad halo slots, never fetched, may differ)
        assert ext.shape == (4, m + H + 1, 1)
        assert (ext[:, m + H] == 0).all()
        for q in range(4):
            ok = part.fetch[q] < m + H
            np.testing.assert_array_equal(
                ext[q, part.fetch[q][ok], 0].numpy(), vals[ok, 0].numpy())
    with pytest.raises(ValueError, match="exchange"):
        halo_exchange_fn(part.bnd_pos, part.halo_src_shard,
                         part.halo_src_pos, H, mesh, "halo")


def test_meshes_need_a_device_or_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    for make in (lambda: LocalMesh(2), lambda: make_sim_mesh(2)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    with pytest.raises(RuntimeError, match="process group"):
        DistMesh(device=CPU)
    assert make_sim_mesh(device=CPU).n_shards == 1
    with pytest.raises(ValueError):
        LocalMesh(0, CPU)
    with pytest.raises(dispatch.BackendUnavailable):
        dispatch.resolve("sparse_mix", dispatch.ReproBackend.using(
            sparse_mix="cuda_sharded"), CPU)


# ---------------------------------------------------------------------------
# sharded dispatch implementations against their inner ones
# ---------------------------------------------------------------------------


def test_sharded_impls_match_their_inner_impls():
    topo, sol, c, *_ = dw.problem()
    want = sparse_sync_mp(topo, sol, c, 0.9, 15, device=CPU)
    with use_mesh(LocalMesh(8, CPU)):
        got = sparse_sync_mp(topo, sol, c, 0.9, 15, device=CPU,
                             backend=dispatch.ReproBackend.using(
                                 sparse_mix="reference_sharded"))
    assert torch.equal(got, want)
    assert dispatch.implementations("sparse_mix") == ("reference", "cuda")
    assert dispatch.SHARDED_IMPLS == ("reference_sharded", "cuda_sharded")
    for op in ("mix", "sparse_mix", "admm_primal", "admm_edge",
               "edge_reweight"):
        assert dispatch.resolve(op, dispatch.ReproBackend.using(
            **{op: "reference_sharded"}), CPU) \
            is dispatch._REGISTRY[op]["reference_sharded"]
    assert dispatch.resolve("sparse_mix", dispatch.ReproBackend.using(
        sparse_mix="cuda_sharded"), "cuda") \
        is dispatch._REGISTRY["sparse_mix"]["cuda_sharded"]
    with pytest.raises(KeyError, match="reference_sharded"):
        dispatch.resolve("mix", dispatch.ReproBackend.using(
            mix="cuda_sharded"), "cuda")

    rng = np.random.default_rng(3)
    n, k, p = 40, 6, 16

    def t(*shape, low=None):
        a = rng.uniform(low, 1, shape) if low is not None \
            else rng.standard_normal(shape)
        return torch.as_tensor(a, dtype=torch.float32)

    args = (t(n, k, low=0.1), torch.as_tensor(rng.uniform(size=(n, k))
                                              < 0.8),
            t(n, k, p), t(n, k, p), t(n, k, p), t(n, k, p),
            torch.as_tensor(rng.uniform(1, 4, n), dtype=torch.float32),
            torch.as_tensor(rng.integers(1, 20, n), dtype=torch.float32),
            t(n, p))
    shd = dispatch.resolve("admm_primal", dispatch.ReproBackend.using(
        admm_primal="reference_sharded"), CPU)
    with use_mesh(LocalMesh(8, CPU)):
        for a, b in zip(shd(*args, 0.05, 1.0),
                        ref.quadratic_primal(*args, 0.05, 1.0)):
            assert (a - b).abs().max().item() <= 1e-5
        row = [a[3] for a in args]
        for a, b in zip(shd(*row, 0.05, 1.0),
                        ref.quadratic_primal(*row, 0.05, 1.0)):
            assert (a - b).abs().max().item() <= 1e-5
        e_args = tuple(t(n, p) for _ in range(8))
        edge = dispatch.resolve("admm_edge", dispatch.ReproBackend.using(
            admm_edge="reference_sharded"), CPU)
        for a, b in zip(edge(*e_args, rho=1.5),
                        ref.admm_edge_update(*e_args, rho=1.5)):
            assert torch.equal(a, b)
        d, w, live = t(n, k), t(n, k, low=0.0), args[1]
        rew = dispatch.resolve("edge_reweight", dispatch.ReproBackend.using(
            edge_reweight="reference_sharded"), CPU)
        assert torch.equal(rew(d, w, live, eta=0.3, lam=1.0),
                           ref.edge_reweight(d, w, live, eta=0.3, lam=1.0))
        mix = dispatch.resolve("mix", dispatch.ReproBackend.using(
            mix="reference_sharded"), CPU)
        th, A, b = t(n, 8), t(n, n, low=0.0) / n, t(n, low=0.0)
        assert (mix(th, th, A, b) - ref.graph_mix(th, th, A, b)) \
            .abs().max().item() <= 1e-5
    # the kernel wrapper as the inner impl (its plain path on the CPU),
    # given each block's share of the locality order
    tabs = topo.device_tables(CPU)
    table = torch.as_tensor(sol)
    wt = torch.as_tensor(tabs.nbr_p).contiguous()
    bt = torch.full((topo.n,), 0.1)
    order = torch.as_tensor(topo.locality_order)
    got = sharded_sparse_mix(table, tabs.nbr_idx, wt, bt, table,
                             inner=tsm.sparse_gather_mix,
                             mesh=LocalMesh(8, CPU), order=order)
    assert torch.equal(got, ref.sparse_gather_mix(table, tabs.nbr_idx, wt,
                                                  bt, table))


# ---------------------------------------------------------------------------
# JAX at 4 fake host devices, in a subprocess (a background job: it starts
# with the port's first test and runs beside the tests before this module)
# ---------------------------------------------------------------------------


JAX_SUBPROC = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np
    import jax
    assert jax.device_count() == 4
    from repro.core.losses import pad_datasets, solitary_mean
    from repro.simulate import (NetworkConditions, partition,
                                random_geometric_topology)
    import _dist_worker as dw
    topo = random_geometric_topology(dw.N, k=5, seed=0)
    rng = np.random.default_rng(0)
    sol = rng.standard_normal((dw.N, dw.P_DIM)).astype(np.float32)
    c = rng.uniform(0.05, 1.0, dw.N).astype(np.float32)
    xs = [rng.standard_normal((int(rng.integers(1, 8)), dw.P_DIM))
          for _ in range(dw.N)]
    data = pad_datasets(xs, [np.zeros(len(x)) for x in xs])
    cond = NetworkConditions(**dw.COND)
    out = {}
    for name, kw in (("mp", {}), ("mp-ring", dict(exchange="ring")),
                     ("mp-int8", dict(halo_codec="int8"))):
        tr = partition.run_mp_scenario_sharded(topo, sol, c, 0.9, cond,
                                               **dw.RUN, **kw)
        assert tr.n_shards == 4
        out[name], out[name + "-overflow"] = tr.theta_hist, tr.overflow
        out[name + "-counters"] = (tr.delivered, tr.dropped, tr.invalid)
    tr = partition.run_cl_scenario_sharded(
        topo, data, 0.1, 1.0, cond, theta_sol=np.asarray(
            solitary_mean(data), np.float32), **dw.RUN)
    out["cl"], out["cl-overflow"] = tr.theta_hist, tr.overflow
    np.savez(sys.argv[1], **out)
""")


def start_jax_four_devices():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(REPO, "src"), os.path.dirname(__file__),
         env.get("PYTHONPATH", "")])
    env.pop("XLA_FLAGS", None)
    return _port_session.SubprocessJob(JAX_SUBPROC, ["{out}.npz"], env=env)


_port_session.register(__name__, start_jax_four_devices, "jax4")


def test_jax_four_devices_against_the_local_mesh():
    from repro.simulate import NetworkConditions as JCond
    proc = _port_session.job(__name__, "jax4")
    rc, log = proc.wait(timeout=240)
    assert rc == 0, log
    want = dict(np.load(proc.out + ".npz"))
    jt = jtopo.random_geometric_topology(dw.N, k=5, seed=0)
    js = jsched.precompute_event_stream(
        jt.device_tables(), jnp.asarray(jt.partition_halves()),
        JCond(**dw.COND), dw.RUN["batch"], dw.RUN["seed"], dw.RUN["rounds"])
    stream = convert.stream_from_arrays(js, CPU)
    topo, sol, c, data, sol_cl, cond, *_ = dw.problem()
    mesh = LocalMesh(4, CPU)
    for name, kw, tol in (("mp", {}, 1e-5),
                          ("mp-ring", dict(exchange="ring"), 1e-5),
                          ("mp-int8", dict(halo_codec="int8"), 1e-4)):
        tr = tpart.run_mp_scenario_sharded(topo, sol, c, 0.9, cond,
                                           mesh=mesh, stream=stream,
                                           **dw.RUN, **kw)
        assert tr.overflow == int(want[name + "-overflow"]) == 0
        assert (tr.delivered, tr.dropped, tr.invalid) == \
            tuple(int(v) for v in want[name + "-counters"])
        np.testing.assert_allclose(tr.theta_hist.numpy(), want[name],
                                   atol=tol, rtol=0)
    tr = tpart.run_cl_scenario_sharded(topo, data, 0.1, 1.0, cond,
                                       theta_sol=sol_cl, mesh=mesh,
                                       stream=stream, **dw.RUN)
    assert tr.overflow == int(want["cl-overflow"]) == 0
    np.testing.assert_allclose(tr.theta_hist.numpy(), want["cl"], atol=1e-5,
                               rtol=0)


# ---------------------------------------------------------------------------
# a 4-rank gloo process group: DistMesh against LocalMesh (a background job,
# as the JAX subprocess)
# ---------------------------------------------------------------------------

_port_session.register(__name__, lambda: _port_session.SpawnJob(
    dw.rank_main, dw.WORLD), "gloo", nprocs=dw.WORLD)


def assert_trees_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_gloo_dist_mesh_equals_the_local_mesh():
    got = _port_session.job(__name__, "gloo").results(timeout=90)
    want = dw.runs(LocalMesh(dw.WORLD, CPU))
    assert want["recompactions"] >= 1
    for r, out in enumerate(got):
        for key, val in want.items():
            if key == "gossip" or key.startswith("dense-"):
                for leaf in val:
                    assert torch.equal(out[key][leaf], val[leaf][r:r + 1])
            elif isinstance(val, torch.Tensor):
                assert torch.equal(out[key], val), (r, key)
            else:
                assert out[key] == val, (r, key)
    assert want["mp-overflow"] == want["cl-overflow"] == \
        want["cl-mlp-overflow"] == 0
    # the stacked dense schedule is the coupling's tree operators
    _, _, _, _, _, _, state, (params, anchor) = dw.problem()
    assert_trees_equal(want["dense-mp"],
                       dense_mix_tree(params, anchor, state,
                                      CouplingConfig(mode="mp", alpha=0.9)))
    assert_trees_equal(want["dense-consensus"],
                       consensus_mean_tree(params, CouplingConfig()))
    assert_trees_equal(want["dense-cl"],
                       laplacian_pull_tree(params, state, CouplingConfig(),
                                           0.05))
