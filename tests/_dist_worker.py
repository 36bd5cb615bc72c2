"""Shared problem of the sim-mesh tests, and the body each rank of their
gloo process group runs (tests/test_torch_sim_mesh.py).

The parent test builds the same problem and runs it on a ``LocalMesh``;
every rank here runs it on a ``DistMesh`` over ``torch.distributed`` with
the gloo backend (one shard a process, on the CPU) and saves what it got.
This module imports torch and the port only, so the spawned processes
start quickly.
"""

import numpy as np
import torch

N, P_DIM, WORLD = 203, 4, 4
RUN = dict(rounds=40, batch=32, seed=3, record_every=10)
COND = dict(drop_prob=0.1, stale_prob=0.3, churn_rate=0.01,
            straggler_frac=0.3, partition_start=5, partition_end=20)
JOINT = dict(eta_graph=0.3, lam=1.0, graph_every=5, prune_eps=0.05,
             recompact_every=10, recompact_frac=0.05)
AGENTS = 4
# CL-ADMM with MLP agents (InexactPrimal, the data-hungry primal path)
MOONS = dict(n=48, seed=0)
MLP_RUN = dict(rounds=30, batch=12, seed=1, record_every=10)
MLP_MU, MLP_RHO = 0.5, 0.5


def problem():
    """(topology, solitary models, confidences, CL data and warm start,
    conditions, the coupling state and trees) on the CPU."""
    from repro_torch.core.graph import random_geometric_graph
    from repro_torch.core.losses import pad_datasets, solitary_mean
    from repro_torch.coupling import make_state
    from repro_torch.simulate import (NetworkConditions,
                                      random_geometric_topology)
    topo = random_geometric_topology(N, k=5, seed=0)
    rng = np.random.default_rng(0)
    sol = rng.standard_normal((N, P_DIM)).astype(np.float32)
    c = rng.uniform(0.05, 1.0, N).astype(np.float32)
    xs = [rng.standard_normal((int(rng.integers(1, 8)), P_DIM))
          for _ in range(N)]
    data = pad_datasets(xs, [np.zeros(len(x)) for x in xs], device="cpu")
    state = make_state(random_geometric_graph(AGENTS, k=2, seed=1),
                       np.linspace(0.3, 1.0, AGENTS), 0.9, device="cpu")
    trees = [{"w": torch.as_tensor(rng.standard_normal((AGENTS, 6, 5)),
                                   dtype=torch.float32),
              "b": torch.as_tensor(rng.standard_normal((AGENTS, 3)),
                                   dtype=torch.float32)} for _ in range(2)]
    return (topo, sol, c, data, solitary_mean(data),
            NetworkConditions(**COND), state, trees)


def mlp_problem():
    """(topology, training data, solitary warm start, solver) of a small
    federated moons problem with MLP agents, on the CPU."""
    from repro_torch.core.primal import InexactPrimal, solitary_adamw
    from repro_torch.data import federated_moons_problem
    from repro_torch.models import MLPAgent
    topo, train, _, _ = federated_moons_problem(**MOONS, device="cpu")
    sol = solitary_adamw(train, loss="logistic", model=MLPAgent(2, (4,)),
                         steps=50, seed=0)
    return topo, train, sol, InexactPrimal(
        loss="logistic", model=MLPAgent(2, (4,)), b_steps=4, lr=0.05)


def runs(mesh):
    """Every run of the test on ``mesh``: MP (all_gather, ring, int8), CL
    (exact, and MLP agents), joint with re-compaction, the
    reference_sharded sweep, the gossip coupling and the dense coupling
    of each mode (each rank's agent on a DistMesh)."""
    from repro_torch.coupling import (CouplingConfig, gossip_mix_tree,
                                      make_coupling)
    from repro_torch.kernels.dispatch import ReproBackend
    from repro_torch.launch import use_mesh
    from repro_torch.simulate import partition as pt
    from repro_torch.simulate import sparse_sync_mp
    topo, sol, c, data, sol_cl, cond, state, (params, anchor) = problem()
    out = {}
    for name, kw in (("mp", {}), ("mp-ring", dict(exchange="ring")),
                     ("mp-int8", dict(halo_codec="int8"))):
        tr = pt.run_mp_scenario_sharded(topo, sol, c, 0.9, cond, mesh=mesh,
                                        **RUN, **kw)
        out[name], out[name + "-overflow"] = tr.theta_hist, tr.overflow
    tr = pt.run_cl_scenario_sharded(topo, data, 0.1, 1.0, cond,
                                    theta_sol=sol_cl, mesh=mesh, **RUN)
    out["cl"], out["cl-overflow"] = tr.theta_hist, tr.overflow
    mtopo, train, msol, primal = mlp_problem()
    tr = pt.run_cl_scenario_sharded(mtopo, train, MLP_MU, MLP_RHO, cond,
                                    theta_sol=msol, primal=primal, mesh=mesh,
                                    **MLP_RUN)
    out["cl-mlp"], out["cl-mlp-overflow"] = tr.theta_hist, tr.overflow
    tr = pt.run_joint_scenario_sharded(topo, sol, c, 0.9, cond, mesh=mesh,
                                       **RUN, **JOINT)
    out.update(joint=tr.theta_hist, joint_w=tr.final_w,
               joint_live=tr.final_live, recompactions=tr.recompactions)
    with use_mesh(mesh):
        out["sweep"] = sparse_sync_mp(
            topo, sol, c, 0.9, 6, device="cpu",
            backend=ReproBackend.using(sparse_mix="reference_sharded"))
    if mesh.kind == "dist":
        q = mesh.rank
        params = {k: v[q:q + 1] for k, v in params.items()}
        anchor = {k: v[q:q + 1] for k, v in anchor.items()}
    out["gossip"] = gossip_mix_tree(params, anchor, state,
                                    CouplingConfig(mode="mp", alpha=0.9),
                                    mesh)
    # the dense schedule: all-gathered on a DistMesh, stacked on the
    # LocalMesh (which the dense schedule does not use)
    dist_mesh = mesh if mesh.kind == "dist" else None
    for mode, kw in (("mp", {}), ("consensus", {}), ("cl", {}),
                     ("mp", dict(mix_dtype=torch.bfloat16))):
        cfg = CouplingConfig(mode=mode, alpha=0.9, mu=0.05, **kw)
        name = "dense-" + mode + ("-bf16" if kw else "")
        out[name] = make_coupling(cfg, state, mesh=dist_mesh)(
            {k: v.clone() for k, v in params.items()}, anchor, 0)
    return out


def rank_main(rank: int, world: int, port: int, out_dir: str):
    """One rank: join the gloo group, run everything on a DistMesh, save."""
    import torch.distributed as dist

    torch.set_num_threads(1)       # as the parent (tests/_port_session.py)

    from repro_torch.launch import DistMesh
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        torch.save(runs(DistMesh(device="cpu")), f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()
