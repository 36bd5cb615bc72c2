"""Hand-built CL-ADMM edge rounds for the ``cl_edge_step`` election tests
(imports torch and the port only, so the card tests can use it where
there is no JAX).

Each case puts a few events on chosen edges of a small topology, on top
of a background of events on edges of their own:

* ``same_wake``: one agent wakes twice and picks the same slot;
* ``mirror``: i -> j and j -> i fire in one round;
* ``dropped_twin``: two events on one edge, one delivered both ways and
  one dropped both ways;
* ``split_bits``: two events on one edge, each delivering one direction
  only (i -> j delivered by one, j -> i by its mirror), so the winner must
  land the union of their bits;
* ``stale_dup``: duplicates on an edge whose one sender lags, so stale
  and fresh sides meet among the repeats.

Staleness is drawn per sender (a lagging set), as the scheduler draws it.
"""

import types

import numpy as np
import torch

from repro_torch.kernels import round_fuse as rf
from repro_torch.simulate import random_geometric_topology
from repro_torch.simulate.engines import _event_sides

CASES = ("same_wake", "mirror", "dropped_twin", "split_bits", "stale_dup")


def election_round(case, dev, n=60, p=9, seed=0, rho=1.3):
    """``(state, sides, rho, k)`` of one edge phase built for ``case``:
    state = [theta, K, Z_own, Z_nbr, L_own, L_nbr, pay_th, pay_K, pay_Lo,
    pay_Ln] and sides the engine's 2B event sides."""
    topo = random_geometric_topology(n, k=4, seed=seed)
    t = topo.tables
    k = t.k_max
    rng = np.random.default_rng(seed + CASES.index(case))
    i, s = 3, 0
    j, r = int(t.nbr_idx[i, s]), int(t.rev_slot[i, s])
    lag = np.zeros(n, bool)
    # (waker, slot, deliver i->j, deliver j->i) of the case's events
    ev = {"same_wake": [(i, s, 1, 1), (i, s, 1, 1)],
          "mirror": [(i, s, 1, 1), (j, r, 1, 1)],
          "dropped_twin": [(i, s, 1, 1), (i, s, 0, 0), (j, r, 0, 0)],
          "split_bits": [(i, s, 1, 0), (j, r, 1, 0), (i, s, 0, 0)],
          "stale_dup": [(i, s, 1, 1), (j, r, 1, 0), (i, s, 0, 1)]}[case]
    if case == "stale_dup":
        lag[j] = True
    # background: one event on each of a few other edges, random faults
    used = {min(i, j) * n + max(i, j)}
    for a in rng.permutation(n):
        deg = int(t.deg_count[a])
        if deg == 0 or len(ev) >= 24:
            continue
        sl = int(rng.integers(deg))
        b = int(t.nbr_idx[a, sl])
        key = min(a, b) * n + max(a, b)
        if key not in used:
            used.add(key)
            ev.append((int(a), sl, int(rng.uniform() < 0.8),
                       int(rng.uniform() < 0.8)))
    lag |= rng.uniform(size=n) < 0.2
    lag[i] = False
    order = rng.permutation(len(ev))
    ev = [ev[q] for q in order]
    ei = np.array([e[0] for e in ev])
    es = np.array([e[1] for e in ev])
    ej, er = t.nbr_idx[ei, es], t.rev_slot[ei, es]

    def ints(a):
        return torch.as_tensor(np.asarray(a), device=dev).int()

    def flag(a):
        return torch.as_tensor(np.asarray(a, bool), device=dev)

    events = types.SimpleNamespace(
        i=ints(ei), s=ints(es), j=ints(ej), r=ints(er),
        deliver_ij=flag([e[2] for e in ev]),
        deliver_ji=flag([e[3] for e in ev]),
        stale_ij=flag(lag[ei]), stale_ji=flag(lag[ej]))
    sides = _event_sides(events)

    def f32(shape):
        return torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32,
                               device=dev)

    state = [f32((n, p))] + [f32((n, k, p)) for _ in range(5)]
    snap = [f32((n, p))] + [f32((n, k, p)) for _ in range(3)]
    pay = rf.cl_stale_prefetch(*snap, sides[2], sides[3])
    return state + [x.contiguous() for x in pay], sides, rho, k
