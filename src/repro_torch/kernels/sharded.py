"""Row-sharded wrappers of the mixing hot paths over a sim mesh
(counterpart of ``repro.kernels.sharded``; DESIGN.md §11).

Each wrapper splits the agent (or edge) axis of an op into P contiguous
row blocks (padded to ``P * ceil(n / P)`` rows), gathers over the mesh the
table its gathers read from, and runs one single-device implementation
(``inner``: the plain version, or the CUDA ``sparse_gather_mix``) on each
block.  Global tensors in, global tensors out, so the wrappers register
in ``kernels.dispatch`` as implementations (``reference_sharded``,
``cuda_sharded``) and engine code stays backend-agnostic.

* On a ``LocalMesh`` every block lives in this process and the table is
  already whole on the device, so the gather costs nothing: the wrapper
  runs ``inner`` once a block (P launches of a kernel a call).
* On a ``DistMesh`` each process runs its own block: it all-gathers the
  table from the ranks' blocks (a real collective, even at world size 1)
  and the block outputs after.

The mesh is the ``mesh=`` argument, else the one set by
``launch.sim_mesh.use_mesh``, else ``make_sim_mesh`` on the inputs'
device.  This is the graph-oblivious seam: it exchanges the whole table
every call; the partitioned engines (``simulate.partition``) exchange only
halo rows.
"""

from __future__ import annotations

import math
import weakref
from typing import Callable

import torch

from repro_torch.launch.sim_mesh import current_mesh


def _pad_rows(x, rows: int, fill=0):
    if x.shape[0] == rows:
        return x
    pad = x.new_full((rows - x.shape[0],) + tuple(x.shape[1:]), fill)
    return torch.cat([x, pad])


def _blocks(mesh, n: int):
    """(block rows, padded rows, [(shard, slice)] of this process)."""
    blk = math.ceil(n / mesh.n_shards)
    return blk, blk * mesh.n_shards, [
        (q, slice(q * blk, (q + 1) * blk))
        for q in range(mesh.first_shard,
                       mesh.first_shard + mesh.local_shards)]


def _assemble(mesh, outs, n: int):
    """Per-block outputs of this process (a list over its shards of
    tensors or tuples) -> the global (n, ...) outputs."""
    def one(parts):
        x = torch.stack(parts)                       # (S, blk, ...)
        if mesh.kind != "local":
            x = mesh.all_gather(x)                   # (P, blk, ...)
        return x.reshape((-1,) + tuple(x.shape[2:]))[:n]
    if isinstance(outs[0], tuple):
        return tuple(one(list(col)) for col in zip(*outs))
    return one(outs)


def _gather_table(mesh, table, blk: int):
    """The (P * blk, ...) zero-padded table every block reads, gathered
    over the mesh from each process's own rows (on a LocalMesh the table
    is already whole here)."""
    full = _pad_rows(table, blk * mesh.n_shards)
    if mesh.kind == "local":
        return full
    q = mesh.first_shard
    mine = full[q * blk:(q + 1) * blk][None]
    return mesh.all_gather(mine).reshape(full.shape)


_ORDERS = {}


def _block_orders(order, n: int, P_: int, blk: int):
    """Each block's share of the row order: the rows of ``order`` that
    fall in the block, in order, renumbered to the block, then the
    block's pad rows.  Built once per order tensor and kept."""
    key = (id(order), n, P_)
    hit = _ORDERS.get(key)
    if hit is not None and hit[0]() is order:
        return hit[1]
    o = order.long()
    out = []
    for q in range(P_):
        lo, hi = q * blk, (q + 1) * blk
        mine = o[(o >= lo) & (o < hi)] - lo
        pads = torch.arange(min(max(n, lo), hi), hi, device=o.device) - lo
        out.append(torch.cat([mine, pads]).to(torch.int32).contiguous())
    _ORDERS.clear()
    _ORDERS[key] = (weakref.ref(order), out)
    return out


def sharded_sparse_mix(table, idx, w, b, sol, *, inner: Callable,
                       mesh=None, order=None):
    """CSR gather-mix with the agent axis sharded over the mesh.

    table (N, p); idx (n, k) int32; w (n, k); b (n,); sol (n, p) ->
    (n, p).  Each block all-gathers the table (gather targets are
    arbitrary rows), then runs ``inner`` — any single-device sparse_mix
    implementation — on its rows, given ``order``'s rows that fall in the
    block, renumbered to it.  Pad rows carry w = 0 and b = 0, so they mix
    to 0 and are dropped.
    """
    mesh = current_mesh(table.device) if mesh is None else mesh
    n = idx.shape[0]
    blk, rows, mine = _blocks(mesh, n)
    full = _gather_table(mesh, table, math.ceil(table.shape[0]
                                                / mesh.n_shards))
    idx_p, w_p, b_p, sol_p = (_pad_rows(a, rows) for a in (idx, w, b, sol))
    orders = None if order is None \
        else _block_orders(order, n, mesh.n_shards, blk)
    outs = [inner(full, idx_p[sl].contiguous(), w_p[sl].contiguous(),
                  b_p[sl].contiguous(), sol_p[sl].contiguous(),
                  order=None if orders is None else orders[q])
            for q, sl in mine]
    return _assemble(mesh, outs, n)


def sharded_admm_primal(w, live, z_own, z_nbr, l_own, l_nbr, D, m, sx, mu,
                        rho, *, inner: Callable, mesh=None):
    """Batched quadratic CL-ADMM primal with the agent axis sharded.

    w, live (n, k); z/l rows (n, k, p); D, m (n,); sx (n, p) ->
    (theta (n, p), theta_js (n, k, p)); a single row (w of shape (k,)) is
    taken as a batch of one.  The primal is row-local, so no table is
    gathered: every block runs ``inner`` — any batched admm_primal
    implementation — on its rows.  Pad rows carry D = 1 and no live slot,
    so their (discarded) solves stay finite.
    """
    if w.dim() == 1:
        one = [a[None] for a in (w, live, z_own, z_nbr, l_own, l_nbr)]
        D_b = torch.as_tensor(D, dtype=torch.float32, device=w.device)
        m_b = torch.as_tensor(m, dtype=torch.float32, device=w.device)
        theta, theta_js = sharded_admm_primal(
            *one, D_b.reshape(1), m_b.reshape(1), sx[None], mu, rho,
            inner=inner, mesh=mesh)
        return theta[0], theta_js[0]
    mesh = current_mesh(w.device) if mesh is None else mesh
    n = w.shape[0]
    _, rows, mine = _blocks(mesh, n)
    args = [_pad_rows(a, rows) for a in (w, live, z_own, z_nbr, l_own,
                                         l_nbr)]
    args += [_pad_rows(D, rows, 1.0), _pad_rows(m, rows),
             _pad_rows(sx, rows)]
    outs = [inner(*(a[sl] for a in args), mu, rho) for _, sl in mine]
    return _assemble(mesh, outs, n)


def sharded_admm_edge(t_ii, t_ji, t_jj, t_ij, l_own_i, l_nbr_j_of_i,
                      l_own_j, l_nbr_i_of_j, *, rho, inner: Callable,
                      mesh=None):
    """Fused CL-ADMM Z + dual edge update with the edge axis sharded.

    Eight (E, p) inputs -> six (E, p) outputs, the single-device op's
    signature; each block runs ``inner`` on its edges (the update is
    independent per edge, so no collective but the outputs' gather).
    """
    mesh = current_mesh(t_ii.device) if mesh is None else mesh
    n_edges = t_ii.shape[0]
    _, rows, mine = _blocks(mesh, n_edges)
    args = [_pad_rows(a, rows) for a in (t_ii, t_ji, t_jj, t_ij, l_own_i,
                                         l_nbr_j_of_i, l_own_j,
                                         l_nbr_i_of_j)]
    outs = [tuple(inner(*(a[sl] for a in args), rho=rho))
            for _, sl in mine]
    return _assemble(mesh, outs, n_edges)


def sharded_edge_reweight(d, w, live, *, eta, lam, inner: Callable,
                          mesh=None):
    """Collaboration-graph re-estimation with the agent (row) axis sharded.

    d, w (n, k); live (n, k) bool -> (n, k).  The simplex projection is
    row-local, so every block runs ``inner`` — any single-device
    edge_reweight implementation — on its rows.  Pad rows have no live
    slot and come back all zero.
    """
    mesh = current_mesh(d.device) if mesh is None else mesh
    n = d.shape[0]
    _, rows, mine = _blocks(mesh, n)
    args = [_pad_rows(a, rows) for a in (d, w, live)]
    outs = [inner(*(a[sl] for a in args), eta=eta, lam=lam)
            for _, sl in mine]
    return _assemble(mesh, outs, n)


def sharded_graph_mix(theta, theta_sol, A, b, *, inner: Callable,
                      mesh=None):
    """Dense Eq. (5) mix with the agent (row) axis sharded over the mesh.

    theta, theta_sol (n, D); A (n, n); b (n,) -> (n, D).  A is split by
    rows; theta is gathered so every block can form its ``A_blk @ theta``
    product.  Zero pad columns of A mean the gathered theta's pad rows add
    nothing.
    """
    mesh = current_mesh(theta.device) if mesh is None else mesh
    n = theta.shape[0]
    blk, rows, mine = _blocks(mesh, n)
    full = _gather_table(mesh, theta, blk)
    A_p = torch.nn.functional.pad(A, (0, rows - n, 0, rows - n))
    sol_p, b_p = _pad_rows(theta_sol, rows), _pad_rows(b, rows)
    outs = [inner(full, sol_p[sl], A_p[sl].contiguous(), b_p[sl])
            for _, sl in mine]
    return _assemble(mesh, outs, n)
