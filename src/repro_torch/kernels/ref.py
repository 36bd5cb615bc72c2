"""Plain-PyTorch twins of the JAX package's oracles (``repro.kernels.ref``)
for the ops of the model-propagation path: ``graph_mix``,
``sparse_gather_mix``, ``neighbor_aggregate`` and ``gossip_round_step``.

They are the ``reference`` implementations of ``kernels.dispatch`` and the
one plain version of each CUDA kernel (the kernel modules import them as
``*_plain``); each computes what its JAX namesake computes, with torch ops
on whatever device its tensors lie on.  ``sparse_gather_mix`` and
``gossip_round_step`` follow their kernels' summation order, so the kernels
agree with them bit for bit.
"""

from __future__ import annotations

import torch


def graph_mix(theta, theta_sol, A, b):
    """Fused model-propagation step: ``A @ theta + b[:, None] * theta_sol``.

    theta, theta_sol: (n, D); A: (n, n); b: (n,).  f32 accumulation.
    """
    f = torch.float32
    return (A.to(f) @ theta.to(f)
            + b.to(f)[:, None] * theta_sol.to(f)).to(theta.dtype)


def sparse_gather_mix(table, idx, w, b, sol):
    """CSR model-propagation sweep over padded-neighbor tables.

    table: (N, p); idx: (n, k) int neighbor ids; w: (n, k) mixing weights
    (0 at pads); b: (n,) anchors; sol: (n, p), all float32.
    returns out[i] = b[i] * sol[i] + sum_s w[i, s] * table[idx[i, s]]

    The anchor comes first, then the k slots in slot order, each product
    rounded before its add: the CUDA kernel's order, so the two agree bit
    for bit.
    """
    acc = b[:, None] * sol
    for s in range(idx.shape[1]):
        acc = acc + w[:, s, None] * table[idx[:, s]]
    return acc


def neighbor_aggregate(w_slots, theta_slots):
    """sum_s w[..., s] * theta[..., s, :] over the slot axis:
    (..., k), (..., k, p) -> (..., p)."""
    return torch.einsum("...k,...kp->...p", w_slots, theta_slots)


def gossip_round_step(theta, Ke, got_ever, msg, tgt_row, enc, k_old,
                      theta_base, a_w):
    """One batched MP gossip round over the flat slot table (the oracle of
    the ``round_step`` op; ``repro.kernels.ref.gossip_round_step``).

    State: theta / theta_base (n, p); Ke (n*k, p+1) flat neighbor slots
    with the id column at ``p``; got_ever (n,) bool; a_w (n*k,) per-slot
    Eq. 6 gains.  Events: msg / k_old (2B, p), tgt_row (2B,) receiver rows
    (``n`` where undelivered), enc (2B,) flat targets (``n*k`` sentinel
    where undelivered).

    The winner of a landed slot is its highest event index — the JAX
    oracle's "last event of each duplicate run" — and lands ``[msg | id]``.
    Each touched row starts from ``theta_base`` (first receipt) or
    ``theta`` and adds its winners' ``a_w (msg - k_old)`` in slot order:
    the CUDA kernel's algorithm, so the two agree bit for bit.  Updates
    ``theta``, ``Ke`` and ``got_ever`` in place and returns
    ``(theta, Ke, got_ever, keep)``.
    """
    n, p = theta.shape
    nk = Ke.shape[0]
    k = nk // n
    m = msg.shape[0]
    dev = theta.device
    ids = torch.arange(m, device=dev)
    enc_l = enc.long()
    landed = (enc_l >= 0) & (enc_l < nk) & (tgt_row < n)
    win = torch.full((nk,), -1, dtype=torch.long, device=dev)
    win.scatter_reduce_(0, enc_l[landed], ids[landed], reduce="amax")
    keep = landed & (win[enc_l.clamp(0, nk - 1)] == ids)

    slots = torch.nonzero(win >= 0).squeeze(1)            # ascending
    e_w = win[slots]
    Ke[slots, :p] = msg[e_w]  # scatter: unique targets (one winner a slot)
    Ke[slots, p] = e_w.to(Ke.dtype)  # scatter: unique targets

    row_of = slots // k
    rows = torch.unique(row_of)                            # sorted
    pos = torch.searchsorted(rows, row_of)
    delta = a_w[slots, None] * (msg[e_w] - k_old[e_w])
    D = torch.zeros((rows.numel(), k, p), dtype=theta.dtype, device=dev)
    has = torch.zeros((rows.numel(), k), dtype=torch.bool, device=dev)
    D[pos, slots % k] = delta  # scatter: unique targets (one per slot)
    has[pos, slots % k] = True  # scatter: unique targets (one per slot)
    acc = torch.where(got_ever[rows, None], theta[rows], theta_base[rows])
    for s in range(k):
        acc = torch.where(has[:, s, None], acc + D[:, s], acc)
    theta[rows] = acc  # scatter: unique targets (rows are unique)
    got_ever[rows] = True  # scatter: unique targets (rows are unique)
    return theta, Ke, got_ever, keep
