"""Plain-PyTorch twins of the JAX package's oracles (``repro.kernels.ref``)
for the ops of the model-propagation path (``graph_mix``,
``sparse_gather_mix``, ``neighbor_aggregate``, ``gossip_round_step``) and
of the CL-ADMM path (``quadratic_primal``, ``inexact_primal``,
``admm_edge_halfstep``, ``admm_edge_update``, ``cl_edge_step``), of joint
graph learning (``simplex_project_rows``, ``edge_reweight``), and
``flash_attention`` for the LM serving path.

They are the ``reference`` implementations of ``kernels.dispatch`` and the
one plain version of each CUDA kernel (the kernel modules import them as
``*_plain``); each computes what its JAX namesake computes, with torch ops
on whatever device its tensors lie on.  ``sparse_gather_mix`` and
``gossip_round_step`` follow their kernels' summation order, so the kernels
agree with them bit for bit; the CL-ADMM edge math divides by ``rho`` as a
tensor (a CUDA division by a Python scalar multiplies by its reciprocal),
so it rounds as the kernels' ``__fdiv_rn`` does.
"""

from __future__ import annotations

import torch

from repro_torch.optim.adamw import adamw_rows


def graph_mix(theta, theta_sol, A, b):
    """Fused model-propagation step: ``A @ theta + b[..., None] *
    theta_sol``, f32 accumulation.

    theta, theta_sol: (T?, n, D); A: (T?, n, n); b: (T?, n), with an
    optional leading trial axis taken through batched ``@``.  At D = 1 the
    product is a multiply and a row sum instead: torch's CPU matmul folds
    one (n, n) @ (n, 1) product into a matrix-vector call and a batch of
    them into a batched gemm, which sum in different orders, while a row
    sum adds in the same order however many rows there are.  So on the CPU
    each trial of a batched call equals the unbatched call on that trial
    bit for bit.
    """
    f = torch.float32
    A32, th32 = A.to(f), theta.to(f)
    if theta.shape[-1] == 1:
        prod = torch.sum(A32 * th32.transpose(-1, -2), dim=-1, keepdim=True)
    else:
        prod = A32 @ th32
    return (prod + b.to(f)[..., None] * theta_sol.to(f)).to(theta.dtype)


def sparse_gather_mix(table, idx, w, b, sol, *, order=None):
    """CSR model-propagation sweep over padded-neighbor tables.

    table: (N, p); idx: (n, k) int neighbor ids; w: (n, k) mixing weights
    (0 at pads); b: (n,) anchors; sol: (n, p), all float32.
    returns out[i] = b[i] * sol[i] + sum_s w[i, s] * table[idx[i, s]]

    The anchor comes first, then the k slots in slot order, each product
    rounded before its add: the CUDA kernel's order, so the two agree bit
    for bit.  ``order`` (the kernel's row schedule) does not change the
    result and is ignored.
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


# ---------------------------------------------------------------------------
# CL-ADMM (paper §4.2)
# ---------------------------------------------------------------------------


def quadratic_primal(w, live, z_own_s, z_nbr_s, l_own_s, l_nbr_s, D_l, m_l,
                     sx, mu, rho):
    """Exact argmin of the CL-ADMM local Lagrangian for the quadratic loss
    over agents' slot rows (block elimination; paper §4.2 step 1).

    Leading axes ``...`` are a batch of rows (none for one row):
    w (..., k) raw edge weights (0 at pads); live (..., k) bool;
    z/l slot rows (..., k, p); D_l, m_l (...); sx (..., p) sum of the
    agent's samples.  Returns ``(theta_l (..., p), theta_js (..., k, p))``.

    The fused form of ``repro.kernels.dispatch`` (``admm_primal``/``xla``):
    masked slot sums and one weighted contraction over the slots.
    """
    f = torch.float32
    w = w.to(f)
    wl = torch.where(live, w, 0.0)
    b = rho * z_nbr_s.to(f) - l_nbr_s.to(f)
    denom = torch.where(live, w + rho, 1.0)
    n_nbrs = live.sum(-1)
    a = (D_l + 2.0 * mu * D_l * m_l + rho * n_nbrs
         - torch.sum(wl * wl / denom, dim=-1))
    zo = torch.where(live[..., None], rho * z_own_s.to(f) - l_own_s.to(f),
                     0.0)
    rhs = (2.0 * mu * D_l[..., None] * sx
           + torch.sum(zo, dim=-2)
           + torch.einsum("...k,...kp->...p", wl / denom,
                          torch.where(live[..., None], b, 0.0)))
    theta_l = rhs / a[..., None]
    theta_js = (w[..., None] * theta_l[..., None, :] + b) / denom[..., None]
    return theta_l, theta_js


def inexact_primal(w, live, z_own_s, z_nbr_s, l_own_s, l_nbr_s, D_l,
                   x, y, mask, theta0, mu, rho, *, loss_fn, b_steps, opt):
    """Inexact CL-ADMM primal: ``b_steps`` AdamW steps on the *reduced*
    local Lagrangian (DiNNO-style; DESIGN.md §18), over a batch of R
    agents' slot rows — the ``admm_primal_inexact`` op.

    The neighbor copies are eliminated in closed form each step,
    ``theta_js(theta) = (w theta + rho z_nbr - l_nbr) / (w + rho)``, so the
    optimizer sees, per row,

        F(theta) = mu D_l loss_fn(theta; x, y, mask)
                 + sum_live [ l_own (theta - z_own)
                              + rho/2 ||theta - z_own||^2 ]
                 + sum_live [ w/2 ||theta - theta_js||^2
                              + l_nbr (theta_js - z_nbr)
                              + rho/2 ||theta_js - z_nbr||^2 ].

    Rows are independent, so autograd of the summed objective gives each
    row's gradient (``optim.adamw.adamw_rows``).  ``b_steps=None``
    evaluates the B -> inf fixed point in closed form
    (:func:`quadratic_primal`; provable for the quadratic loss only, where
    it is the exact block-elimination solve).

    w (R, k) edge weights (0 at pads); live (R, k) bool; z/l slot rows
    (R, k, p); D_l (R,); x (R, m, q), y (R, m), mask (R, m) the rows'
    padded local data; theta0 (R, p) warm start; ``loss_fn(theta (p,), x
    (m, q), y (m,), mask (m,)) -> ()`` a guarded ``core.losses`` loss;
    ``opt`` an ``optim.adamw.AdamWConfig``.  Returns ``(theta (R, p),
    theta_js (R, k, p))``; dead slots of theta_js carry don't-care values
    (the engines keep the old ones under the live mask).
    """
    if b_steps is None:
        m_l = torch.sum(mask, dim=-1)
        sx = torch.sum(x * mask[..., None], dim=-2)
        return quadratic_primal(w, live, z_own_s, z_nbr_s, l_own_s, l_nbr_s,
                                D_l, m_l, sx, mu, rho)

    b = rho * z_nbr_s - l_nbr_s                               # (R, k, p)
    denom = torch.where(live, w + rho, 1.0)                   # (R, k)
    row_loss = torch.func.vmap(loss_fn)

    def theta_js_of(theta):
        return (w[..., None] * theta[..., None, :] + b) / denom[..., None]

    def objective(theta):                                     # (R,)
        tjs = theta_js_of(theta)
        d_own = theta[..., None, :] - z_own_s
        d_js = theta[..., None, :] - tjs
        d_nbr = tjs - z_nbr_s
        slot = (torch.sum(l_own_s * d_own, dim=-1)
                + 0.5 * rho * torch.sum(d_own * d_own, dim=-1)
                + 0.5 * w * torch.sum(d_js * d_js, dim=-1)
                + torch.sum(l_nbr_s * d_nbr, dim=-1)
                + 0.5 * rho * torch.sum(d_nbr * d_nbr, dim=-1))
        return (mu * D_l * row_loss(theta, x, y, mask)
                + torch.sum(torch.where(live, slot, 0.0), dim=-1))

    theta = adamw_rows(objective, theta0, b_steps, opt)
    return theta, theta_js_of(theta)


def _rho_tensor(rho, like):
    """``rho`` as a 0-d float32 tensor on ``like``'s device, the divisor of
    the edge math (see the module docstring); filled on the device, so no
    copy from the host."""
    return torch.full((), rho, dtype=torch.float32, device=like.device)


def admm_edge_halfstep(theta_own, k_own, l_own, l_nbr,
                       theta_pay, k_pay, l_own_pay, l_nbr_pay, rho):
    """One endpoint's half of the CL-ADMM edge update (paper §4.2 steps
    2-3) over (..., p) slices of a batch of event sides: this side's
    post-primal model, its copy of the partner and its two dual slots, and
    the same four quantities from the partner's payload.

    Returns ``(z_own, z_nbr, l_own_new, l_nbr_new)``.
    """
    r = _rho_tensor(rho, theta_own)
    z_own = 0.5 * ((l_own + l_nbr_pay) / r + theta_own + k_pay)
    z_nbr = 0.5 * ((l_own_pay + l_nbr) / r + theta_pay + k_own)
    l_own_new = l_own + rho * (theta_own - z_own)
    l_nbr_new = l_nbr + rho * (k_own - z_nbr)
    return z_own, z_nbr, l_own_new, l_nbr_new


def admm_edge_update(t_ii, t_ji, t_jj, t_ij, l_own_i, l_nbr_j_of_i,
                     l_own_j, l_nbr_i_of_j, rho: float):
    """Fused CL-ADMM Z + dual update for a batch of edges (paper steps 2-3).

    Inputs are (E, p) slices: for each edge e = (i, j),
      t_ii = Theta_i^i, t_ji = Theta_j^i, t_jj = Theta_j^j, t_ij = Theta_i^j
      l_own_i = Lambda_{ei}^i, l_nbr_j_of_i = Lambda_{ei}^j (i's duals)
      l_own_j = Lambda_{ej}^j, l_nbr_i_of_j = Lambda_{ej}^i (j's duals)
    Returns ``(z_i, z_j, l_own_i', l_nbr_j_of_i', l_own_j', l_nbr_i_of_j')``
    in the inputs' dtype, computed in float32.
    """
    dtype = t_ii.dtype
    f = torch.float32
    t_ii, t_ji, t_jj, t_ij = (a.to(f) for a in (t_ii, t_ji, t_jj, t_ij))
    l_own_i, l_nbr_j_of_i, l_own_j, l_nbr_i_of_j = (
        a.to(f) for a in (l_own_i, l_nbr_j_of_i, l_own_j, l_nbr_i_of_j))
    r = _rho_tensor(rho, t_ii)
    z_i = 0.5 * ((l_own_i + l_nbr_i_of_j) / r + t_ii + t_ji)
    z_j = 0.5 * ((l_own_j + l_nbr_j_of_i) / r + t_jj + t_ij)
    outs = (z_i, z_j, l_own_i + rho * (t_ii - z_i),
            l_nbr_j_of_i + rho * (t_ij - z_j),
            l_own_j + rho * (t_jj - z_j),
            l_nbr_i_of_j + rho * (t_ji - z_i))
    return tuple(a.to(dtype) for a in outs)


def landed(tgt, got, size: int):
    """(E,) bool: whether side e's target cell ``tgt[e]`` (< ``size``) is
    written this round, i.e. whether some side with the same target has
    ``got`` set.  Counted on the device (an integer index_add, exact in any
    order), so masking a scatter by it needs no host sync."""
    hit = torch.zeros(size, dtype=torch.int32, device=tgt.device)
    hit.index_add_(0, tgt, got.to(torch.int32))
    return hit[tgt] > 0


def cl_edge_step(theta, K, Z_own, Z_nbr, L_own, L_nbr,
                 pay_th, pay_K, pay_Lo, pay_Ln,
                 upd, own_s, oth_a, oth_s, stale, got, *, rho: float):
    """One batched CL-ADMM edge phase (scenario-engine semantics; the
    ``cl_edge_step`` op and ``repro.kernels.round_fuse.cl_edge_step``).

    theta (n, p) and K (n, k, p) are post-primal; Z_own, Z_nbr, L_own,
    L_nbr (n, k, p) are round-start.  Per event side e, agent ``upd[e]``
    updates its slot ``own_s[e]`` from partner ``oth_a[e]``'s payload:
    its fresh cells (slot ``oth_s[e]``) or, where ``stale[e]``, the
    prefetched stale rows ``pay_*[e]`` (E, p).  The four results land where
    ``got`` — every read comes from the round-start state, every write
    after all reads.  Updates the four Z/L arrays in place and returns them.
    """
    n, k, p = K.shape
    st = stale[:, None]
    a, s = oth_a.long(), oth_s.long()
    u, o = upd.long(), own_s.long()
    pay = (torch.where(st, pay_th, theta[a]), torch.where(st, pay_K, K[a, s]),
           torch.where(st, pay_Lo, L_own[a, s]),
           torch.where(st, pay_Ln, L_nbr[a, s]))
    new = admm_edge_halfstep(theta[u], K[u, o], L_own[u, o], L_nbr[u, o],
                             *pay, rho)
    tgt = u * k + o
    hit = landed(tgt, got, n * k)[:, None]
    for arr, val in zip((Z_own, Z_nbr, L_own, L_nbr), new):
        flat = arr.view(n * k, p)
        # scatter: idempotent — duplicate (agent, slot) targets carry
        # bit-identical values: each reads the same round-start cells and
        # post-primal rows, and staleness is drawn per sender per round;
        # a target no side got writes its own value back
        flat[tgt] = torch.where(hit, val, flat[tgt])
    return Z_own, Z_nbr, L_own, L_nbr


# ---------------------------------------------------------------------------
# Joint collaboration-graph learning (DESIGN.md §13)
# ---------------------------------------------------------------------------


def simplex_project_rows(v, live):
    """Euclidean projection of each row of ``v`` onto the probability
    simplex restricted to its ``live`` slots (the sort-and-threshold form
    of Held et al. 1974 / Duchi et al. 2008, over rows).

    v, live: (..., k).  Dead slots are excluded from the support and get
    an exact 0; rows with no live slot return all zeros.  The sort is
    descending and the cumsum float32, as in the JAX package; a CUDA
    cumsum associates its adds differently from the CPU's, so results on
    the card agree with the CPU's to rounding, not bit for bit.
    """
    f = torch.float32
    vm = torch.where(live, v.to(f), NEG_INF)                   # (..., k)
    u = -torch.sort(-vm, dim=-1).values                        # descending
    css = torch.cumsum(u, dim=-1)
    r = torch.arange(1, v.shape[-1] + 1, dtype=f, device=v.device)
    cond = u * r > css - 1.0                                   # support test
    rho_n = cond.sum(dim=-1)                                   # support size
    idx = torch.clamp(rho_n - 1, min=0)
    tau = (torch.gather(css, -1, idx[..., None])[..., 0] - 1.0) \
        / torch.clamp(rho_n, min=1).to(f)
    out = torch.clamp(vm - tau[..., None], min=0.0)
    return torch.where(live & (rho_n > 0)[..., None], out, 0.0)


def edge_reweight(d, w, live, *, eta: float, lam: float):
    """Local collaboration-graph re-estimation step (Zantedeschi et al.
    2019, arXiv:1901.08460) — the ``edge_reweight`` op.

    Each row solves  min_{w in simplex(live)} <w, d> + lam ||w||^2, whose
    closed form is the simplex projection of ``-d / (2 lam)``, and relaxes
    toward it:  w' = (1 - eta) w + eta proj(-d / (2 lam)).  d: (..., k)
    dissimilarities (ignored at dead slots); w: (..., k) row-stochastic
    weights; live: (..., k) bool.  Slots outside ``live`` get an exact 0;
    rows with no live slot come back all zero.  ``eta`` and ``lam`` are
    numbers, or float32 tensors that broadcast against the rows (the
    sweeps' per-trial values, (T, 1, 1)).
    """
    f = torch.float32
    two_lam = 2.0 * lam if isinstance(lam, torch.Tensor) \
        else torch.full((), 2.0 * lam, dtype=f, device=d.device)
    target = simplex_project_rows(-d.to(f) / two_lam, live)
    out = (1.0 - eta) * w.to(f) + eta * target
    return torch.where(live, out, 0.0).to(w.dtype)


#: Logit of a masked (query, key) pair, and the simplex projection's
#: dead-slot value, as in the JAX package.
NEG_INF = -1e30


def flash_attention(q, k, v, *, window=None):
    """Causal (optionally sliding-window) attention: what the Pallas
    ``flash_attention`` kernel computes (the ``attention`` op).

    q: (B, S, H, hd); k, v: (B, S, K, hd) with K | H — query head h reads
    kv head ``h // (H // K)`` (``jnp.repeat`` of the kv heads).  Logits in
    float32 scaled by ``hd ** -0.5``; a key attends where ``kpos <= qpos``
    and, with a window, ``kpos > qpos - window`` (else ``NEG_INF``); the
    float32 softmax weights multiply v in float32 (the Pallas kernel keeps
    them in float32; ``repro.kernels.ref.flash_attention`` rounds them to
    v's dtype first); the output is cast to q's dtype.
    """
    B, S, H, hd = q.shape
    K = k.shape[2]
    if K != H:
        k = k.repeat_interleave(H // K, dim=2)
        v = v.repeat_interleave(H // K, dim=2)
    f = torch.float32
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(f), k.to(f))
    logits.mul_(hd ** -0.5)
    pos = torch.arange(S, device=q.device)
    keep = pos[None, :] <= pos[:, None]
    if window is not None:
        keep &= pos[None, :] > pos[:, None] - window
    logits.masked_fill_(~keep, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    del logits
    return torch.einsum("bhqk,bkhd->bqhd", w, v.to(f)).to(q.dtype)
