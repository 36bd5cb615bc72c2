"""``round_step``: one fused MP gossip round over the flat slot table, and
``cl_edge_step``: the CL-ADMM edge phase of one scenario round, with the
layout and prefetch helpers around them (counterpart of
``repro.kernels.round_fuse``).

The flat table ``Ke (n*k, p+1)`` holds the neighbor slots with an id
column at ``p`` that records the event that last wrote each slot.  A
round lands ``[msg | id]`` at the encoded targets ``enc = row*k + slot``
(undelivered events ride at the ``n*k`` sentinel), elects one winner per
slot, and telescopes Eq. 6: each winner adds ``a_w (msg - k_old)`` to its
row, after the row's first receipt swaps in ``theta_base`` (the Eq. 6
image of the warm-start slots) and sets ``got_ever``.

The CUDA kernel (``csrc/round_step.cu``) replaces the Pallas TPU
megakernel ``repro/kernels/round_fuse.py::round_step_pallas``; the source
note there gives its two launches, the winner rule, its round-tagged
election words (a persistent buffer per (n*k, device), :func:`round_words`,
never filled again after it is made) and its bound.  It
updates ``theta``, ``Ke`` and ``got_ever`` in place (the state lives in
HBM with no size cap, and copying a multi-GB slot table every round would
cost more than the round): callers use the returned tensors and do not
read the inputs again.  Beside it sits the plain PyTorch version of the
same algorithm (``kernels.ref.gossip_round_step``: same winners, same
slot-order row sums, so the two agree bit for bit), which runs for tensors
on the CPU only; for CUDA tensors the wrapper launches the kernel or
raises.

``cl_edge_step``'s CUDA kernel (``csrc/cl_edge_step.cu``: one warp per
event, one event elected per edge through a claim launch and an
``atomicExch`` in the apply launch) replaces the Pallas TPU kernel
``repro/kernels/round_fuse.py::cl_edge_step_pallas``.  It too updates its
state (``Z_own``, ``Z_nbr``, ``L_own``, ``L_nbr``) in place, so the
one-round-stale payload — the previous round's post-primal ``theta``/``K``
and its round-start ``L_own``/``L_nbr`` — is gathered ahead by
:func:`cl_stale_prefetch` instead of kept as a whole snapshot.  Its plain
version is ``kernels.ref.cl_edge_step`` (CPU tensors only).

The helpers (``encode_slots``, ``decode_slots``, ``round_scales``,
``round_stale_src``, ``round_prefetch``, ``cl_stale_prefetch``) are plain
torch ops.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import cl_edge_step as cl_edge_step_plain
from .ref import gossip_round_step as round_step_plain

#: round_step calls that launched the kernel in this process.
launches = 0

#: cl_edge_step calls that launched the kernel in this process.
cl_edge_launches = 0

#: Event ids ride as float32 in the id column: exact below 2^24.
MAX_EVENTS = 1 << 24


# ---------------------------------------------------------------------------
# Flat slot-table layout helpers
# ---------------------------------------------------------------------------


def encode_slots(K):
    """(n, k, p) slot table -> flat (n*k, p+1) with the id column at -1."""
    n, k, p = K.shape
    flat = K.reshape(n * k, p)
    return torch.cat([flat, flat.new_full((n * k, 1), -1.0)], dim=1)


def decode_slots(Ke, k: int):
    """Flat (n*k, p+1) -> the (n, k, p) slot table (id column dropped)."""
    nk, p1 = Ke.shape
    return Ke[:, : p1 - 1].reshape(nk // k, k, p1 - 1)


def round_scales(nbr_p, c, *, alpha: float):
    """Flat (n*k,) per-slot Eq. 6 gain ``a_i * w_is`` with
    ``a_i = alpha / (alpha + (1 - alpha) c_i)``."""
    a = alpha / (alpha + (1.0 - alpha) * c)
    return (a[:, None] * nbr_p).reshape(-1)


def round_stale_src(theta_prev, ev_i, ev_j):
    """(2B, p) sender rows of the *previous* model for one event batch —
    the stale-message source of :func:`round_prefetch`, gathered before
    the in-place round that overwrites ``theta_prev``."""
    return theta_prev[torch.cat([ev_i, ev_j])]


def round_prefetch(theta, theta_prev, Ke, ev_i, ev_j, ev_s, ev_r,
                   d_ij, d_ji, st_ij, st_ji, *, stale_src=None,
                   no_stale=False):
    """Gather one event batch's ``round_step`` operands.

    Returns ``(msg, tgt_row, enc, k_old)`` for the 2B directed sends
    (i->j slot r first, then j->i slot s): the sender models
    (``theta_prev`` where stale, or ``stale_src`` when given), the receiver
    rows (``n`` where undelivered), the encoded flat targets (``n*k``
    sentinel where undelivered) and the pre-scatter slot values.
    ``tgt_row`` and ``enc`` are int32; every output is contiguous.
    """
    n, p = theta.shape
    nk = Ke.shape[0]
    km = nk // n
    send = torch.cat([ev_i, ev_j])
    if no_stale:
        msg = theta[send]
    else:
        stale = torch.cat([st_ij, st_ji])
        if stale_src is None:
            stale_src = theta_prev[send]
        msg = torch.where(stale[:, None], stale_src, theta[send])
    tgt_row = torch.cat([torch.where(d_ij, ev_j, n),
                         torch.where(d_ji, ev_i, n)]).int()
    tgt_slot = torch.cat([ev_r, ev_s]).int()
    enc = torch.where(tgt_row < n, tgt_row.clamp(max=n - 1) * km + tgt_slot,
                      nk).int()
    k_old = Ke[enc.clamp(max=nk - 1), :p].contiguous()
    return msg.contiguous(), tgt_row, enc, k_old


# ---------------------------------------------------------------------------
# round_step: kernel wrapper
# ---------------------------------------------------------------------------


def _check(theta, Ke, got_ever, msg, tgt_row, enc, k_old, theta_base, a_w):
    n, p = theta.shape
    nk = Ke.shape[0]
    m = msg.shape[0]
    if nk % n:
        raise ValueError(f"round_step: Ke rows {nk} not a multiple of n={n}")
    if m >= MAX_EVENTS:
        raise ValueError(f"round_step: {m} events; ids ride as float32 in "
                         f"the id column, exact only below {MAX_EVENTS}")
    want = {"theta": (theta, torch.float32, (n, p)),
            "Ke": (Ke, torch.float32, (nk, p + 1)),
            "got_ever": (got_ever, torch.bool, (n,)),
            "msg": (msg, torch.float32, (m, p)),
            "tgt_row": (tgt_row, torch.int32, (m,)),
            "enc": (enc, torch.int32, (m,)),
            "k_old": (k_old, torch.float32, (m, p)),
            "theta_base": (theta_base, torch.float32, (n, p)),
            "a_w": (a_w, torch.float32, (nk,))}
    for name, (t, dtype, shape) in want.items():
        if t.device != theta.device:
            raise ValueError(f"round_step: {name} on {t.device}, theta on "
                             f"{theta.device}")
        if t.dtype != dtype:
            raise TypeError(f"round_step: {name} must be {dtype}, got "
                            f"{t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"round_step: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"round_step: {name} must be contiguous")


def _buffer_key(nk: int, device):
    """Registry key of an election buffer: (n*k, device with its index)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return nk, device


#: The election words of ``round_step``'s kernel: one (n*k + 2,) int64
#: buffer per (n*k, device), made zero once and never filled again.  Each
#: call posts its winners under a tag one above the last call's (the tag is
#: kept in the buffer's last two words), so words of earlier calls can
#: neither win nor match.  Calls that share a buffer must run in stream
#: order (the engine's do); a call that raises drops its buffer.
_round_words = {}


def round_words(nk: int, device) -> torch.Tensor:
    """The kernel's (nk + 2,) int64 election buffer on ``device``, made
    zero on first use."""
    key = _buffer_key(nk, device)
    if key not in _round_words:
        # scatter: unique targets (one dict entry per key)
        _round_words[key] = torch.zeros(nk + 2, dtype=torch.int64,
                                        device=key[1])
    return _round_words[key]


def round_step_resources(k: int, p: int) -> dict:
    """Registers and local memory bytes (spills included) per thread of the
    apply kernel that :func:`round_step` launches for ``(k, p)``, as the
    CUDA runtime reports them (``cudaFuncGetAttributes``)."""
    out = (ctypes.c_int * 2)()
    err = _build.library().repro_round_step_attrs(k, p, ctypes.addressof(out))
    if err:
        raise RuntimeError(f"repro_round_step_attrs: CUDA error {err}")
    return {"registers": out[0], "local_bytes": out[1]}


def round_step(theta, Ke, got_ever, msg, tgt_row, enc, k_old, theta_base,
               a_w):
    """One fused MP gossip round; updates ``theta``, ``Ke`` and
    ``got_ever`` in place and returns ``(theta, Ke, got_ever, keep)`` with
    ``keep`` (2B,) bool the per-event winner mask.

    CUDA tensors launch the kernel; CPU tensors take the plain version.
    A call allocates only ``keep``: the election buffer
    (:func:`round_words`) is made once per (n*k, device) and never filled
    again.
    """
    global launches
    if theta.device.type == "cpu":
        return round_step_plain(theta, Ke, got_ever, msg, tgt_row, enc,
                                k_old, theta_base, a_w)
    if theta.device.type != "cuda":
        raise ValueError(f"round_step: no kernel for {theta.device}")
    _check(theta, Ke, got_ever, msg, tgt_row, enc, k_old, theta_base, a_w)
    n, p = theta.shape
    nk = Ke.shape[0]
    m = msg.shape[0]
    dev = theta.device
    words = round_words(nk, dev)
    keep = torch.empty((m,), dtype=torch.bool, device=dev)
    ptrs = [t.data_ptr() for t in (theta, Ke, got_ever, msg, k_old, tgt_row,
                                   enc, theta_base, a_w, words, keep)]
    try:
        _build.launch("repro_round_step", *ptrs, m, n, nk // n, p,
                      device=dev)
    except RuntimeError:
        # a launch that failed may leave this call's tag behind
        _round_words.pop(_buffer_key(nk, dev), None)
        raise
    launches += 1
    return theta, Ke, got_ever, keep


# ---------------------------------------------------------------------------
# cl_edge_step: stale-payload prefetch and kernel wrapper
# ---------------------------------------------------------------------------


def cl_stale_prefetch(theta, K, L_own, L_nbr, oth_a, oth_s):
    """The (E, p) stale payload rows of one round's event sides, gathered
    from the state they must come from: the partner ``oth_a``'s model and
    its slot ``oth_s`` of ``K``, ``L_own`` and ``L_nbr``.

    The engine calls it for round t+1's sides between round t's primal
    and edge phases, when ``theta``/``K`` are round t's post-primal values
    and ``L_own``/``L_nbr`` still round t's round-start values — round
    t+1's one-round-stale payload — so no (n, k, p) snapshot is kept.
    Returns ``(pay_th, pay_K, pay_Lo, pay_Ln)``, each contiguous.
    """
    a, s = oth_a.long(), oth_s.long()
    return (theta[a], K[a, s], L_own[a, s], L_nbr[a, s])


_CL_FLOATS = ("theta", "K", "Z_own", "Z_nbr", "L_own", "L_nbr", "pay_th",
              "pay_K", "pay_Lo", "pay_Ln")
_CL_SIDES = ("upd", "own_s", "oth_a", "oth_s", "stale", "got")

#: The election words of ``cl_edge_step``'s kernel: one (n*k,) int32
#: buffer per (n*k, device), made zero once and left zero by every call
#: that returns (the winner of each edge swaps its word back to 0), so a
#: round costs no fill.  Calls that share a buffer must run in stream order
#: (the engine's do); a call that raises drops its buffer.
_cl_flags = {}


def cl_edge_flags(nk: int, device) -> torch.Tensor:
    """The kernel's (nk,) int32 election buffer on ``device`` (zero
    between calls), made on first use."""
    key = _buffer_key(nk, device)
    if key not in _cl_flags:
        # scatter: unique targets (one dict entry per key)
        _cl_flags[key] = torch.zeros(nk, dtype=torch.int32, device=key[1])
    return _cl_flags[key]


def _check_cl(*args):
    theta, K = args[0], args[1]
    n, k, p = K.shape
    E = args[10].shape[0]
    if E % 2:
        raise ValueError(f"cl_edge_step: {E} sides; the kernel takes event "
                         f"pairs (side b + E/2 mirrors side b)")
    shapes = [(n, p)] + [(n, k, p)] * 5 + [(E, p)] * 4 + [(E,)] * 6
    dtypes = [torch.float32] * 10 + [torch.int32] * 4 + [torch.bool] * 2
    for name, t, shape, dtype in zip(_CL_FLOATS + _CL_SIDES, args, shapes,
                                     dtypes):
        if t.device != theta.device:
            raise ValueError(f"cl_edge_step: {name} on {t.device}, theta on "
                             f"{theta.device}")
        if t.dtype != dtype:
            raise TypeError(f"cl_edge_step: {name} must be {dtype}, got "
                            f"{t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"cl_edge_step: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"cl_edge_step: {name} must be contiguous")


def cl_edge_step(theta, K, Z_own, Z_nbr, L_own, L_nbr,
                 pay_th, pay_K, pay_Lo, pay_Ln,
                 upd, own_s, oth_a, oth_s, stale, got, *, rho: float):
    """One batched CL-ADMM edge phase (``kernels.ref.cl_edge_step``):
    updates ``Z_own``, ``Z_nbr``, ``L_own`` and ``L_nbr`` in place and
    returns them.

    The kernel takes the sides as the engine lays them out: E = 2B sides
    in event pairs, side ``b + B`` the mirror of side ``b`` (its ``upd``/
    ``own_s`` are side b's ``oth_a``/``oth_s`` and the other way round),
    each pair two ends of one edge of the topology, with staleness drawn
    per sender.  The indices must lie in range (agents < n, slots < k), as
    the scheduler's events do: checking either here would cost a host sync
    a round.

    CUDA tensors launch the kernel; CPU tensors take the plain version.
    """
    global cl_edge_launches
    args = (theta, K, Z_own, Z_nbr, L_own, L_nbr, pay_th, pay_K, pay_Lo,
            pay_Ln, upd, own_s, oth_a, oth_s, stale, got)
    if theta.device.type == "cpu":
        return cl_edge_step_plain(*args, rho=rho)
    if theta.device.type != "cuda":
        raise ValueError(f"cl_edge_step: no kernel for {theta.device}")
    _check_cl(*args)
    n, k, p = K.shape
    E = upd.shape[0]
    flags = cl_edge_flags(n * k, theta.device)
    try:
        _build.launch("repro_cl_edge_step",
                      *(t.data_ptr() for t in args + (flags,)), E, k, p,
                      float(rho), device=theta.device)
    except RuntimeError:
        # a launch that failed may leave claimed words behind
        _cl_flags.pop(_buffer_key(n * k, theta.device), None)
        raise
    cl_edge_launches += 1
    return Z_own, Z_nbr, L_own, L_nbr
