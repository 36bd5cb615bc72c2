"""Backend dispatch for the model-propagation, CL-ADMM, graph-learning
and LM serving hot paths (counterpart of ``repro.kernels.dispatch``,
slimmed to this port's ops and impls).

A registry keyed by

    op   ∈ {mix, sparse_mix, round_step, neighbor_aggregate, admm_primal,
            admm_primal_inexact, admm_edge, cl_edge_step, edge_reweight,
            attention}
    impl ∈ {reference, cuda, reference_sharded, cuda_sharded}

maps to callables; ``resolve(op, backend, device)`` returns the one a call
site uses.  ``reference`` is plain PyTorch (``kernels.ref``, which is
also each kernel module's plain version), ``cuda`` the hand-written Hopper
kernel.  The two ``*_sharded`` names are row-sharded wrappers over a sim
mesh (``kernels.sharded``; the mesh set by ``launch.sim_mesh.use_mesh``):
``reference_sharded`` runs the plain version on each row block (``mix``,
``sparse_mix``, ``admm_primal``, ``admm_edge``, ``edge_reweight``), and
``cuda_sharded`` the ``sparse_gather_mix`` kernel (``sparse_mix`` only).
They are wrappers, not plain versions: :func:`implementations` leaves them
out.  Selection:

* **auto** (the default): ``cuda`` for a CUDA device where the op has a
  kernel, ``reference`` otherwise (CPU tensors, or ``neighbor_aggregate``,
  ``admm_primal``, ``admm_primal_inexact`` and ``edge_reweight``, which
  have no TPU kernel to port and run as torch ops).
* per-op **overrides** via :class:`ReproBackend`; asking for ``cuda`` (or
  ``cuda_sharded``) on a non-CUDA device raises :class:`BackendUnavailable`
  — nothing falls back silently.  Auto never picks a sharded impl.

Engine modules reach kernels only through this module (repro-lint
RPL001), which also re-exports the ``round_step`` layout helpers and the
kernels' launch counters.

Canonical signatures (shared by every impl of an op):

    mix:        (theta (T?,n,D), theta_sol (T?,n,D), A (T?,n,n), b (T?,n))
                -> (T?,n,D); the leading trial axis is optional, and the
                kernel takes all trials in one launch; float32, or for
                n <= 32 and D > 8 (the LM coupling) theta, theta_sol and
                A in bf16 with b float32, the sums float32
    sparse_mix: (table (N,p), idx (n,k) int32, w (n,k), b (n,),
                 sol (n,p), *, order=None) -> (n,p); order, an (n,)
                 int32 row permutation, is the kernel's row schedule
                 (the reference ignores it; the result is the same)
    round_step: (theta (n,p), Ke (n*k,p+1), got_ever (n,) bool, msg (2B,p),
                 tgt_row (2B,) int32, enc (2B,) int32, k_old (2B,p),
                 theta_base (n,p), a_w (n*k,)) -> (theta, Ke, got_ever,
                 keep (2B,) bool); both impls update the state in
                 place and return it
    neighbor_aggregate: (w (...,k), theta (...,k,p)) -> (...,p)
    admm_primal: (w (...,k), live (...,k) bool, z_own, z_nbr, l_own,
                  l_nbr (...,k,p), D (...), m (...), sx (...,p), mu, rho)
                 -> (theta (...,p), theta_js (...,k,p))
    admm_primal_inexact: (w (...,k), live (...,k) bool, z_own, z_nbr,
                  l_own, l_nbr (...,k,p), D (...), x (...,m,q), y (...,m),
                  mask (...,m), theta0 (...,p), mu, rho, *, loss_fn,
                  b_steps, opt) -> (theta (...,p), theta_js (...,k,p));
                 batched over the leading axes (the JAX op is rowwise,
                 under vmap)
    admm_edge:  (t_ii, t_ji, t_jj, t_ij, l_own_i, l_nbr_j_of_i, l_own_j,
                 l_nbr_i_of_j (E,p), *, rho) -> (z_i, z_j, and the four
                 updated duals, each (E,p))
    cl_edge_step: (theta (n,p), K, Z_own, Z_nbr, L_own, L_nbr (n,k,p),
                   pay_th, pay_K, pay_Lo, pay_Ln (E,p), upd, own_s, oth_a,
                   oth_s (E,) int32, stale, got (E,) bool, *, rho)
                  -> (Z_own, Z_nbr, L_own, L_nbr); both impls update the
                  four arrays in place and return them; the kernel takes
                  E = 2B sides in event pairs (side b + B mirrors side b)
    edge_reweight: (d (...,k), w (...,k), live (...,k) bool, *, eta, lam)
                   -> (...,k)
    attention:  (q (B,S,H,hd), k (B,S,K,hd), v (B,S,K,hd), *, window=None)
                -> (B,S,H,hd), causal; K | H and query head h reads kv
                head h // (H // K) (``jnp.repeat`` of the kv heads)
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import torch

from . import admm_update as _au
from . import flash_attention as _fa
from . import graph_mix as _gm
from . import ref
from . import round_fuse as _rf
from . import sharded as _sh
from . import sparse_mix as _sm
# layout/prefetch helpers shared by every round_step / cl_edge_step impl,
# re-exported so engine code reaches them through dispatch
from .round_fuse import (cl_stale_prefetch, decode_slots,  # noqa: F401
                         encode_slots, round_prefetch, round_scales,
                         round_stale_src)

IMPLS = ("reference", "cuda", "reference_sharded", "cuda_sharded")
SHARDED_IMPLS = ("reference_sharded", "cuda_sharded")


class BackendUnavailable(RuntimeError):
    """Requested implementation cannot run on this device."""


_REGISTRY: Dict[str, Dict[str, Callable]] = {}


def register(op: str, impl: str):
    """Decorator registering ``fn`` as implementation ``impl`` of ``op``."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; one of {IMPLS}")

    def deco(fn):
        _REGISTRY.setdefault(op, {})[impl] = fn
        return fn
    return deco


def ops() -> Tuple[str, ...]:
    """All registered op names."""
    return tuple(sorted(_REGISTRY))


def implementations(op: str) -> Tuple[str, ...]:
    """Registered single-device implementation names for ``op``
    (reference first); the mesh wrappers are :data:`SHARDED_IMPLS`."""
    names = [n for n in _REGISTRY[op] if n not in SHARDED_IMPLS]
    return tuple(sorted(names, key=lambda n: (n != "reference", n)))


@dataclasses.dataclass(frozen=True)
class ReproBackend:
    """Backend selection threaded through the algorithm layers.

    default:   implementation for every op without an override ("auto",
               "reference" or "cuda").
    overrides: per-op (op, impl) pairs, e.g. (("mix", "reference"),).
    """

    default: str = "auto"
    overrides: Tuple[Tuple[str, str], ...] = ()

    @classmethod
    def using(cls, default: str = "auto", **per_op: str) -> "ReproBackend":
        """Keyword-friendly constructor: ``ReproBackend.using(mix="cuda")``."""
        return cls(default=default, overrides=tuple(sorted(per_op.items())))

    def impl_for(self, op: str) -> str:
        """The implementation name this backend selects for ``op``."""
        for o, impl in self.overrides:
            if o == op:
                return impl
        return self.default


def resolve(op: str, backend, device) -> Callable:
    """The callable implementing ``op`` under ``backend`` for tensors on
    ``device`` (``backend=None`` means auto)."""
    if op not in _REGISTRY:
        raise KeyError(f"unknown op {op!r}; registered: {ops()}")
    impls = _REGISTRY[op]
    device = torch.device(device)
    name = (backend or ReproBackend()).impl_for(op)
    if name == "auto":
        name = "cuda" if device.type == "cuda" and "cuda" in impls \
            else "reference"
    if name not in impls:
        raise KeyError(f"op {op!r} has no implementation {name!r}; "
                       f"registered: {tuple(sorted(impls))}")
    if name.startswith("cuda") and device.type != "cuda":
        raise BackendUnavailable(
            f"{op}/{name} is a CUDA kernel and the tensors are on {device}; "
            f"use the 'reference' implementation or a CUDA device")
    return impls[name]


def launch_counts() -> Dict[str, int]:
    """Kernel launches so far, per kernel wrapper."""
    return {"graph_mix": _gm.launches, "sparse_gather_mix": _sm.launches,
            "round_step": _rf.launches, "cl_edge_step": _rf.cl_edge_launches,
            "admm_edge_update": _au.launches,
            "flash_attention": _fa.launches}


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    _gm.launches = _sm.launches = _sm.ordered_launches = _rf.launches = 0
    _rf.cl_edge_launches = _au.launches = _fa.launches = 0


register("mix", "reference")(ref.graph_mix)
register("mix", "cuda")(_gm.graph_mix)
register("sparse_mix", "reference")(ref.sparse_gather_mix)
register("sparse_mix", "cuda")(_sm.sparse_gather_mix)
register("round_step", "reference")(ref.gossip_round_step)
register("round_step", "cuda")(_rf.round_step)
register("neighbor_aggregate", "reference")(ref.neighbor_aggregate)
register("admm_primal", "reference")(ref.quadratic_primal)
register("admm_primal_inexact", "reference")(ref.inexact_primal)
register("admm_edge", "reference")(ref.admm_edge_update)
register("admm_edge", "cuda")(_au.admm_edge_update)
register("cl_edge_step", "reference")(ref.cl_edge_step)
register("cl_edge_step", "cuda")(_rf.cl_edge_step)
register("edge_reweight", "reference")(ref.edge_reweight)
register("attention", "reference")(ref.flash_attention)
register("attention", "cuda")(_fa.flash_attention)


def _sharded(fn, inner):
    """``fn`` (a ``kernels.sharded`` wrapper) around ``inner``, on the mesh
    set by ``launch.sim_mesh.use_mesh``."""
    def run(*args, **kw):
        return fn(*args, inner=inner, **kw)
    run.__name__ = run.__qualname__ = f"{fn.__name__}[{inner.__name__}]"
    return run


register("mix", "reference_sharded")(
    _sharded(_sh.sharded_graph_mix, ref.graph_mix))
register("sparse_mix", "reference_sharded")(
    _sharded(_sh.sharded_sparse_mix, ref.sparse_gather_mix))
register("sparse_mix", "cuda_sharded")(
    _sharded(_sh.sharded_sparse_mix, _sm.sparse_gather_mix))
register("admm_primal", "reference_sharded")(
    _sharded(_sh.sharded_admm_primal, ref.quadratic_primal))
register("admm_edge", "reference_sharded")(
    _sharded(_sh.sharded_admm_edge, ref.admm_edge_update))
register("edge_reweight", "reference_sharded")(
    _sharded(_sh.sharded_edge_reweight, ref.edge_reweight))
