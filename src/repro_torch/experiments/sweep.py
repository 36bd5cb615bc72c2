"""Multi-trial sweeps over seeds and hyperparameters (paper Fig. 1–3
style; counterpart of ``repro.experiments.sweep``).

The paper's experiments average every curve over many random problem
instances and hyperparameter settings.  The JAX package runs each sweep as
one jitted program vmapped over a trial axis; here every tensor carries an
explicit leading trial axis (T, ...) and the sweep steps run in a Python
loop, one step of all T trials being one call of each op:

* :func:`mean_estimation_trials` — T = |seeds| x |alphas| x |noises|
  instances of the §5.1 collaborative mean-estimation problem (per-seed
  graph and data, optional multiplicative edge noise), stacked on the
  host with the JAX package's numpy draws.
* :func:`run_mp_sweep` — synchronous MP (Eq. 5) on all trials at once; a
  step is one ``mix`` op over the trial axis (the ``graph_mix`` kernel on
  the card, one launch for all trials), with per-trial Q_MP objective and
  L2-error trajectories.
* :func:`closed_form_comparison` — Prop. 1 with and without confidence
  values (the seed experiment) as batched linear solves.
* :func:`joint_mean_estimation_trials` / :func:`run_joint_sweep` — the
  dense joint alternation: a ``mix`` step under the learned mixing
  matrices, and every ``graph_every`` steps an ``edge_reweight`` step of
  all trials' rows.
* :func:`admm_mean_estimation_trials` / :func:`run_admm_sweep` —
  synchronous CL-ADMM (quadratic loss) over a (seed, mu, rho) grid; the
  primal step is the ``admm_primal`` op over every agent of every trial.
* :func:`run_scenario_sweep` / :func:`inexact_primal_axis` — grids of
  ``run_scenario`` runs over ``ScenarioSpec`` fields.

Trial containers and results are numpy, as in the JAX package; the
runners compute on ``device`` (CUDA when None) and copy the results back
once, at the end.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.collaborative import (ADMMState, _all_zl_update,
                                            _diag_blocks, cl_objective)
from repro_torch.core.graph_learning import DEAD_DISTANCE
from repro_torch.core.losses import (LOSSES, AgentData,
                                     confidences_from_counts, solitary_mean)
from repro_torch.core.model_propagation import mp_mix_operator, mp_objective
from repro_torch.data.synthetic import mean_estimation_problem
from repro_torch.kernels.dispatch import ReproBackend, resolve

# ---------------------------------------------------------------------------
# Trial containers (host-side stacked arrays; leading axis = trial)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MPTrials:
    """T stacked mean-estimation instances for the MP sweep."""

    W: np.ndarray          # (T, n, n) edge weights
    P: np.ndarray          # (T, n, n) stochastic mixing matrices
    theta_sol: np.ndarray  # (T, n, p) solitary models
    c: np.ndarray          # (T, n)   confidence values
    alpha: np.ndarray      # (T,)     MP trade-off per trial
    targets: np.ndarray    # (T, n, p) ground-truth models
    seed: np.ndarray       # (T,) int  instance seed per trial
    graph_noise: np.ndarray  # (T,)   edge-noise level per trial

    @property
    def n_trials(self) -> int:
        return self.W.shape[0]


@dataclasses.dataclass(frozen=True)
class MPSweepResult:
    """Per-trial trajectories of one MP sweep."""

    trials: MPTrials
    objective_hist: np.ndarray  # (T, sweeps) Q_MP after each iterate
    err_hist: np.ndarray        # (T, sweeps) mean L2 error to targets
    theta_final: np.ndarray     # (T, n, p)


@dataclasses.dataclass(frozen=True)
class ADMMTrials:
    """T stacked quadratic-loss instances for the CL-ADMM sweep."""

    W: np.ndarray         # (T, n, n)
    adj: np.ndarray       # (T, n, n) bool adjacency, from the float64 W —
                          # kernel weights can underflow to 0 in float32
    x: np.ndarray         # (T, n, m, p) local samples
    y: np.ndarray         # (T, n, m)    unused by the quadratic loss
    mask: np.ndarray      # (T, n, m)    live-sample mask
    theta_sol: np.ndarray  # (T, n, p)   warm start
    mu: np.ndarray        # (T,)
    rho: np.ndarray       # (T,)
    targets: np.ndarray   # (T, n, p)
    seed: np.ndarray      # (T,)

    @property
    def n_trials(self) -> int:
        return self.W.shape[0]


@dataclasses.dataclass(frozen=True)
class ADMMSweepResult:
    trials: ADMMTrials
    objective_hist: np.ndarray  # (T, iters) Q_CL after each iteration
    err_hist: np.ndarray        # (T, iters) mean L2 error to targets
    theta_final: np.ndarray     # (T, n, p)


# ---------------------------------------------------------------------------
# Trial builders (host loops — one problem instance per seed)
# ---------------------------------------------------------------------------


def _noisy_graph(W: np.ndarray, noise: float, rng) -> np.ndarray:
    """Symmetric multiplicative edge perturbation: W_ij *= exp(noise * g)."""
    if noise == 0.0:
        return W
    g = rng.standard_normal(W.shape)
    g = (g + g.T) / np.sqrt(2.0)
    return W * np.exp(noise * g)


def _instance(n: int, eps: float, seed: int):
    """One §5.1 instance on the host: (graph, data, targets, solitary
    models (n, 1) float32, confidences (n,) float32)."""
    g, data, targets, _ = mean_estimation_problem(n=n, eps=eps, seed=seed,
                                                  device="cpu")
    sol = solitary_mean(data).numpy()
    conf = confidences_from_counts(data.counts).numpy()
    return g, data, targets, sol, conf


def mean_estimation_trials(seeds: Sequence[int],
                           alphas: Sequence[float],
                           graph_noises: Sequence[float] = (0.0,),
                           n: int = 100, eps: float = 1.0,
                           noise_seed: int = 0) -> MPTrials:
    """Cartesian (seed x alpha x graph-noise) grid of §5.1 instances.

    The graph and data depend on the seed (and the optional edge noise);
    alpha only changes the algorithm, so those trials share instance
    arrays.
    """
    Ws, Ps, sols, cs, als, tgts, sds, nss = [], [], [], [], [], [], [], []
    nrng = np.random.default_rng(noise_seed)
    for seed, noise in itertools.product(seeds, graph_noises):
        g, _, targets, sol, conf = _instance(n, eps, seed)
        W = _noisy_graph(np.asarray(g.W, np.float64), noise, nrng)
        D = W.sum(axis=1)
        P = W / D[:, None]
        for alpha in alphas:
            Ws.append(W.astype(np.float32))
            Ps.append(P.astype(np.float32))
            sols.append(sol)
            cs.append(conf)
            als.append(np.float32(alpha))
            tgts.append(targets[:, None].astype(np.float32))
            sds.append(seed)
            nss.append(np.float32(noise))
    return MPTrials(np.stack(Ws), np.stack(Ps), np.stack(sols), np.stack(cs),
                    np.asarray(als), np.stack(tgts),
                    np.asarray(sds, np.int64), np.asarray(nss))


def admm_mean_estimation_trials(seeds: Sequence[int],
                                mus: Sequence[float],
                                rhos: Sequence[float],
                                n: int = 20, eps: float = 1.0) -> ADMMTrials:
    """Cartesian (seed x mu x rho) grid of quadratic CL instances."""
    insts = []
    for seed in seeds:
        g, data, targets, sol, _ = _instance(n, eps, seed)
        insts.append((seed, g, data, targets, sol))
    # different seeds draw different sample counts -> pad to a common m_max
    m_max = max(inst[2].x.shape[1] for inst in insts)

    def pad_m(a):
        a = np.asarray(a, np.float32)
        return np.pad(a, ((0, 0), (0, m_max - a.shape[1]))
                      + ((0, 0),) * (a.ndim - 2))

    Ws, adjs, xs, ys, ms, sols, mus_, rhos_, tgts, sds = (
        [] for _ in range(10))
    for seed, g, data, targets, sol in insts:
        for mu, rho in itertools.product(mus, rhos):
            Ws.append(np.asarray(g.W, np.float32))
            adjs.append(np.asarray(g.W) > 0)
            xs.append(pad_m(data.x))
            ys.append(pad_m(data.y))
            ms.append(pad_m(data.mask))
            sols.append(sol)
            mus_.append(np.float32(mu))
            rhos_.append(np.float32(rho))
            tgts.append(targets[:, None].astype(np.float32))
            sds.append(seed)
    return ADMMTrials(np.stack(Ws), np.stack(adjs), np.stack(xs),
                      np.stack(ys), np.stack(ms), np.stack(sols),
                      np.asarray(mus_), np.asarray(rhos_), np.stack(tgts),
                      np.asarray(sds, np.int64))


# ---------------------------------------------------------------------------
# Shared pieces of the runners
# ---------------------------------------------------------------------------


def _dev(a, device):
    """A trial array as a tensor on ``device`` (dtype kept)."""
    return torch.as_tensor(np.ascontiguousarray(a), device=device)


def _sq_err(theta, targets):
    """(T,) mean over agents of ||theta_i - target_i||^2."""
    return torch.mean(torch.sum((theta - targets) ** 2, dim=-1), dim=-1)


def _host(*hists):
    """(T, steps) numpy arrays of per-step (T,) tensors."""
    return [torch.stack(h, dim=1).cpu().numpy() for h in hists]


# ---------------------------------------------------------------------------
# MP sweep — one mix op over the trial axis per step
# ---------------------------------------------------------------------------


def run_mp_sweep(trials: MPTrials, sweeps: int = 300,
                 backend: Optional[ReproBackend] = None,
                 device=None) -> MPSweepResult:
    """Synchronous MP (Eq. 5) on every trial at once, on ``device`` (CUDA
    when None): each step is one ``mix`` op over the (T, n, p) models —
    on the card one ``graph_mix`` launch for all trials."""
    device = resolve_device(device)
    P, W, sol, c, targets = (_dev(a, device) for a in (
        trials.P, trials.W, trials.theta_sol, trials.c, trials.targets))
    alpha = _dev(trials.alpha, device)[:, None]                # (T, 1)
    mix = resolve("mix", backend, device)
    A_mix, b = mp_mix_operator(P, c, alpha)
    mu = ((1.0 - alpha) / alpha)[:, 0]                         # Q_MP anchor
    theta = sol
    objs, errs = [], []
    for _ in range(sweeps):
        theta = mix(theta, sol, A_mix, b)
        objs.append(mp_objective(theta, sol, W, c, mu))
        errs.append(_sq_err(theta, targets))
    return MPSweepResult(trials, *_host(objs, errs), theta.cpu().numpy())


def closed_form_comparison(trials: MPTrials, device=None
                           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Paper Fig. 2 experiment over all trials at once (batched
    ``torch.linalg.solve`` on ``device``, CUDA when None).

    Returns per-trial (err_with_conf, err_without_conf, win) — win is 1.0
    where confidence values help, 0.5 on exact ties (balanced data).
    """
    device = resolve_device(device)
    P, sol, c, targets = (_dev(a, device) for a in (
        trials.P, trials.theta_sol, trials.c, trials.targets))
    alpha = _dev(trials.alpha, device)[:, None, None]          # (T, 1, 1)
    abar = 1.0 - alpha
    eye = torch.eye(P.shape[-1], device=device)

    def solve(conf):
        A = eye - abar * (eye - torch.diag_embed(conf)) - alpha * P
        star = abar * torch.linalg.solve(A, conf[..., None] * sol)
        return _sq_err(star, targets)

    e_c = solve(c)
    e_nc = solve(torch.ones_like(c))
    win = torch.where(torch.abs(e_c - e_nc) < 1e-12, 0.5,
                      (e_c < e_nc).to(torch.float32))
    return e_c.cpu().numpy(), e_nc.cpu().numpy(), win.cpu().numpy()


# ---------------------------------------------------------------------------
# Joint graph-learning sweep — synchronous alternation over a
# (seed x alpha x graph-learning strength) grid (DESIGN.md §13)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class JointTrials:
    """T stacked §5.1 instances with a graph-learning-strength axis.

    ``labels`` carries the two-moons cluster of each agent so the sweep can
    report how much learned weight stays on intra-cluster candidate edges.
    """

    W: np.ndarray          # (T, n, n) candidate edge weights
    P: np.ndarray          # (T, n, n) initial stochastic mixing matrices
    adj: np.ndarray        # (T, n, n) bool candidate support
    theta_sol: np.ndarray  # (T, n, p)
    c: np.ndarray          # (T, n)
    alpha: np.ndarray      # (T,)
    eta: np.ndarray        # (T,)  graph-learning rate (0 = frozen graph)
    lam: np.ndarray        # (T,)  simplex-projection temperature
    targets: np.ndarray    # (T, n, p)
    labels: np.ndarray     # (T, n) two-moons cluster ids
    seed: np.ndarray       # (T,)

    @property
    def n_trials(self) -> int:
        return self.W.shape[0]


@dataclasses.dataclass(frozen=True)
class JointSweepResult:
    """Per-trial trajectories of one joint sweep."""

    trials: JointTrials
    objective_hist: np.ndarray   # (T, sweeps) Q_MP under the candidate W
    err_hist: np.ndarray         # (T, sweeps) mean L2 error to targets
    intra_mass_hist: np.ndarray  # (T, sweeps) learned weight share on
    #                              intra-cluster candidate edges
    theta_final: np.ndarray      # (T, n, p)
    P_final: np.ndarray          # (T, n, n) learned mixing matrices


def joint_mean_estimation_trials(seeds: Sequence[int],
                                 alphas: Sequence[float],
                                 etas: Sequence[float],
                                 lams: Sequence[float] = (1.0,),
                                 n: int = 100, eps: float = 1.0
                                 ) -> JointTrials:
    """Cartesian (seed x alpha x eta x lam) grid of §5.1 instances for the
    joint sweep — ``etas`` is the graph-learning-strength axis."""
    Ws, Ps, adjs, sols, cs, als, ets, lms, tgts, lbls, sds = (
        [] for _ in range(11))
    for seed in seeds:
        g, _, targets, sol, conf = _instance(n, eps, seed)
        W = np.asarray(g.W, np.float64)
        P = W / W.sum(axis=1)[:, None]
        labels = (targets < 0).astype(np.int32)
        for alpha, eta, lam in itertools.product(alphas, etas, lams):
            Ws.append(W.astype(np.float32))
            Ps.append(P.astype(np.float32))
            adjs.append(W > 0)
            sols.append(sol)
            cs.append(conf)
            als.append(np.float32(alpha))
            ets.append(np.float32(eta))
            lms.append(np.float32(lam))
            tgts.append(targets[:, None].astype(np.float32))
            lbls.append(labels)
            sds.append(seed)
    return JointTrials(np.stack(Ws), np.stack(Ps), np.stack(adjs),
                       np.stack(sols), np.stack(cs), np.asarray(als),
                       np.asarray(ets), np.asarray(lms), np.stack(tgts),
                       np.stack(lbls), np.asarray(sds, np.int64))


def run_joint_sweep(trials: JointTrials, sweeps: int = 300,
                    graph_every: int = 10,
                    backend: Optional[ReproBackend] = None,
                    device=None) -> JointSweepResult:
    """Synchronous joint MP + graph learning on every trial at once, on
    ``device`` (CUDA when None).

    Each step is one Eq. (5) ``mix`` op over all trials under their
    current learned mixing matrices, followed every ``graph_every`` steps
    by one ``edge_reweight`` op over all trials' dense candidate rows (per
    trial eta and lam) — the dense mirror of
    ``simulate.engines.run_joint_scenario``'s alternation.  Trials with
    ``eta == 0`` reproduce :func:`run_mp_sweep` (the blend is the
    identity).  The objective is Q_MP under the fixed candidate W; the
    learned matrices are tracked by their intra-cluster weight share.
    """
    device = resolve_device(device)
    P, W, adj, sol, c, targets = (_dev(a, device) for a in (
        trials.P, trials.W, trials.adj, trials.theta_sol, trials.c,
        trials.targets))
    intra = _dev((trials.labels[:, :, None] == trials.labels[:, None, :])
                 & trials.adj, device).to(torch.float32)
    alpha = _dev(trials.alpha, device)[:, None]                # (T, 1)
    eta, lam = (_dev(a, device)[:, None, None]                 # (T, 1, 1)
                for a in (trials.eta, trials.lam))
    mix = resolve("mix", backend, device)
    reweight = resolve("edge_reweight", backend, device)
    mu = ((1.0 - alpha) / alpha)[:, 0]
    theta, Pr = sol, P
    objs, errs, masses = [], [], []
    for t in range(sweeps):
        A_mix, b = mp_mix_operator(Pr, c, alpha)
        theta = mix(theta, sol, A_mix, b)
        if (t + 1) % graph_every == 0:
            # re-estimate all rows from the current pairwise distances
            diff = theta[:, :, None, :] - theta[:, None, :, :]
            d = torch.where(adj, torch.sum(diff * diff, dim=-1),
                            DEAD_DISTANCE)
            Pr = reweight(d, Pr, adj, eta=eta, lam=lam)
        objs.append(mp_objective(theta, sol, W, c, mu))
        errs.append(_sq_err(theta, targets))
        masses.append(torch.sum(Pr * intra, dim=(-2, -1))
                      / torch.clamp(torch.sum(Pr, dim=(-2, -1)),
                                    min=1e-30))
    return JointSweepResult(trials, *_host(objs, errs, masses),
                            theta.cpu().numpy(), Pr.cpu().numpy())


# ---------------------------------------------------------------------------
# CL-ADMM sweep — synchronous App. D iteration over agents and trials
# ---------------------------------------------------------------------------


def run_admm_sweep(trials: ADMMTrials, iters: int = 50,
                   backend: Optional[ReproBackend] = None,
                   device=None) -> ADMMSweepResult:
    """Synchronous quadratic CL-ADMM on every (seed, mu, rho) trial at
    once, on ``device`` (CUDA when None).

    The dense state is (T, n, n, p).  The primal step is the
    ``admm_primal`` op over every agent of every trial (agent l's slot row
    is the whole agent set, live where it has an edge; the reference
    engine's agent loop touches disjoint state, so this is that loop), run
    over the trial axis with ``torch.func.vmap`` so that each trial keeps
    its own mu and rho; then the Z and dual update of every edge.
    """
    device = resolve_device(device)
    W, mask, x, y, smask, sol, targets = (_dev(a, device) for a in (
        trials.W, trials.adj, trials.x, trials.y, trials.mask,
        trials.theta_sol, trials.targets))
    mu, rho = _dev(trials.mu, device), _dev(trials.rho, device)
    primal = torch.func.vmap(resolve("admm_primal", backend, device))
    loss_fn = LOSSES["quadratic"]
    n = sol.shape[1]
    D = torch.sum(W, dim=-1)
    m = torch.sum(smask, dim=-1)                        # (T, n) counts
    sx = torch.sum(x * smask[..., None], dim=-2)        # (T, n, p)
    eye = torch.eye(n, dtype=torch.bool, device=device)
    adj = (mask | eye)[..., None]
    edge = mask[..., None]
    rows, cols = sol[:, :, None, :], sol[:, None, :, :]  # sol[i], sol[j]
    st = ADMMState(torch.where(adj, cols, 0.0), torch.where(edge, rows, 0.0),
                   torch.where(edge, cols, 0.0),
                   *(sol.new_zeros(sol.shape[0], n, n, sol.shape[-1])
                     for _ in range(2)))
    data = AgentData(x=x, y=y, mask=smask)
    rho4 = rho[:, None, None, None]
    objs, errs = [], []
    for _ in range(iters):
        theta_l, theta_js = primal(W, mask, st.Z_own, st.Z_nbr, st.L_own,
                                   st.L_nbr, D, m, sx, mu, rho)
        st.T = torch.where(edge, theta_js, st.T)
        _diag_blocks(st.T).copy_(theta_l)
        _all_zl_update(st, mask, rho4)
        theta = st.models()
        objs.append(cl_objective(theta, W, mu, loss_fn, data))
        errs.append(_sq_err(theta, targets))
    return ADMMSweepResult(trials, *_host(objs, errs),
                           st.models().cpu().numpy())


# ---------------------------------------------------------------------------
# ScenarioSpec-driven sweeps over the asynchronous scenario engines
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ScenarioSweepResult:
    """All cells of one ``run_scenario`` grid sweep.

    ``cells[i]`` is the axis-value dict of trial i (cartesian order,
    itertools.product over the axes as given); ``specs``/``traces`` line
    up with it.
    """

    cells: Tuple[dict, ...]
    specs: tuple
    traces: tuple

    @property
    def n_trials(self) -> int:
        return len(self.traces)


def run_scenario_sweep(base, **axes: Sequence) -> ScenarioSweepResult:
    """Cartesian sweep of :func:`repro_torch.simulate.run_scenario` over
    ``ScenarioSpec`` fields.

    ``base`` is a fully specified :class:`~repro_torch.simulate.
    ScenarioSpec` (its ``device`` and ``backend`` apply to every cell
    unless they are axes); each axis is ``field_name=sequence_of_values``
    and every grid cell runs ``run_scenario(dataclasses.replace(base,
    **cell))``, one after another.  The twin of the dense sweeps above for
    experiments that need the event-driven engines (faults, telemetry)
    rather than the synchronous iterates.
    """
    from repro_torch.simulate import run_scenario

    names = tuple(axes)
    for name in names:
        if not hasattr(base, name):
            raise ValueError(f"ScenarioSpec has no field {name!r}")
    cells = tuple(dict(zip(names, values))
                  for values in itertools.product(*axes.values()))
    specs = tuple(dataclasses.replace(base, **cell) for cell in cells)
    return ScenarioSweepResult(cells, specs,
                               tuple(run_scenario(s) for s in specs))


def inexact_primal_axis(b_steps: Sequence[Optional[int]], **kw):
    """A ``primal=`` axis for :func:`run_scenario_sweep`: one
    ``core.primal.InexactPrimal`` per inner-step budget (``None`` = the
    B -> inf closed form, the exact-engine anchor column — DESIGN.md §18)::

        run_scenario_sweep(base, primal=inexact_primal_axis(
            [1, 4, 16, None], loss="quadratic", lr=0.2))
    """
    from repro_torch.core.primal import InexactPrimal

    return tuple(InexactPrimal(b_steps=b, **kw) for b in b_steps)
