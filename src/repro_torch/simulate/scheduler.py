"""Vectorized event engine: batched Poisson wake-ups + network conditions
(counterpart of ``repro.simulate.scheduler``).

The asynchronous model of the paper (§3.2) is a Poisson clock per agent;
conditioned on a tick, the waking agent is drawn proportionally to its
rate.  One round draws a *batch* of B wake-ups and the engine applies them
together — collisions are deterministic because all communication lands
before any model update reads.

Network conditions, all vectorized per event: iid per-direction message
loss (``drop_prob``), one-round staleness drawn per *sender agent* per
round (so duplicate events in a batch carry identical payloads),
stragglers waking at ``straggler_factor`` x the base rate, churn (agents
toggling in and out of the network), and a partition window during which
every message crossing the topology's two halves is lost.

Every draw comes from an explicit ``torch.Generator`` on the run's device.
torch cannot replay ``jax.random``, so the same seed gives other events
than the JAX package; to replay the reference's events, hand its
``EventStream`` to the engine (``repro_torch.convert.stream_from_arrays``).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class NetworkConditions:
    """Static fault model; all fields are plain python numbers."""

    drop_prob: float = 0.0
    stale_prob: float = 0.0
    straggler_frac: float = 0.0
    straggler_factor: float = 0.1
    churn_rate: float = 0.0
    partition_start: int = -1     # round index; -1 = never partition
    partition_end: int = -1

    @property
    def has_partition(self) -> bool:
        """Whether a partition window [start, end) is configured."""
        return 0 <= self.partition_start < self.partition_end


class EventBatch(NamedTuple):
    """One round of wake-up events (all tensors (B,))."""

    i: torch.Tensor            # waking agent (int32)
    s: torch.Tensor            # chosen neighbor slot in i's row (int32)
    j: torch.Tensor            # neighbor id  = nbr_idx[i, s] (int32)
    r: torch.Tensor            # reverse slot = rev_slot[i, s] (int32)
    deliver_ij: torch.Tensor   # bool: i's model reached j
    deliver_ji: torch.Tensor   # bool: j's model reached i
    stale_ij: torch.Tensor     # bool: delivered value is one round old
    stale_ji: torch.Tensor
    valid: torch.Tensor        # bool: a real wake-up (False for all-dead
                               # draws or degree-0 wakers)
    cut: torch.Tensor          # bool: lost to an active partition window
    dead: torch.Tensor         # bool: an endpoint was churned out


class EventStream(NamedTuple):
    """A full scenario's wake-up events, materialized up front.

    All tensors are (rounds, B) except ``active_frac`` (rounds,), the
    live-agent fraction after each round's churn.  Field semantics match
    :class:`EventBatch`, whose fields are a prefix of this tuple.
    """

    i: torch.Tensor
    s: torch.Tensor
    j: torch.Tensor
    r: torch.Tensor
    deliver_ij: torch.Tensor
    deliver_ji: torch.Tensor
    stale_ij: torch.Tensor
    stale_ji: torch.Tensor
    valid: torch.Tensor
    cut: torch.Tensor
    dead: torch.Tensor
    active_frac: torch.Tensor

    @property
    def rounds(self) -> int:
        """Number of rounds in the stream."""
        return int(self.i.shape[0])

    def batch_at(self, t: int) -> EventBatch:
        """Round ``t``'s events."""
        return EventBatch(*(f[t] for f in self[:len(EventBatch._fields)]))


def stream_totals(stream: EventStream) -> tuple:
    """(delivered, dropped, invalid) accounting of a materialized stream.

    Never-valid events are excluded from both delivered and dropped, so
    for every stream  delivered + dropped == 2 * (events - invalid).
    """
    d_ij, d_ji, valid = stream.deliver_ij, stream.deliver_ji, stream.valid
    delivered = int(d_ij.sum()) + int(d_ji.sum())
    dropped = int((valid & ~d_ij).sum()) + int((valid & ~d_ji).sum())
    return delivered, dropped, int((~valid).sum())


def straggler_rates(gen: torch.Generator, cond: NetworkConditions, n: int,
                    device) -> torch.Tensor:
    """Per-agent base wake rates: 1.0, or straggler_factor for stragglers."""
    ones = torch.ones(n, dtype=torch.float32, device=device)
    if cond.straggler_frac <= 0.0:
        return ones
    mask = torch.rand(n, generator=gen, device=device) < cond.straggler_frac
    return torch.where(mask, cond.straggler_factor, ones)


def draw_wakeups(gen: torch.Generator, weights: torch.Tensor, batch: int):
    """B wake-ups ~ categorical(weights) via inverse cdf.

    Returns ``(i, alive)``: the (B,) int32 agent draws and a 0-d bool that
    is False when the weight vector is all zero (every agent churned out);
    callers treat such a batch as never-valid.
    """
    n = weights.shape[0]
    cdf = torch.cumsum(weights, dim=0)
    alive = cdf[-1] > 0
    total = torch.clamp(cdf[-1], min=1e-30)
    u = torch.rand(batch, generator=gen, device=weights.device) * total
    i = torch.searchsorted(cdf, u, right=True)
    return i.clamp(0, n - 1).int(), alive


def draw_slots(gen: torch.Generator, i: torch.Tensor,
               deg_count: torch.Tensor) -> torch.Tensor:
    """Uniform neighbor slot per event (pi_i uniform over N_i, §3.2);
    degree-0 wakers are clamped to slot 0 (``draw_events`` marks them
    invalid)."""
    u = torch.rand(i.shape, generator=gen, device=i.device)
    deg = deg_count[i]
    s = torch.minimum((u * deg.float()).int(), deg - 1)
    return s.clamp(min=0).int()


def draw_events(gen: torch.Generator, cond: NetworkConditions, tabs,
                part_half, active, rates, t: int, batch: int) -> EventBatch:
    """Sample one round's EventBatch under the network conditions.

    tabs: DeviceTables; part_half: (n,) bool; active: (n,) bool;
    rates: (n,) f32 base rates; t: the round index.
    """
    dev = active.device
    i, alive = draw_wakeups(gen, rates * active.float(), batch)
    s = draw_slots(gen, i, tabs.deg_count)
    j = tabs.nbr_idx[i, s]
    r = tabs.rev_slot[i, s]
    valid = alive & (tabs.deg_count[i] > 0)
    ok = valid
    if cond.drop_prob > 0.0:
        drop_ij = torch.rand(batch, generator=gen, device=dev) \
            < cond.drop_prob
        drop_ji = torch.rand(batch, generator=gen, device=dev) \
            < cond.drop_prob
    else:
        drop_ij = drop_ji = torch.zeros(batch, dtype=torch.bool, device=dev)
    if cond.has_partition \
            and cond.partition_start <= t < cond.partition_end:
        cut = part_half[i] != part_half[j]
        ok = ok & ~cut
    else:
        cut = torch.zeros(batch, dtype=torch.bool, device=dev)
    # an inactive endpoint kills both directions
    dead = ~(active[i] & active[j])
    ok = ok & ~dead
    if cond.stale_prob > 0.0:
        # per-sender-per-round draw: identical payload for duplicate events
        n = tabs.deg_count.shape[0]
        lagging = torch.rand(n, generator=gen, device=dev) < cond.stale_prob
        stale_ij, stale_ji = lagging[i], lagging[j]
    else:
        stale_ij = stale_ji = torch.zeros(batch, dtype=torch.bool,
                                          device=dev)
    return EventBatch(i, s, j, r, ok & ~drop_ij, ok & ~drop_ji,
                      stale_ij, stale_ji, valid, cut, dead)


def churn_step(gen: torch.Generator, cond: NetworkConditions,
               active: torch.Tensor) -> torch.Tensor:
    """Toggle agents in/out of the network with prob churn_rate per round."""
    if cond.churn_rate <= 0.0:
        return active
    toggle = torch.rand(active.shape, generator=gen, device=active.device) \
        < cond.churn_rate
    return active ^ toggle


def precompute_event_stream(tabs, part_half, conditions: NetworkConditions,
                            batch: int, seed: int, rounds: int,
                            device=None) -> EventStream:
    """Draw a whole scenario's events on ``device`` (CUDA when None) from
    one ``torch.Generator`` seeded with ``seed``: straggler rates first,
    then per round the events and the churn step."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    n = tabs.deg_count.shape[0]
    part_half = torch.as_tensor(part_half, device=device)
    rates = straggler_rates(gen, conditions, n, device)
    active = torch.ones(n, dtype=torch.bool, device=device)
    evs, fracs = [], []
    for t in range(rounds):
        evs.append(draw_events(gen, conditions, tabs, part_half, active,
                               rates, t, batch))
        active = churn_step(gen, conditions, active)
        fracs.append(active.float().mean())
    cols = [torch.stack(f) for f in zip(*evs)]
    return EventStream(*cols, torch.stack(fracs))


# ---------------------------------------------------------------------------
# Inference requests of the personalization service
# ---------------------------------------------------------------------------


class ServeStream(NamedTuple):
    """A scenario's inference requests, drawn up front (DESIGN.md §16).

    Request ``q`` asks for user ``user[q]``'s current personalized model
    during round ``round[q]`` (sorted ascending).  Requests are reads:
    they touch no model state, no generator and no event of the gossip
    stream, which is why a run that serves replays the serve-free
    trajectory bit for bit.  A request is served from the committed
    snapshot of the record chunk its round falls in.
    """

    user: np.ndarray     # (R,) int32 requested agent/user id
    round: np.ndarray    # (R,) int32 arrival round, sorted ascending

    @property
    def n_requests(self) -> int:
        """Total request count R."""
        return int(self.user.shape[0])


def precompute_serve_stream(n: int, rounds: int, rate: float,
                            seed: int = 0) -> ServeStream:
    """``rate`` requests a round for ``rounds`` rounds over ``n`` users:
    uniform arrival rounds (sorted) and users from a numpy generator of
    its own, the JAX package's draws from the same seed.  The request
    count is ``round(rate * rounds)``."""
    if rounds < 1:
        raise ValueError(f"rounds must be >= 1, got {rounds}")
    n_req = int(round(rate * rounds))
    rng = np.random.default_rng(seed)
    t = np.sort(rng.integers(0, rounds, size=n_req)).astype(np.int32)
    user = rng.integers(0, n, size=n_req).astype(np.int32)
    return ServeStream(user=user, round=t)


def serve_chunk_requests(serve: ServeStream, n_rec: int,
                         record_every: int) -> list:
    """The requests of each record chunk: ``n_rec`` (user, round) int32
    array pairs, chunk ``ci`` holding the rounds ``[ci * record_every,
    (ci + 1) * record_every)`` that snapshot ``ci`` commits; requests past
    the recorded horizon are dropped."""
    edges = np.searchsorted(serve.round,
                            np.arange(n_rec + 1) * record_every)
    return [(serve.user[edges[ci]:edges[ci + 1]],
             serve.round[edges[ci]:edges[ci + 1]])
            for ci in range(n_rec)]
