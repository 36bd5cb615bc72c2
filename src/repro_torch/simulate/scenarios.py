"""Named fault scenarios for the event-driven simulator (copied from
``repro.simulate.scenarios``).

A Scenario is a NetworkConditions factory plus provenance: some conditions
(partition windows) depend on the run length, so ``make_conditions(rounds)``
resolves them per run.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List

from .scheduler import NetworkConditions


@dataclasses.dataclass(frozen=True)
class Scenario:
    """A named fault profile: rounds -> NetworkConditions factory."""

    name: str
    description: str
    make_conditions: Callable[[int], NetworkConditions]


def _clean(rounds: int) -> NetworkConditions:
    return NetworkConditions()


def _lossy10(rounds: int) -> NetworkConditions:
    return NetworkConditions(drop_prob=0.10, stale_prob=0.05)


def _straggler_tail(rounds: int) -> NetworkConditions:
    return NetworkConditions(straggler_frac=0.2, straggler_factor=0.05,
                             stale_prob=0.10)


def _churn5(rounds: int) -> NetworkConditions:
    # ~5% of agents toggling over a 100-round horizon
    return NetworkConditions(churn_rate=0.05 / 100.0)


def _partition_heal(rounds: int) -> NetworkConditions:
    return NetworkConditions(partition_start=rounds // 3,
                             partition_end=2 * rounds // 3)


SCENARIOS: Dict[str, Scenario] = {
    s.name: s for s in [
        Scenario("clean", "no faults — pure asynchronous gossip", _clean),
        Scenario("lossy-10", "10% iid message loss + 5% stale deliveries",
                 _lossy10),
        Scenario("straggler-tail",
                 "20% of agents wake at 1/20 the base rate, 10% staleness",
                 _straggler_tail),
        Scenario("churn-5", "agents join/leave (~5% churn per 100 rounds)",
                 _churn5),
        Scenario("partition-heal",
                 "network splits in half for the middle third, then heals",
                 _partition_heal),
    ]
}


def get_scenario(name: str) -> Scenario:
    """Look up a scenario by name (KeyError lists the registry)."""
    try:
        return SCENARIOS[name]
    except KeyError:
        raise KeyError(f"unknown scenario {name!r}; "
                       f"available: {sorted(SCENARIOS)}") from None


def list_scenarios() -> List[str]:
    """Sorted names of the registered fault scenarios."""
    return sorted(SCENARIOS)
