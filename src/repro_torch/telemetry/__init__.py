"""Run telemetry for the scenario engines (counterpart of
``repro.telemetry``; DESIGN.md §14).

The metrics the paper's convergence story needs: per-record-chunk
objective residuals (Eq. 3 / Eq. 7 local views), per-agent staleness
counters, drop attribution by ``NetworkConditions`` cause, and run
manifests with JSONL emission in the JAX package's layout.

The engines keep the per-round counters on the device and copy the
chunks' (n,) vectors to the host once, at the end of the run; no round
synchronises with the host.  Global reductions happen on the host in
canonical agent order (``frames``).  With ``TelemetryConfig(enabled=
False)`` (or ``telemetry=None``) the engines run exactly the operations
they run without telemetry; with it on they only observe, so the
trajectory is bit-identical.
"""

from .config import TelemetryConfig, telemetry_on
from .frames import TelemetryFrames
from .manifest import backend_config_hash, build_manifest
from .metrics import (batch_drop_causes, cl_local_objective,
                      cl_local_objective_from_loss, mp_local_objective,
                      staleness_step, stream_chunk_totals,
                      stream_dirty_chunks, stream_drop_causes,
                      stream_staleness_chunks)
from .report import (format_row, load_run, render_summary, trace_rows,
                     write_run)

__all__ = [n for n in dir() if not n.startswith("_")]
