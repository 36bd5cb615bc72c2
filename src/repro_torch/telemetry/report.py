"""Turn traces into JSONL runs and render them back as text (counterpart
of ``repro.telemetry.report``).

The on-disk layout of a recorded run is one directory with two files:

    manifest.json   — what produced the run (:mod:`repro.telemetry.manifest`)
    metrics.jsonl   — one JSON object per record chunk
                      (:meth:`TelemetryFrames.summarize` rows)

``write_run``/``load_run`` are the only code that touches that layout,
which is the JAX package's: a run written by either package loads in the
other.  ``render_summary`` renders a run of either.
"""

from __future__ import annotations

import json
import os
from typing import Optional


def trace_rows(trace) -> list:
    """JSONL-ready rows for any engine trace (Sim/CLSim/JointSimTrace).

    With telemetry enabled the rows are the frames'
    :meth:`~repro.telemetry.frames.TelemetryFrames.summarize` output; a
    telemetry-less trace still yields one terminal row from the trace's
    own accounting counters, so report paths work on any run.
    """
    frames = getattr(trace, "telemetry", None)
    if frames is not None:
        return frames.summarize()
    row = {
        "round": int(trace.rounds),
        "delivered": int(trace.delivered),
        "dropped": int(trace.dropped),
        "invalid": int(trace.invalid),
        "events": int(trace.events),
    }
    suppressed = getattr(trace, "suppressed", None)
    if suppressed is not None:
        row["suppressed"] = int(suppressed)
    return [row]


def format_row(row: dict) -> str:
    """One fixed-width text line for a metrics row."""
    parts = [f"round {row['round']:>6d}"]
    if "objective" in row:
        parts.append(f"obj {row['objective']:.6e}")
    if "staleness_p50" in row:
        parts.append(f"stale p50/p99 {row['staleness_p50']:.0f}/"
                     f"{row['staleness_p99']:.0f}")
    if "delivered" in row:
        parts.append(f"delivered {row['delivered']}")
    drops = [row.get(k, 0) for k in
             ("drop_link", "drop_churn", "drop_partition")]
    if any(k in row for k in
           ("drop_link", "drop_churn", "drop_partition")):
        parts.append("drops l/c/p {}/{}/{}".format(*drops))
    elif "dropped" in row:
        parts.append(f"dropped {row['dropped']}")
    if "halo_bytes" in row:
        parts.append(f"halo {row['halo_bytes']}B")
    if "suppressed" in row:
        parts.append(f"suppressed {row['suppressed']}")
    return "  ".join(parts)


def render_summary(manifest: Optional[dict], rows: list) -> str:
    """Multi-line text report of a run: manifest header + metric lines.

    Long runs are elided to the first/last few record chunks; the final
    row additionally gets a convergence/staleness recap so a glance shows
    where the run ended up.
    """
    lines = []
    if manifest:
        mesh = manifest.get("mesh_shape")
        if "torch_version" in manifest:
            lib = "torch={} cuda={} device={}".format(
                manifest.get("torch_version"), manifest.get("cuda_version"),
                manifest.get("device_name"))
        else:
            lib = "jax={}".format(manifest.get("jax_version"))
        lines.append("run: backend={} mesh={} seed={} rev={} {}".format(
            manifest.get("backend_hash"),
            "x".join(map(str, mesh)) if mesh else "single-device",
            manifest.get("seed"), manifest.get("git_rev"), lib))
    shown = rows if len(rows) <= 8 else rows[:3] + [None] + rows[-3:]
    for row in shown:
        lines.append("  ..." if row is None else "  " + format_row(row))
    if rows:
        last = rows[-1]
        total_drops = sum(last.get(k, 0) for k in
                          ("drop_link", "drop_churn", "drop_partition"))
        lines.append(
            "final: delivered={} dropped={} invalid={}".format(
                last.get("delivered"), total_drops or last.get("dropped"),
                last.get("invalid")))
        if "objective" in last and len(rows) > 1:
            first = rows[0]
            lines.append(
                "convergence: objective {:.6e} -> {:.6e}".format(
                    first["objective"], last["objective"]))
        if "staleness_max" in last:
            lines.append("staleness: p50={:.0f} p99={:.0f} max={}".format(
                last["staleness_p50"], last["staleness_p99"],
                last["staleness_max"]))
        if "overflow_per_shard" in last:
            lines.append("overflow_per_shard: {}".format(
                last["overflow_per_shard"]))
    return "\n".join(lines)


def write_run(run_dir: str, manifest: dict, rows: list) -> str:
    """Persist a run as ``<run_dir>/manifest.json`` + ``metrics.jsonl``."""
    os.makedirs(run_dir, exist_ok=True)
    with open(os.path.join(run_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2, sort_keys=True)
        f.write("\n")
    with open(os.path.join(run_dir, "metrics.jsonl"), "w") as f:
        for row in rows:
            f.write(json.dumps(row, sort_keys=True) + "\n")
    return run_dir


def load_run(run_dir: str) -> tuple:
    """Read back (manifest, rows) written by :func:`write_run`.

    A missing manifest yields ``(None, rows)`` so partial runs still
    render.
    """
    manifest_path = os.path.join(run_dir, "manifest.json")
    manifest = None
    if os.path.exists(manifest_path):
        with open(manifest_path) as f:
            manifest = json.load(f)
    rows = []
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    return manifest, rows
