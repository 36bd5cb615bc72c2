"""Render a recorded telemetry run (manifest + metrics JSONL) as text,
with the PyTorch port alone (the counterpart of tools/trace_report.py).

A run directory is what ``repro_torch.telemetry.report.write_run`` (or the
JAX package's ``write_run``: the layout is shared) produces —
``manifest.json`` next to ``metrics.jsonl`` — e.g. from the port's
example demos' ``--out``.  One directory per positional argument:

    PYTHONPATH=src python tools/trace_report_torch.py <run_dir> [...]

Prints the manifest header (backend hash, mesh, seed, git rev), the
per-chunk convergence/staleness/drop-attribution lines (long runs elided
to head + tail), and the final-state recap.
"""

from __future__ import annotations

import argparse
import os
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(_REPO, "src"))

from repro_torch.telemetry.report import load_run, render_summary  # noqa: E402


def main(argv=None) -> int:
    """CLI entry point; returns a process exit code."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("run_dirs", nargs="+",
                    help="directories holding manifest.json + metrics.jsonl")
    args = ap.parse_args(argv)
    status = 0
    for d in args.run_dirs:
        try:
            manifest, rows = load_run(d)
        except OSError as e:
            print(f"{d}: not a run directory ({e})", file=sys.stderr)
            status = 1
            continue
        print(f"== {d} ==")
        print(render_summary(manifest, rows))
    return status


if __name__ == "__main__":
    raise SystemExit(main())
