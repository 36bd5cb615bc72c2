"""Run manifests: what produced a metrics file, hashed for comparison
(counterpart of ``repro.telemetry.manifest``).

A manifest pins everything needed to interpret (or re-run) a recorded
scenario: the kernel backend configuration and its hash, the device mesh
shape, the RNG seed, the git revision, and the library and device: the
torch and CUDA versions, the card's name and the CUDA device count, where
the JAX package records its jax version and device count.  It is a plain
JSON-able dict — ``report.write_run`` drops it next to the metrics JSONL,
in the JAX package's layout.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import platform
import subprocess
from typing import Optional

import torch


def _as_jsonable(obj):
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {k: _as_jsonable(v)
                for k, v in dataclasses.asdict(obj).items()}
    if isinstance(obj, dict):
        return {str(k): _as_jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_as_jsonable(v) for v in obj]
    return str(obj)


def backend_config_hash(backend) -> str:
    """Short stable hash of a kernel backend config (or any dataclass).

    Canonical JSON (sorted keys) -> sha256 -> first 12 hex chars; two runs
    share a hash iff their backend selections match field-for-field.
    """
    blob = json.dumps(_as_jsonable(backend), sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:12]


def _git_rev() -> Optional[str]:
    """The checkout's revision (read in the package's own repository)."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short=12", "HEAD"],
            capture_output=True, text=True, timeout=5,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        rev = out.stdout.strip()
        return rev if out.returncode == 0 and rev else None
    except (OSError, subprocess.SubprocessError):
        return None


def build_manifest(backend=None, mesh_shape=None, seed=None,
                   extra: Optional[dict] = None) -> dict:
    """Assemble the run manifest dict.

    backend: the kernel ReproBackend (or None for the defaults);
    mesh_shape: device-mesh shape tuple for sharded runs (None on one
    device); seed: the scenario RNG seed; extra: caller-specific fields
    (scenario name, conditions, sizes) merged in last.  ``device_name``
    is CUDA device 0's name (None without CUDA), ``device_count``
    the CUDA device count.
    """
    cuda = torch.cuda.is_available()
    manifest = {
        "backend_config": _as_jsonable(backend),
        "backend_hash": backend_config_hash(backend),
        "mesh_shape": list(mesh_shape) if mesh_shape is not None else None,
        "seed": seed,
        "git_rev": _git_rev(),
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "platform": platform.platform(),
        "device_name": torch.cuda.get_device_name(0) if cuda else None,
        "device_count": torch.cuda.device_count() if cuda else 0,
    }
    if extra:
        manifest.update(_as_jsonable(extra))
    return manifest
