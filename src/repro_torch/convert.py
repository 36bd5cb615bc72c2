"""Carry the JAX reference's state across to the port.

Each function takes the JAX side's arrays (anything ``np.asarray`` reads:
numpy arrays, or JAX arrays, which convert to numpy) and returns the
port's tensors on a given device (CUDA when None).  Objects are read by
field name only, so this module imports nothing of ``repro``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.sparse import DeviceTables, to_device
from repro_torch.simulate.scheduler import EventStream


def tables_from_arrays(tables, device=None) -> DeviceTables:
    """Neighbor tables (an object with ``nbr_idx``, ``rev_slot``,
    ``deg_count``, ``nbr_w``, ``nbr_p``, ``slot_cdf`` and ``deg_w``, e.g.
    the JAX package's NeighborTables or DeviceTables) as DeviceTables."""
    host = DeviceTables(*(np.array(getattr(tables, f))
                          for f in DeviceTables._fields))
    return to_device(host, device)


def stream_from_arrays(stream, device=None) -> EventStream:
    """An event stream (an object with EventStream's fields, each
    ``(rounds, B)`` or ``(rounds,)``) as an EventStream: index fields
    int32, flags bool, ``active_frac`` float32."""
    device = resolve_device(device)
    cols = []
    for f in EventStream._fields:
        a = np.asarray(getattr(stream, f))
        if f in ("i", "s", "j", "r"):
            a = a.astype(np.int32)
        elif f == "active_frac":
            a = a.astype(np.float32)
        else:
            a = a.astype(bool)
        cols.append(torch.as_tensor(a, device=device))
    return EventStream(*cols)


def models_from_arrays(theta_sol, c, device=None):
    """Solitary models ``theta_sol`` (n, p) and confidences ``c`` (n,) as
    float32 tensors."""
    device = resolve_device(device)
    theta_sol = np.array(theta_sol, dtype=np.float32)      # owned, writable
    c = np.array(c, dtype=np.float32)
    return (torch.as_tensor(theta_sol.reshape(len(theta_sol), -1),
                            device=device),
            torch.as_tensor(c, device=device))
