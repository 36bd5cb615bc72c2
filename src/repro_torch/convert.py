"""Carry the JAX reference's state across to the port.

Each function takes the JAX side's arrays (anything ``np.asarray`` reads:
numpy arrays, or JAX arrays, which convert to numpy) and returns the
port's tensors on a given device (CUDA when None): the simulator's tables,
streams, models and states, agents' flat parameter rows, an LM's
parameter tree, and an LM training state.  Objects are read by
field name only, so this module imports nothing of ``repro``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.collaborative import ADMMState
from repro_torch.core.losses import AgentData
from repro_torch.core.sparse import DeviceTables, to_device
from repro_torch.simulate.engines import SparseADMMState
from repro_torch.simulate.scheduler import EventStream
from repro_torch.tree import tree_leaves, tree_map


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


def _f32(a, device):
    return torch.as_tensor(np.array(a, dtype=np.float32), device=device)


def data_from_arrays(data, device=None) -> AgentData:
    """Padded agent datasets (an object with ``x``, ``y`` and ``mask``,
    e.g. the JAX package's AgentData) as an AgentData of float32 tensors."""
    device = resolve_device(device)
    return AgentData(*(_f32(getattr(data, f), device)
                       for f in ("x", "y", "mask")))


def admm_state_from_arrays(state, device=None):
    """ADMM state as the port's: a sparse one (fields ``theta``, ``K``,
    ``Z_own``, ``Z_nbr``, ``L_own``, ``L_nbr``, e.g. the JAX package's
    SparseADMMState) as a SparseADMMState, a dense one (``T`` instead of
    ``theta``/``K``, e.g. its ADMMState) as an ADMMState.  Every field is
    its own float32 tensor (the port's engines update them in place)."""
    device = resolve_device(device)
    cls = ADMMState if hasattr(state, "T") else SparseADMMState
    return cls(*(_f32(getattr(state, f.name), device)
                 for f in dataclasses.fields(cls)))


def agent_rows_from_arrays(params, device=None) -> torch.Tensor:
    """Agents' flat parameter rows as an (n, p) float32 tensor.

    ``params`` is an (n, p) array of rows (e.g. the JAX package's
    ``solitary_adamw`` output) or an agent-stacked parameter tree (dicts,
    tuples and lists of arrays with a leading agent axis, e.g. a
    ``jax.vmap`` of an agent's ``init``), flattened per agent with the
    leaves in ``jax.tree_util``'s order — the layout of
    ``models.flatten.ParamFlattener``.
    """
    device = resolve_device(device)
    leaves = [np.asarray(leaf, np.float32) for leaf in tree_leaves(params)]
    n = leaves[0].shape[0]
    return torch.as_tensor(np.concatenate([leaf.reshape(n, -1)
                                           for leaf in leaves], axis=1),
                           device=device)


def _flat(tree, prefix=""):
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, dict):
            yield from _flat(val, name + ".")
        else:
            yield name, val


def model_params_from_arrays(cfg, params, device=None, dtype=None):
    """The JAX package's model parameters (its ``Model.init`` tree, with
    each group's leaves stacked over repetitions) as a state dict of the
    port's ``Model(cfg)``: layer ``offset + r * len(unit) + i`` takes
    ``groups[g]["b{i}"][...][r]``, group after group (a pattern's tail
    group, as recurrentgemma's (rec, rec) after (rec, rec, attn) x 8,
    included).  Leaves keep their shapes: MoE expert stacks (E, d, f),
    sLSTM's ``r_*`` (H, hd, hd), audio's (K, V, d) embedding and
    (K, d, V) head.  Tensors in ``dtype`` (by default
    ``cfg.compute_dtype``), for ``Model.load_state_dict``."""
    device = resolve_device(device)
    dtype = dtype or cfg.compute_dtype

    def t(a):
        return torch.as_tensor(np.array(a, dtype=np.float32),
                               device=device).to(dtype)

    state = {name: t(params[name])
             for name in ("embed", "unembed", "final_norm")}
    layer = 0
    for (unit, reps), group in zip(cfg.scan_groups(), params["groups"]):
        for r in range(reps):
            for i in range(len(unit)):
                for name, leaf in _flat(group[f"b{i}"]):
                    state[f"layers.{layer}.{name}"] = t(np.asarray(leaf)[r])
                layer += 1
    return state


def tensor_from_array(a, device=None) -> torch.Tensor:
    """One array as a tensor of the same dtype on ``device`` (CUDA when
    None); bf16 (``ml_dtypes``' numpy type, as JAX arrays convert) is
    carried over by its bits."""
    device = resolve_device(device)
    arr = np.ascontiguousarray(np.asarray(a))
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr.copy()).to(device)


def train_state_from_arrays(state, device=None):
    """An LM training state (an object with ``params``, ``opt_state``,
    ``solitary`` and ``step``, e.g. the JAX package's TrainState, whose
    moments are bf16) as the port's ``train.TrainState``: every leaf its
    own tensor of the same dtype on ``device`` (the trainer updates them
    in place), ``step`` an int32 tensor on the CPU.  ``jax.random``
    initialisations cannot be replayed, so this is how a JAX state is
    carried across."""
    from repro_torch.train import TrainState
    device = resolve_device(device)

    def conv(tree):
        return tree_map(lambda a: tensor_from_array(a, device), tree)
    return TrainState(params=conv(state.params),
                      opt_state=conv(state.opt_state),
                      solitary=conv(state.solitary),
                      step=tensor_from_array(state.step, "cpu").to(
                          torch.int32))
