"""Sharding spec assembly for the dry run and production launches
(counterpart of ``repro.launch.sharding``).

A spec is a tuple with one entry per dim (``models.common``).  The
model's specs are written against the multi-pod axes ("pod", "data",
"model"); the helpers here (a) prepend the agent axes for agent-stacked
trees, (b) null the batch/agent slot where a dim is per-agent instead,
and (c) drop the axes the mesh lacks.  :func:`placements` turns specs
into ``DTensor`` placements on a ``DeviceMesh`` (the JAX package's
``named``).
"""

from __future__ import annotations

from typing import Tuple

from repro_torch.models.common import (AGENT_SLOT, adapt_spec,
                                       resolve_agent_slot, spec_placements)


def agent_axes_of(mesh) -> Tuple[str, ...]:
    """The mesh's agent axes: ("pod", "data"), ("data",) or ()."""
    return tuple(a for a in AGENT_SLOT if a in mesh.mesh_dim_names)


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, (str, tuple)) for e in x)


def map_specs(fn, tree):
    """``fn`` over every spec of a tree of specs (dicts and lists)."""
    if isinstance(tree, dict):
        return {k: map_specs(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_specs(fn, v) for v in tree]
    if _is_spec(tree):
        return fn(tree)
    raise TypeError(f"not a spec tree: {tree!r}")


def resolve(spec, mesh, batch_to=None):
    """Adapt one base spec: the agent slot -> ``batch_to`` (or the mesh's
    agent axes), then drop the axes the mesh lacks."""
    agent = agent_axes_of(mesh) if batch_to is None else batch_to
    return adapt_spec(resolve_agent_slot(spec, agent),
                      tuple(mesh.mesh_dim_names))


def stacked_param_specs(model, mesh):
    """Agent-stacked parameters: the agent axes before every base leaf's
    spec."""
    agent = agent_axes_of(mesh)
    names = tuple(mesh.mesh_dim_names)
    return map_specs(lambda s: adapt_spec((agent,) + s, names),
                     model.param_specs())


def batch_specs(model, mesh, mode: str = "train"):
    """Global-batch input specs (the batch dim over the agent axes)."""
    return map_specs(lambda s: resolve(s, mesh), model.batch_specs(mode))


def stacked_cache_specs(model, mesh):
    """Per-agent caches stacked over agents: (A, reps, b, ...) leaves, the
    batch slot agent-local (None) and the new leading dim the agents'."""
    agent = agent_axes_of(mesh)
    names = tuple(mesh.mesh_dim_names)

    def f(s):
        return adapt_spec((agent,) + resolve(s, mesh, batch_to=()), names)

    base = model.cache_specs()
    return {"layers": map_specs(f, base["layers"]),
            "pos": adapt_spec((agent, None), names)}


def placements(tree, mesh):
    """Each spec of ``tree`` as its tuple of ``DTensor`` placements on
    ``mesh``: ``Shard(d)`` on every mesh dim an entry of dim d names (a
    dim over ("pod", "data") is ``Shard(d)`` on both), ``Replicate()``
    on the others."""
    names = tuple(mesh.mesh_dim_names)
    return map_specs(lambda s: spec_placements(adapt_spec(s, names), names),
                     tree)


def local_shape(shape, spec, mesh) -> Tuple[int, ...]:
    """The per-device shape of a ``shape`` leaf laid out by ``spec``: each
    dim divided by the product of its axes' sizes."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    out = []
    for n, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        names = entry if isinstance(entry, tuple) else (entry,)
        div = 1
        for a in names:
            div *= sizes.get(a, 1) if a is not None else 1
        out.append(-(-n // div))
    return tuple(out)

