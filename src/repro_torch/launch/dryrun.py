"""Multi-pod dry run on H100 constants (counterpart of
``repro.launch.dryrun``).

For an (architecture x input shape x mesh): set up ``torch.distributed``
on torch's ``fake`` backend with the mesh's world size (one process
standing for every rank; nothing is communicated), build the port's own
step for one device of the production mesh, run it once on ``meta``
tensors (nothing is allocated), and record what that device holds,
computes, moves and communicates.  Run each combination in its own
process, as the JAX package sets ``XLA_FLAGS`` first:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b \\
        --shape train_4k [--multi-pod] [--schedule gossip] [--out FILE]

The per-device program is what the JAX package's
``vmap(spmd_axis_name=agent)`` and ``shard_map`` give: each device holds
one agent, whose leaves are ``DTensor``s on the mesh's "model" sub-mesh
laid out by the model's specs (``DTensor.from_local`` over ``meta``
locals).  The coupling crosses the agent axes: ``schedule="dense"`` an
all-gather of the agents' local shards, ``schedule="gossip"`` one
point-to-point exchange a matching (``launch.mesh.AgentMesh``).

* train: ``train.make_train_step`` for the device's agent —
  ``Model.loss``, autograd, ``optim.adamw_update_``, the anchor's EMA and
  the coupling — under ``loss_parallel`` (the vocabulary-sharded loss);
* prefill / decode: ``Model.prefill`` and ``Model.decode_step`` with the
  module's weights distributed by :meth:`Model.specs` (the cache by its
  specs, the agent slot agent-local).

A recorder (a ``TorchDispatchMode`` below ``DTensor``, so it sees each
device-local op) gives, per device:

* ``argument_size_in_bytes``: exact, from the local shapes;
* ``peak_size_in_bytes`` and ``temp_size_in_bytes``: the arguments plus
  the most bytes of storages the step held live at once (each storage
  counted from its first op to its release);
* ``cost_flops``: ``torch.utils.flop_counter``'s formulas on the local
  shards, matmul-class ops only (elementwise FLOPs are not counted);
* ``cost_bytes``: the sum of every dispatched op's input and output bytes
  (views excluded), what an eager program moves;
* collectives by kind and by mesh axis, and the roofline
  (``launch.cost``).

The ops run on ``meta`` tensors, so ``kernels.dispatch`` resolves each op
to its plain version (the JAX package's cost variants take
``attn_impl="ref"`` the same way): every record says ``"traced_with":
"plain versions"`` and carries no kernel time.  The JAX package's depth
extrapolation, sLSTM correction and HLO parsing are XLA workarounds and
have no counterpart: the layers and time steps run as Python loops, and
the recorder sees every one.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
import weakref

import numpy as np
import torch

from repro_torch.configs import ALIASES, get_config
from repro_torch.launch import cost as hc
from repro_torch.launch.mesh import (AgentMesh, agent_group, make_mesh,
                                     make_production_mesh, n_agents_of)
from repro_torch.launch.shapes import SHAPES, InputShape, plan_decode
from repro_torch.launch.sharding import local_shape, resolve
from repro_torch.models.common import adapt_spec, batch_axes, \
    spec_placements

TRACED_WITH = "plain versions"
FLOPS_COUNTED = "matmul-class ops (torch.utils.flop_counter formulas)"

# dispatched collectives -> the JAX package's collective kinds
_FUNCOL = {"all_gather_into_tensor": "all-gather",
           "all_reduce": "all-reduce",
           "reduce_scatter_tensor": "reduce-scatter",
           "all_to_all_single": "all-to-all"}


# ---------------------------------------------------------------------------
# The fake process group
# ---------------------------------------------------------------------------


def init_fake(world_size: int) -> None:
    """Initialise ``torch.distributed`` on the ``fake`` backend at rank 0
    of ``world_size`` (re-initialising a group of another size).  Raises
    when this torch has no fake process group."""
    import torch.distributed as dist
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(
            "the dry run needs torch's fake process group "
            "(torch.testing._internal.distributed.fake_pg), which this "
            "torch does not have") from e
    if dist.is_initialized():
        if dist.get_backend() == "fake" \
                and dist.get_world_size() == world_size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def production_mesh(multi_pod: bool, shape=None):
    """The production mesh (or a (data, model) mesh of ``shape``) on a
    fake process group of its size."""
    if shape is not None:
        init_fake(int(np.prod(shape)))
        return make_mesh(shape, ("data", "model"), "cpu")
    init_fake(512 if multi_pod else 256)
    return make_production_mesh(multi_pod=multi_pod, device_type="cpu")


# ---------------------------------------------------------------------------
# The recorder
# ---------------------------------------------------------------------------


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _storage_key(t):
    return t.untyped_storage()._cdata


class StepRecorder:
    """Records a step's device-local ops: matmul FLOPs, bytes moved, live
    storage bytes and collectives.  ``axes`` maps process groups' ranks to
    mesh-axis labels (a mesh equal to an earlier one may run on the
    earlier one's groups); ``known`` are the argument tensors (their
    storages are not counted as the step's)."""

    def __init__(self, axes: dict, known=()):
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils.flop_counter import flop_registry
        rec = self
        self.axes = axes
        self.flops = 0
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self.collectives = []            # (kind, result bytes, axis)
        self._live = {}
        self._known = {_storage_key(t): t.untyped_storage()
                       for t in known if t.device.type == "meta"}

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                if isinstance(func, torch._ops.HigherOrderOperator):
                    return func(*args, **kwargs)
                names = {getattr(t, "__name__", "") for t in types}
                if "DTensor" in names:
                    return NotImplemented
                out = func(*args, **kwargs)
                if "FakeTensor" in names:
                    # DTensor's sharding propagation runs ops on global
                    # fake shapes: not the device's work
                    return out
                rec._op(func, args, kwargs, out, flop_registry)
                return out

        self.mode = Mode()

    def __enter__(self):
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self.mode.__exit__(*exc)

    def _free(self, key, n):
        self._live.pop(key, None)
        self.live -= n

    def _track(self, t):
        key = _storage_key(t)
        if key in self._known or key in self._live:
            return
        st = t.untyped_storage()
        n = st.nbytes()
        self._live[key] = weakref.ref(  # scatter: dict entry
            st, lambda _, key=key, n=n: self._free(key, n))
        self.live += n
        self.peak = max(self.peak, self.live)

    def _op(self, func, args, kwargs, out, flop_registry):
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
        outs = list(_tensors(out))
        if not getattr(func, "is_view", False):
            self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs))) \
                + sum(_nbytes(t) for t in outs)
        for t in outs:
            self._track(t)
        ns, name = func.namespace, packet.__name__
        if ns == "_c10d_functional" and name in _FUNCOL:
            group = [a for a in args if isinstance(a, str)][-1]
            self.collectives.append((_FUNCOL[name],
                                     float(sum(map(_nbytes, outs))),
                                     self._axis(group)))
        elif ns == "repro_torch" and name == "exchange":
            self.collectives.append(("collective-permute",
                                     float(sum(map(_nbytes, outs))),
                                     self._axis(args[1])))

    def _axis(self, group_name: str) -> str:
        ranks = _group_ranks(group_name)
        return self.axes.get(ranks, f"ranks {list(ranks)}")

    def stats(self):
        return hc.collective_stats((k, b) for k, b, _ in self.collectives)

    def by_axis(self):
        out = {}
        for kind, _, axis in self.collectives:
            row = out.setdefault(axis, {})
            row[kind] = row.get(kind, 0) + 1  # scatter: dict counter
        return out


def axis_labels(mesh) -> dict:
    """A process group's ranks -> the mesh-axis label of the group ("model",
    "data", "pod", or "agents" for the agent axes together)."""
    import torch.distributed as dist

    def ranks(group):
        return tuple(dist.get_process_group_ranks(group))
    labels = {ranks(agent_group(mesh)): "agents"}
    for a in mesh.mesh_dim_names:
        # "data" (and "pod") lie inside the agents; a one-device "model"
        # axis shares the agents' one rank
        r = ranks(mesh.get_group(a))
        if a == "model" or r not in labels:
            labels[r] = a  # scatter: dict entry
    return labels


def _group_ranks(name: str):
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    return tuple(dist.get_process_group_ranks(_resolve_process_group(name)))


# ---------------------------------------------------------------------------
# Distributed meta state
# ---------------------------------------------------------------------------


def dtensor(shape, spec, mesh, dtype):
    """A ``DTensor`` of global ``shape`` laid out by ``spec`` on the 1-D
    "model" sub-mesh of ``mesh``, its local shard a ``meta`` tensor."""
    from torch.distributed.tensor import DTensor
    mm = mesh["model"]
    spec = adapt_spec(spec, ("model",))
    loc = torch.empty(local_shape(shape, spec, mesh), dtype=dtype,
                      device="meta")
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(loc, mm, spec_placements(spec, ("model",)),
                              run_check=False, shape=torch.Size(shape),
                              stride=stride)


def _tree_dtensors(abstract, specs, mesh, dtype, lead=()):
    """``DTensor``s shaped like the ``abstract`` tree's leaves (with
    ``lead`` dims in front, unsharded), laid out by the matching specs."""
    if isinstance(abstract, dict):
        return {k: _tree_dtensors(v, specs[k], mesh, dtype, lead)
                for k, v in abstract.items()}
    if isinstance(abstract, list):
        return [_tree_dtensors(v, s, mesh, dtype, lead)
                for v, s in zip(abstract, specs)]
    return dtensor(lead + tuple(abstract.shape),
                   (None,) * len(lead) + tuple(specs), mesh,
                   dtype or abstract.dtype)


def _local_bytes(tree) -> int:
    total = 0
    for t in _tensors(tree):
        total += _nbytes(t.to_local() if hasattr(t, "to_local") else t)
    return total


def _locals(tree):
    return [t.to_local() if hasattr(t, "to_local") else t
            for t in _tensors(tree)]


def coupling_state(n_agents: int, alpha: float, device="meta"):
    """The agents' mixing operators on ``device``: the JAX dry run's
    ``random_geometric_graph(A, k=3, seed=0)`` with confidences
    ``linspace(0.3, 1, A)``, a ring under four agents; one agent alone
    has no neighbour (its mix is its anchor)."""
    from repro_torch.core.graph import random_geometric_graph, ring_graph
    from repro_torch.coupling import CouplingState, make_state
    if n_agents == 1:
        z = torch.zeros((1, 1), device=device)
        return CouplingState(A_mix=z, b_anchor=torch.ones(1, device=device),
                             W=z)
    graph = ring_graph(n_agents) if n_agents < 4 \
        else random_geometric_graph(n_agents, k=3, seed=0)
    return make_state(graph, np.linspace(0.3, 1.0, n_agents), alpha,
                      device=device)


def active_param_count(cfg, model) -> int:
    total = model.param_count()
    if not cfg.n_experts:
        return total
    expert_extra = 3 * cfg.d_model * cfg.d_ff * (cfg.n_experts - cfg.top_k)
    return total - expert_extra * cfg.n_layers


# ---------------------------------------------------------------------------
# The per-device steps
# ---------------------------------------------------------------------------


def build_train(cfg, shape: InputShape, mesh, schedule: str, coupling: str,
                every: int = 1, mix_dtype=torch.float32):
    """Returns ``(run, args, model)``: ``run()`` is one training step of
    this device's agent (a per-agent batch of ``global_batch / A``)."""
    from repro_torch.coupling import CouplingConfig
    from repro_torch.models import Model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig, make_train_step
    from repro_torch.train.trainer import TrainState
    model = Model(cfg, device="meta")
    A = n_agents_of(mesh)
    b = shape.global_batch // A
    assert b >= 1, (shape.name, A)
    ccfg = CouplingConfig(mode=coupling, schedule=schedule, every=every,
                          mix_dtype=mix_dtype)
    opt = AdamWConfig()
    cstate = coupling_state(A, ccfg.alpha)
    # one agent a device: the step's agent axis is this device's agent
    step = make_train_step(model, TrainConfig(n_agents=1, steps=10_000,
                                              optimizer=opt, coupling=ccfg),
                           cstate, mesh=AgentMesh(mesh))
    abstract, specs = model.abstract_params(), model.param_specs()
    params = _tree_dtensors(abstract, specs, mesh, None, lead=(1,))
    state = TrainState(
        params=params,
        opt_state={"m": _tree_dtensors(abstract, specs, mesh,
                                       opt.moment_dtype, lead=(1,)),
                   "v": _tree_dtensors(abstract, specs, mesh,
                                       opt.moment_dtype, lead=(1,)),
                   "count": torch.zeros((), dtype=torch.int32,
                                        device="meta")},
        solitary=_tree_dtensors(abstract, specs, mesh, None, lead=(1,)),
        step=torch.zeros((), dtype=torch.int32))
    batch = model.input_specs(b, shape.seq_len, "train")

    def run():
        from torch.distributed.tensor.parallel import loss_parallel
        with loss_parallel():
            return step(state, batch)
    return run, (state.params, state.opt_state, state.solitary, state.step,
                 batch), model


def _distributed_module(cfg, mesh, dtype):
    """``Model(cfg)`` on ``meta`` with every weight replaced by a
    ``DTensor`` laid out by its spec."""
    from torch import nn

    from repro_torch.models import Model
    model = Model(cfg, device="meta", dtype=dtype)
    for name, spec in model.specs().items():
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner) if owner else model
        p = getattr(mod, leaf)
        setattr(mod, leaf, nn.Parameter(
            dtensor(tuple(p.shape), spec, mesh, dtype), requires_grad=False))
    return model


def build_prefill(cfg, shape: InputShape, mesh, dtype=None):
    """``Model.prefill`` of this device's agent on ``global_batch / A``
    sequences, the cache as long as a decode of the shape would keep."""
    A = n_agents_of(mesh)
    b = shape.global_batch // A
    assert b >= 1, (shape.name, A)
    plan = plan_decode(cfg, InputShape(shape.name, shape.seq_len,
                                       shape.global_batch, "decode"))
    model = _distributed_module(cfg, mesh, dtype or cfg.compute_dtype)
    batch = model.input_specs(b, shape.seq_len, "prefill")
    batch.pop("labels")

    def run():
        return model.prefill(batch, cache_len=plan.cache_len)
    return run, (list(model.parameters()), batch), model


def build_decode(cfg, shape: InputShape, mesh, lockstep: bool = False,
                 dtype=None):
    """One ``Model.decode_step`` of this device's agent: each agent serves
    its own model on ``global_batch / A`` requests; when the global batch
    is below the agent count (long_500k) one model serves it with the
    agent axes idle, the same per-device program at b = global_batch."""
    from repro_torch.models.blocks import block_cache_specs
    A = n_agents_of(mesh)
    plan = plan_decode(cfg, shape)
    b = shape.global_batch // A if shape.global_batch >= A \
        else shape.global_batch
    model = _distributed_module(cfg, mesh, dtype or cfg.compute_dtype)
    spec = model.input_specs(b, plan.cache_len, "decode",
                             cache_len=plan.cache_len)
    layers = []
    for kind, entry in zip(cfg.layer_kinds, spec["cache"]["layers"]):
        cs = block_cache_specs(cfg, kind)
        layers.append({k: dtensor(tuple(v.shape),
                                  resolve(cs[k], mesh, batch_to=()), mesh,
                                  v.dtype) for k, v in entry.items()})
    cache = {"layers": layers, "pos": spec["cache"]["pos"]}
    batch = spec["batch"]

    def run():
        return model.decode_step(cache, batch, window=plan.window,
                                 ring=plan.ring, lockstep=lockstep)
    return run, (list(model.parameters()), cache, batch), model


# ---------------------------------------------------------------------------
# One record
# ---------------------------------------------------------------------------


def measure(run, args, mesh) -> dict:
    """Run ``run()`` once under the recorder (per-agent activation
    constraints, plain tensors taken as replicated) and return the
    per-device record fields."""
    from torch.distributed.tensor.experimental import implicit_replication
    arg_bytes = _local_bytes(args)
    rec = StepRecorder(axis_labels(mesh), known=_locals(args))
    t0 = time.time()
    with batch_axes(()), implicit_replication(), rec:
        out = run()
    trace_s = time.time() - t0
    del out
    out_fields = {
        "argument_size_in_bytes": arg_bytes,
        "temp_size_in_bytes": rec.peak,
        "peak_size_in_bytes": arg_bytes + rec.peak,
        "cost_flops": float(rec.flops),
        "cost_bytes": float(rec.bytes),
        "collectives": rec.stats(),
        "collectives_by_axis": rec.by_axis(),
        "trace_s": round(trace_s, 2),
    }
    return out_fields


def run_one(arch: str, shape_name: str, multi_pod: bool, schedule: str,
            coupling: str, attn_impl: str = "", every: int = 1,
            mix_dtype: str = "f32", serve_dtype: str = "bf16",
            seq_shard: bool = True, lockstep: bool = False,
            moe_impl: str = "scatter", kv_shard: str = "seq",
            tag: str = "", mesh_shape=None, n_layers=None, seq_len=None,
            global_batch=None) -> dict:
    """One dry-run record.  ``mesh_shape`` (a (data, model) pair),
    ``n_layers``, ``seq_len`` and ``global_batch`` cut the production
    mesh, the depth and the shape."""
    cfg = get_config(arch, "full")
    overrides = {}
    if attn_impl:
        overrides["attn_impl"] = attn_impl
    if not seq_shard:
        overrides["seq_shard"] = False
    if moe_impl != "scatter":
        overrides["moe_impl"] = moe_impl
    if kv_shard != "seq":
        overrides["kv_shard"] = kv_shard
    if n_layers:
        overrides["n_layers"] = n_layers
        if cfg.pattern:
            overrides["pattern"] = cfg.pattern[:n_layers]
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = SHAPES[shape_name]
    if seq_len or global_batch:
        shape = dataclasses.replace(shape, seq_len=seq_len or shape.seq_len,
                                    global_batch=global_batch
                                    or shape.global_batch)
    mesh = production_mesh(multi_pod, mesh_shape)
    n_dev = int(np.prod(tuple(mesh.mesh.shape)))
    rec = {"arch": cfg.name, "shape": shape_name, "mode": shape.mode,
           "multi_pod": multi_pod, "schedule": schedule, "coupling": coupling,
           "tag": tag, "mesh": "x".join(map(str, mesh.mesh.shape)),
           "n_devices": n_dev, "n_layers": cfg.n_layers,
           "seq_len": shape.seq_len, "global_batch": shape.global_batch,
           "traced_with": TRACED_WITH, "flops_counted": FLOPS_COUNTED,
           "backend": "fake", "hardware": "H100 SXM (launch.cost)"}
    mixd = torch.bfloat16 if mix_dtype == "bf16" else torch.float32
    sdt = torch.bfloat16 if serve_dtype == "bf16" else torch.float32
    t0 = time.time()
    if shape.mode == "train":
        run, args, model = build_train(cfg, shape, mesh, schedule, coupling,
                                       every=every, mix_dtype=mixd)
        tokens = shape.global_batch * shape.seq_len
        mf = hc.model_flops_train
    elif shape.mode == "prefill":
        run, args, model = build_prefill(cfg, shape, mesh, dtype=sdt)
        tokens = shape.global_batch * shape.seq_len
        mf = hc.model_flops_decode
    else:
        run, args, model = build_decode(cfg, shape, mesh, lockstep=lockstep,
                                        dtype=sdt)
        tokens = shape.global_batch
        mf = hc.model_flops_decode
    if shape.mode != "train":
        rec["serve_weights_dtype"] = serve_dtype
    rec["build_s"] = round(time.time() - t0, 2)
    rec["param_count"] = model.param_count()
    rec["active_params"] = active_param_count(cfg, model)
    rec.update(measure(run, args, mesh))
    A = n_agents_of(mesh)
    score_est = hc.score_traffic_estimate(cfg, shape, A,
                                          tp=dict(zip(mesh.mesh_dim_names,
                                                      mesh.mesh.shape))
                                          ["model"])
    rec["cost_bytes_flash"] = max(rec["cost_bytes"] - score_est, 0.0)
    roof = hc.roofline_terms({"flops": rec["cost_flops"],
                              "bytes accessed": rec["cost_bytes_flash"]},
                             rec["collectives"], n_dev)
    rec["roofline"] = roof.as_dict()
    rec["model_flops"] = mf(rec["param_count"], tokens, rec["active_params"])
    # cost_flops is per device; model_flops is the whole program's
    total = rec["cost_flops"] * n_dev
    rec["useful_flop_ratio"] = rec["model_flops"] / total if total else 0.0
    rec["ok"] = True
    return rec


def _mesh_arg(text):
    if not text:
        return None
    return tuple(int(x) for x in text.lower().split("x"))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--schedule", default="dense",
                    choices=["dense", "gossip"])
    ap.add_argument("--coupling", default="mp",
                    choices=["none", "consensus", "mp", "cl"])
    ap.add_argument("--attn", default="", help="override attn_impl")
    ap.add_argument("--every", type=int, default=1,
                    help="apply coupling every k steps (the recorded step "
                         "is one that couples)")
    ap.add_argument("--mix-dtype", default="f32", choices=["f32", "bf16"],
                    help="wire dtype of the coupling")
    ap.add_argument("--serve-dtype", default="bf16",
                    choices=["f32", "bf16"],
                    help="serving weights' dtype (the port's serving model "
                         "computes in its weights' dtype)")
    ap.add_argument("--lockstep", action="store_true",
                    help="fleet decode at a shared position")
    ap.add_argument("--moe-impl", default="scatter",
                    choices=["scatter", "gather"])
    ap.add_argument("--kv-shard", default="seq", choices=["seq", "heads"])
    ap.add_argument("--no-seq-shard", action="store_true")
    ap.add_argument("--mesh", default="",
                    help="a (data x model) mesh in place of the production "
                         "one, e.g. 4x2")
    ap.add_argument("--layers", type=int, default=0, help="cut the depth")
    ap.add_argument("--seq", type=int, default=0, help="override seq_len")
    ap.add_argument("--batch", type=int, default=0,
                    help="override global_batch")
    ap.add_argument("--tag", default="", help="record tag")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    archs = sorted(set(ALIASES.values())) if args.arch == "all" \
        else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    records = []
    for arch in archs:
        for shape in shapes:
            tag = f"{arch} x {shape} ({'2pod' if args.multi_pod else '1pod'})"
            print(f"=== DRYRUN {tag} ===", flush=True)
            t0 = time.time()
            try:
                rec = run_one(arch, shape, args.multi_pod, args.schedule,
                              args.coupling, args.attn, every=args.every,
                              mix_dtype=args.mix_dtype,
                              serve_dtype=args.serve_dtype,
                              seq_shard=not args.no_seq_shard,
                              lockstep=args.lockstep, moe_impl=args.moe_impl,
                              kv_shard=args.kv_shard, tag=args.tag,
                              mesh_shape=_mesh_arg(args.mesh),
                              n_layers=args.layers or None,
                              seq_len=args.seq or None,
                              global_batch=args.batch or None)
            except Exception as e:
                traceback.print_exc()
                rec = {"arch": arch, "shape": shape,
                       "multi_pod": args.multi_pod, "ok": False,
                       "error": f"{type(e).__name__}: {e}"}
            rec["wall_s"] = round(time.time() - t0, 2)
            records.append(rec)
            print(json.dumps(rec, indent=1), flush=True)
            if args.out:
                existing = []
                if os.path.exists(args.out):
                    with open(args.out) as f:
                        existing = json.load(f)

                def keyf(r):
                    return (r.get("arch"), r.get("shape"),
                            r.get("multi_pod"), r.get("schedule"),
                            r.get("coupling"), r.get("tag", ""))
                existing = [r for r in existing if keyf(r) != keyf(rec)]
                existing.append(rec)
                with open(args.out, "w") as f:
                    json.dump(existing, f, indent=1)
    bad = [r for r in records if not r.get("ok")]
    print(f"done: {len(records) - len(bad)} ok, {len(bad)} failed")
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
