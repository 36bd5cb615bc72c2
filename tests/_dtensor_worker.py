"""The body each rank of the DTensor tests' gloo process group runs
(tests/test_torch_dtensor.py).

Two ranks form a (1, 2) ("data", "model") mesh: one agent, its weights
tensor-parallel over "model" as the model's specs lay them out, in the
contexts the dry run steps in (``batch_axes(())``,
``implicit_replication()``, ``loss_parallel()`` for training).  Every
reduced family runs in float32, once on plain tensors and once on
``DTensor`` leaves of the same values, so that each DTensor-only form of
the model (the head split and merge, attention on each device's own
heads, the vocabulary-sharded embedding and loss, the whole-tensor cache
writes, ``-softplus(-x)``, the sequence-parallel gathers and scatters,
AdamW on laid-out gradients) is held against the plain one.  This module
imports torch and the port only, so the spawned processes start quickly.
"""

import copy
import dataclasses

import numpy as np
import torch

FAMILIES = ("llama3_8b", "olmoe_1b_7b", "xlstm_1_3b", "recurrentgemma_2b",
            "qwen2_vl_7b", "musicgen_medium")
WORLD = 2
S, B = 16, 2                  # positions (prefix included), sequences
CACHES = ((20, False), (8, True))   # (cache_len, ring) after a prefill
STEPS = 2                     # train steps (the first at warm-up lr 0)


def config(arch):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch, "reduced"),
                               compute_dtype=torch.float32)


def family_batch(cfg, seed):
    """The family's inputs for S positions in all (text tokens; a VLM's
    patches on a 2 x 4 grid and text after them; audio's conditioning and
    codes)."""
    rng = np.random.default_rng(seed)
    d, V = cfg.d_model, cfg.vocab_size
    if cfg.family == "audio":
        n = cfg.n_cond_tokens
        tok = rng.integers(0, V, (B, cfg.n_codebooks, S - n))
        out = {"tokens": tok, "labels": np.roll(tok, -1, axis=-1),
               "cond_embeds": rng.standard_normal((B, n, d))}
    elif cfg.family == "vlm":
        n = cfg.n_media_tokens
        tok = rng.integers(0, V, (B, S - n))
        p3 = np.zeros((3, B, S), np.int64)
        p3[1, :, :n] = np.arange(n) // 4
        p3[2, :, :n] = np.arange(n) % 4
        p3[:, :, n:] = np.arange(S - n) + 4
        out = {"tokens": tok, "labels": np.roll(tok, -1, axis=-1),
               "patch_embeds": rng.standard_normal((B, n, d)),
               "positions3": p3}
    else:
        tok = rng.integers(0, V, (B, S))
        out = {"tokens": tok, "labels": np.roll(tok, -1, axis=-1)}
    return {k: torch.as_tensor(v, dtype=torch.float32 if v.dtype.kind == "f"
                               else torch.int32) for k, v in out.items()}


def distribute(t, spec, mm):
    """``t`` laid out by ``spec`` on the 1-D "model" mesh ``mm``."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.models.common import adapt_spec, spec_placements
    spec = adapt_spec(spec, ("model",))
    return distribute_tensor(t, mm, spec_placements(spec, ("model",)))


def distribute_tree(tree, specs, mm, lead=0):
    if isinstance(tree, dict):
        return {k: distribute_tree(v, specs[k], mm, lead)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [distribute_tree(v, s, mm, lead) for v, s in zip(tree, specs)]
    return distribute(tree, (None,) * lead + tuple(specs), mm)


def whole(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def err(a, b) -> float:
    return (whole(a).float() - whole(b).float()).abs().max().item()


def dtensor_contexts(train):
    import contextlib

    from torch.distributed.tensor.experimental import implicit_replication
    from torch.distributed.tensor.parallel import loss_parallel

    from repro_torch.models.common import batch_axes
    stack = contextlib.ExitStack()
    stack.enter_context(batch_axes(()))
    stack.enter_context(implicit_replication())
    if train:
        stack.enter_context(loss_parallel())
    return stack


def loss_and_grads(model, params, batch):
    from repro_torch.tree import tree_flatten, tree_unflatten
    leaves, treedef = tree_flatten(params)
    mine = [leaf.detach().requires_grad_() for leaf in leaves]
    loss, _ = model.loss(tree_unflatten(treedef, mine), batch)
    return loss.detach(), torch.autograd.grad(loss, mine)


def train_step_state(model, params, mesh):
    """One agent's train state on ``params`` (agent-stacked (1, ...)) and
    its step: through ``launch.mesh.AgentMesh`` when ``mesh`` is given,
    the moments then laid out as the parameters (as the dry run builds
    them)."""
    from repro_torch.coupling import CouplingConfig
    from repro_torch.launch.dryrun import coupling_state
    from repro_torch.launch.mesh import AgentMesh
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train import TrainConfig, make_train_step
    from repro_torch.train.trainer import TrainState
    from repro_torch.tree import tree_map
    # float32 moments: the comparison is of the DTensor forms, not of
    # bfloat16 rounding
    tcfg = TrainConfig(n_agents=1, steps=10,
                       optimizer=AdamWConfig(moment_dtype=torch.float32),
                       coupling=CouplingConfig(mode="mp"))
    opt_state = adamw_init(params, tcfg.optimizer)
    if mesh is not None:
        for k in ("m", "v"):
            opt_state[k] = tree_map(torch.zeros_like, params)  # float32
    state = TrainState(params=params, opt_state=opt_state,
                       solitary=tree_map(torch.clone, params),
                       step=torch.zeros((), dtype=torch.int32))
    step = make_train_step(model, tcfg, coupling_state(1, 0.99, "cpu"),
                           mesh=AgentMesh(mesh) if mesh is not None else None)
    return state, step


def train_case(arch, mesh):
    """Loss and gradients, then STEPS whole train steps (AdamW, the
    anchor's EMA, the mp coupling over the agent axes), plain against
    DTensor."""
    from repro_torch.models import Model
    from repro_torch.tree import tree_leaves, tree_map
    cfg = config(arch)
    model = Model(cfg, device="meta")
    params = model.init_params(torch.Generator().manual_seed(0), device="cpu")
    batch = family_batch(cfg, 1)
    mm = mesh["model"]
    loss, grads = loss_and_grads(model, params, batch)
    dparams = distribute_tree(params, model.param_specs(), mm)
    with dtensor_contexts(train=True):
        dloss, dgrads = loss_and_grads(model, dparams, batch)
    out = {"loss": float(loss), "loss_err": err(dloss, loss),
           "grad_err": max(err(d, g) for d, g in zip(dgrads, grads)),
           "grad_max": max(g.abs().max().item() for g in grads),
           "grads_are_dtensors": all(hasattr(g, "full_tensor")
                                     for g in dgrads)}
    stacked = tree_map(lambda a: a[None].clone(), params)
    state, step = train_step_state(model, stacked, None)
    dstacked = distribute_tree(tree_map(lambda a: a[None].clone(), params),
                               model.param_specs(), mm, lead=1)
    dstate, dstep = train_step_state(model, dstacked, mesh)
    for _ in range(STEPS):
        state, metrics = step(state, batch)
        with dtensor_contexts(train=True):
            dstate, dmetrics = dstep(dstate, batch)
    out["step_param_moved"] = max(
        err(p[0], q) for p, q in zip(tree_leaves(state.params),
                                     tree_leaves(params)))
    out["step_param_err"] = max(
        err(d, p) for d, p in zip(tree_leaves(dstate.params),
                                  tree_leaves(state.params)))
    out["step_moment_err"] = max(
        err(d, p) for k in ("m", "v")
        for d, p in zip(tree_leaves(dstate.opt_state[k]),
                        tree_leaves(state.opt_state[k])))
    out["step_grad_norm_err"] = err(dmetrics["grad_norm"],
                                    metrics["grad_norm"])
    return out


def serve_case(arch, mesh):
    """Prefill and one decode step, into a long cache and a ring, with
    the module's weights plain against laid out by ``Model.specs()``."""
    from torch import nn

    from repro_torch.models import Model
    cfg = config(arch)
    model = Model(cfg, device="cpu", dtype=torch.float32).init(
        torch.Generator().manual_seed(0))
    dmodel = copy.deepcopy(model)
    mm = mesh["model"]
    for name, spec in dmodel.specs().items():
        owner, _, leaf = name.rpartition(".")
        mod = dmodel.get_submodule(owner) if owner else dmodel
        setattr(mod, leaf, nn.Parameter(distribute(getattr(mod, leaf), spec,
                                                   mm), requires_grad=False))
    batch = family_batch(cfg, 2)
    batch.pop("labels")
    rng = np.random.default_rng(3)
    shape = (B, cfg.n_codebooks) if cfg.family == "audio" else (B,)
    token = {"token": torch.as_tensor(rng.integers(0, cfg.vocab_size, shape),
                                      dtype=torch.int32)}
    out = {"prefill_err": 0.0, "decode_err": 0.0, "logit_max": 0.0,
           "caches_are_dtensors": True}
    for cache_len, ring in CACHES:
        logits, cache = model.prefill(batch, cache_len)
        step, _ = model.decode_step(cache, token, ring=ring)
        with dtensor_contexts(train=False):
            dlogits, dcache = dmodel.prefill(batch, cache_len)
            dstep, _ = dmodel.decode_step(dcache, token, ring=ring)
        attn = [c["k"] for c in dcache["layers"] if "k" in c]
        out["caches_are_dtensors"] &= all(hasattr(k, "full_tensor")
                                          for k in attn)
        out["prefill_err"] = max(out["prefill_err"], err(dlogits, logits))
        out["decode_err"] = max(out["decode_err"], err(dstep, step))
        out["logit_max"] = max(out["logit_max"], logits.abs().max().item(),
                               step.abs().max().item())
    return out


def rank_main(rank: int, world: int, port: int, out_dir: str):
    """One rank: join the gloo group, run every family, save."""
    import torch.distributed as dist

    torch.set_num_threads(1)       # as the parent (tests/_port_session.py)

    from repro_torch.launch.mesh import make_mesh
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        mesh = make_mesh((1, world), ("data", "model"), "cpu")
        out = {arch: {"train": train_case(arch, mesh),
                      "serve": serve_case(arch, mesh)}
               for arch in FAMILIES}
        torch.save(out, f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()
