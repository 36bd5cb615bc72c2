#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and the
repository checkout around this file; imports nothing of JAX or of the
JAX package.  Phases, in order — any failure exits non-zero:

1. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (nvcc);
2. set up the main path's data: ``random_geometric_topology(n=1M, k=8)``,
   p = 32 solitary models and confidences from a seed, and a ``lossy-10``
   event stream (batch n/10, 200 rounds) drawn by the port's scheduler on
   the card;
3. hold each kernel against its plain PyTorch version on the card at the
   shapes its path gives it, and time the kernel, the plain version and,
   where one exists, one library call of the same function;
   ``sparse_gather_mix`` twice, bit for bit: with its rows in identity
   order and in the topology's RCM locality order (built on the host
   here, timed, and cached on the topology for 4b); ``round_step`` bit
   for bit, with the registers and local bytes of its main-path apply
   kernel as the CUDA runtime reports them;
4. drive the paths through the user entry points, each with the launch
   counts set to 0 just before and read just after:
   a. ``run_scenario(ScenarioSpec(algo="mp", ...))`` fused (``round_step``
      kernel, one launch per round) and per-op on the same stream: equal
      counters, theta_hist within 1e-5, the accounting invariant;
   b. ``sparse_sync_mp`` on the same topology, 50 sweeps through
      ``sparse_gather_mix``, every launch given the RCM order, against
      the plain path;
   c. ``synchronous`` on ``random_geometric_graph(2048, k=8)``, D = 4096,
      100 steps through ``graph_mix``, against the plain path;
   c'. the same problem at alpha = 0.99 for 3000 steps (the sweeps'
      largest alpha, the JAX tests' run length), through the kernel and
      the reference backend: within 1e-5 after steps 100, 300, 1000 and
      3000, 3000 launches;
   j. the paper's multi-trial sweeps (§5.1 mean estimation at n = 300):
      ``run_mp_sweep`` on 100 seeds x alphas (0.5, 0.9, 0.99) = 300
      trials, 300 sweeps, exactly one ``graph_mix`` launch a sweep for all
      trials, against the plain path within 1e-5 (theta_final absolute,
      objective_hist and err_hist relative to their largest value); the
      batched ``graph_mix`` at the MP and joint sweeps' shapes (T = 300
      and 20, n = 300, D = 1) timed beside its bound and ``torch.baddbmm``
      (device time queued behind a sleep, and the wrapper's host time a
      call), each trial bit for bit with its own launch, a replay bit for
      bit; ``closed_form_comparison`` on those trials; then
      ``run_joint_sweep`` (10 seeds x eta (0, 0.3), its eta = 0 column
      equal to the MP sweep's trials bit for bit) and ``run_admm_sweep``
      (5 seeds x mu (0.05, 0.2), against the CPU on two trials within
      1e-4); trials x sweeps/s of each;
   f. the paper's async gossip (§3.2) on that graph, p = 32, 4,000 ticks
      on wake-ups drawn once by a seeded ``torch.Generator``: the dense
      ``async_gossip`` (Theta_tilde, 537 MB) and ``sparse_async_gossip``
      bit for bit (theta_hist, and every live slot against its dense
      knowledge cell); then ``sparse_async_gossip`` on the n = 1M
      topology (20,000 ticks) finite; ticks/s of each;
   g. joint graph learning (``algo="joint"``) on 4a's topology, models and
      stream: ``eta_graph=0`` equal to 4a's per-op trace bit for bit;
      the JAX benchmark's knobs (eta 0.3, lam 1.0, a graph step every 5
      rounds, prune at 1e-3): learned weights non-negative and exactly 0
      at dead slots, each row's mass in [1 - k * prune_eps, 1] (a prune
      zeroes a weight without renormalising the row, as in the JAX
      package), no pruned slot revived, the live-edge count never
      rising, suppressed <= delivered, the stream counters equal to 4a's;
      the last graph step on its inputs: projection rows summing to 1 and
      the blend keeping the row's mass within 1e-5, ``edge_reweight`` on
      the card within 1e-5 of the CPU; events/s beside 4a's per-op.
   k. the personalization service (``ScenarioSpec(serve=...)``) on 4a's
      fused run: 1M requests (5,000 a round over 200 rounds) served in
      batches of 65,536 from the committed record-chunk snapshots,
      theta_hist bit for bit 4a's; requests/s, hit rate, p50 and p99
      served staleness;
5mp. where the time of a fused MP round goes: ``PROFILE_ROUNDS`` fused
     rounds under ``torch.profiler``, read on the device timeline from
     the first round's ``round_step`` to the last one's (no set-up): the
     rounds' span, device time by operation, ``round_step``'s share and
     the device's busy share of the span (a reading, not a check).

Then CL-ADMM (paper §4.2) on the same topology and stream, after the MP
state is freed:

2cl. data: three standard-normal draws per agent (n, 3, p = 32) from the
     seed, ``theta_sol = solitary_mean(data)``, mu = 0.1, rho = 1.0;
3cl. ``cl_edge_step`` held bit for bit against its plain version on round
     ``WARM`` of the CL run (its own inputs, captured after ``WARM`` rounds
     of the plain body; the round must have stale sides and repeated
     targets), twice on the same state, with the kernel's election words
     all zero after each call; and ``admm_edge_update`` on every edge of
     that state;
4d.  ``run_scenario(ScenarioSpec(algo="cl", ...))`` with the kernel (auto)
     and with the reference backend on the same stream: equal counters,
     the accounting invariant, theta_hist within 1e-5, ``cl_edge_step``
     launched once per round;
4e.  ``dispatch.resolve("admm_edge", None, "cuda")`` once over every edge
     of the CL run's final state, against its plain version;
4h.  CL-ADMM with the inexact primal: ``InexactPrimal(quadratic,
     b_steps=None)`` (the B -> inf fixed point) within 1e-5 of 4d's exact
     kernel run; ``b_steps=8`` on the same data and stream
     (``INEXACT_ROUNDS`` rounds) with the kernel and the reference
     backend: equal counters, theta_hist within 1e-5, ``cl_edge_step``
     once per round; then federated moons at n = 20,000 with
     ``MLPAgent(2, (8,))`` (p = 33, the kernel's generic-p path): 400
     solitary AdamW steps, then 200 CL rounds of batch 2,000 with
     ``InexactPrimal(logistic, b_steps=10, lr=0.1)``, kernel and reference
     within 1e-5; mean test accuracies and events/s are readings;
5.   where the time of a CL round goes: ``PROFILE_ROUNDS`` rounds of the
     kernel path under ``torch.profiler``, device time by operation and
     the device's busy share of the wall time (a reading, not a check);
4i.  run telemetry on the n = 1M paths: fused MP, exact CL and joint
     learning (the benchmark's knobs) on the ``lossy-10`` stream, each
     through ``run_scenario`` with telemetry off and on: theta_hist bit
     for bit, the same kernel launches, the frames' counters equal to
     ``stream_chunk_totals`` (``link + churn + partition == dropped``),
     MP and CL staleness equal to ``stream_staleness_chunks`` and their
     updates to the deliveries (joint: updates + suppressed ==
     delivered); events/s off and on; one run directory written with
     ``write_run`` to a temporary path and read back with ``load_run``.

Then LM serving (Llama-3-8B at full width and depth, bf16 weights drawn
from the seed on the card), after the CL state is freed:

6a. ``flash_attention`` held against its plain version on the card at
    the main path's shape (B = 1, S = 4096, H = 32, K = 8, hd = 128,
    bf16), at StarCoder2-15B's window (S = 8192, H = 48, K = 4, window
    4096), at RecurrentGemma-2B's (S = 4096, H = 10, K = 1, hd = 256,
    window 2048), at each other family's served shape (OLMoE-1B-7B S 2048,
    H = K = 16; Qwen2-VL-7B S 4096, H 28, K 4; MusicGen-medium S 1024,
    H = K = 24, hd 64; Phi-3.5-MoE's is Llama's), on two small float32
    cases (hd 64 and 256) and in float32 at Llama-3-8B's and
    RecurrentGemma-2B's prefill shapes;
    kernel, plain, SDPA (kv heads repeated, a boolean band mask for a
    window; for float32 the profiler's name of SDPA's kernel) and bound
    ms (the band's operations), and the kernel's device ms and host µs a
    call read apart (``queued``).  bf16 runs a wgmma kernel
    (``flash_fwd_wgmma`` at hd 128, the warp-specialised ``flash_fwd_ws``
    at hd 256 and 64), which rounds the softmax weights to bf16 per kv
    tile (128 keys at hd 128, 80 at hd 256, 64 at hd 64; the plain
    version keeps them in float32): 1e-2 abs and rel; float32 runs
    3xTF32 on wgmma (``flash_fwd_3xtf32`` at hd 64 and 128,
    ``flash_fwd_3xtf32_pieces`` at hd 256; the bound is three TF32
    passes, the FFMA floor beside it): 1e-5;
6b. ``Engine(ServeConfig(batch_size=4, cache_len=8192, max_new_tokens=32))``
    serving six prompts (512 to 4096 tokens) through four slots with
    ``attn_impl="flash"``: every request finishes with 32 tokens in the
    vocab, ``flash_attention`` launched 32 layers x 6 prefills; prefill
    and decode tokens/s, wall seconds, peak device memory; then profiler
    readings of ``PROFILE_TICKS`` decode ticks and one 4096-token prefill,
    the prefill's device time split between ``flash_attention``, the
    gemms and the rest (elementwise passes, copies);
6c. one 2048-token prompt prefilled through the ``attention`` op's
    ``cuda`` and ``reference`` implementations with the same weights:
    last-position logits within ``LM_LOGIT_RTOL`` (relative L2), and the
    share of 16 greedy tokens on which the two agree;
6d. a float32 prefill: Llama-3-8B at full width, depth cut to 2 layers,
    ``compute_dtype=float32``, one 4096-token prompt through the
    ``attention`` op's ``cuda`` implementation (the hd-128 3xTF32 kernel,
    once a layer) and its ``reference`` one: last-position logits within
    ``F32_LOGIT_RTOL`` (relative L2);
6e. the same at RecurrentGemma-2B's width (hd 256, MQA, window 2048),
    depth cut to 6 layers (its pattern's first six: rec, rec, attn, rec,
    rec, attn), one 4096-token prompt: the hd-256 3xTF32 kernel twice
    (``F32_PREFILLS``).

Then personalized LM training with graph coupling, after the serving
model is freed:

7a. ``graph_mix``'s agent-axis form (n <= 32, D > 8) at the coupling's
    leaves — Llama-3-8B's embedding at n = 2, D = 525,336,576 in float32,
    plm-100m's at n = 8, D = 16,777,216 in float32 and bf16 — against
    its plain version (1e-5 in float32; in bf16 one bf16 ulp beyond the
    float32 sums' error, ``graph_mix.bf16_tolerance``), a replay bit for
    bit; kernel, plain, ``torch.addmm`` and bound ms;
7b. Llama-3-8B at full width with its depth cut to 2 layers, one model
    per agent for 2 agents on ``ring_graph(2)``, mp coupling every step
    (alpha 0.99, default AdamW with bf16 moments), batch 2 a agent at
    sequence 1024, tokens from ``personalized_token_stream`` at vocab
    512: 5 steps through ``train_loop`` (step 0, then steps 1-4 timed),
    the loss falling, ``graph_mix`` launched 12 leaves x 5 steps, the
    parameters after step 0 unlike a ``mode="none"`` step from the same
    state; tokens/s, ms a step, one more step split into forward and
    backward, AdamW, EMA and coupling by CUDA events and one under the
    profiler (device time by kernel), peak memory;
10a. the dry run against the card: 7b's configuration at one agent
    (the dry run's shape: one agent a device), Llama-3-8B cut to 2
    layers, batch 2 at sequence 1024, mp coupling, three steps through
    ``make_train_step``, peak device memory (``max_memory_allocated``
    above what was allocated before the state) and the steps' time; then
    ``repro_torch.launch.dryrun`` of the same configuration on a 1 x 1
    ("data", "model") mesh of the fake backend, in a process of its own:
    its predicted per-device peak and matmul FLOPs a step beside the
    measured peak and step time, the predicted peak within 25 % of the
    measured one;
10b. the dry run of ``llama3_8b x train_4k`` on the 16 x 16 production
    mesh with ``--schedule gossip``, in a process of its own: the record,
    its wall seconds and its collectives; gossip records point-to-point
    exchanges across the agents and no all-gather there;
7c. the repo's example (``examples/personalized_lm_torch.py``, its own
    ``run``) with its model (plm-100m: 12 x 512, vocab 32768) on 8
    agents of ``random_geometric_graph(8, k=3)``, the example's knobs
    (alpha 0.995, mu 0.02, every 4, lr 1e-3), batch 4 at sequence 128:
    20 steps of each coupling mode from one state, the loss falling in
    each, consensus leaving the agents equal within 1e-6 after its last
    coupled step, mp launching ``graph_mix`` 12 leaves x 5 times, the mp
    state's checkpoint read back bit for bit; tokens/s per mode.

Then the model families at their published widths (random bf16 weights
from the seed, ``attn_impl="flash"``), one at a time, each freed before
the next (``FAMILY_PHASES``); each asserts ``flash_attention``'s launches
(one per attention layer a prefill), holds its last prefill's logits
within ``LM_LOGIT_RTOL`` of the same model with ``attn_impl="chunked"``
(for MoE with the routing pinned, the kernel path's expert ids replayed:
capacity is taken in token order, so a routing choice that flips under
another rounding moves the later tokens' drops, and two plain attention
paths already put the last position 0.12 apart unpinned;
``tools/probe_moe_paths.py``), and reports
prefill and decode tokens/s, wall seconds and peak memory:

8a. OLMoE-1B-7B (64 experts, top 8; all 16 layers): ``Engine`` serving
    four prompts of 512-2048 tokens through four slots, 16 new tokens
    each; the ``gather`` MoE form's logits equal ``scatter``'s bit for bit
    on one 2048-token prefill;
8b. Phi-3.5-MoE (16 experts, top 2) with its depth cut from 32 to 8 (84
    GB of bf16 weights would not fit): one 4096-token prefill and 16
    decode steps, the two MoE forms bit for bit as in 8a;
8c. RecurrentGemma-2B (RG-LRU and local attention, MQA, hd 256, window
    2048; all 26 layers): ``Engine``, four prompts of 1024-4096 tokens,
    16 new tokens each;
8d. xLSTM-1.3B (the ``parallel`` mLSTM and the sLSTM; all 48 layers):
    ``Engine``, four prompts of 512-1024 tokens, 16 new tokens each; no
    attention, so no launch; then the last prompt through a float32 copy:
    at three mLSTM layers both forms on that layer's own input,
    ``parallel`` against ``scan`` within ``XLSTM_FORMS_RTOL``;
8e. Qwen2-VL-7B (M-RoPE; all 28 layers): ``Model.prefill`` of 256 random
    patch embeddings on a 16 x 16 grid and 3,840 text tokens, then 16
    greedy ``decode_step``s;
8f. MusicGen-medium (4 codebooks, hd 64; all 48 layers): ``Model.prefill``
    of 64 random conditioning embeddings and 960 delay-patterned codes,
    then 16 ``decode_step``s of (B, 4) tokens.

Then the partitioned simulator (DESIGN.md §11-§13) on ``SHARDS`` = 8
shards of the card (a ``LocalMesh``: the shards stacked along a leading
axis, collectives as tensor ops), before the LM phases:

9a. the greedy partition of 4a's topology (host seconds, edge cut, halo
    and boundary sizes, halo bytes a round per codec); then
    ``run_scenario(ScenarioSpec(algo="mp", sharded=True, ...))`` on 4a's
    problem and stream with the f32 codec under all_gather and ring: no
    overflow, within 1e-5 of the single-device fused run and of the
    per-op one (printed: whether equal to it bit for bit), the counters
    and activity equal; events/s beside the single-device per-op and
    fused runs timed in the same phase; the bf16 and int8 codecs once
    each, their max abs err against f32 above 0 and within ``CODEC_REL``
    times the largest |theta|;
9b. sharded CL-ADMM on 4d's problem: no overflow and theta_hist equal to
    4d's single-device kernel run bit for bit;
9c. sharded joint learning with 4g's knobs and halo re-compaction
    (``RECOMPACT``): theta_hist, the learned weights, the live mask, the
    live-edge history and the suppressed count equal to the single-device
    joint run; re-compactions and the halo size before and after;
9d. ``sparse_sync_mp`` with ``sparse_mix="cuda_sharded"``: one
    ``sparse_gather_mix`` launch a block a sweep (SWEEPS x SHARDS), each
    with its block's share of the RCM order, bit for bit with
    ``reference_sharded`` and with the single-device kernel sweep; one
    block's kernel time beside phase 3's whole-table time and the block's
    byte bound;
9e. a ``DistMesh`` over an NCCL process group of world size 1 (loopback
    address, torn down after): the cuda_sharded sweep and a short
    partitioned MP run bit for bit with a ``LocalMesh`` of one shard, and
    the dense mp coupling over it (all-gathered, one ``graph_mix`` launch
    a leaf) bit for bit with ``dense_mix_tree`` (one card hosts one NCCL
    rank; multi-rank runs are checked on the CPU under gloo).

Last, after the model families:

11. the five simulator examples and the two serving demos
    (``examples/<name>_torch.py``: quickstart, federated_moons,
    network_sim_demo, joint_graph_demo, nonlinear_agents_demo,
    serve_demo, collab_serve_demo), each through its own ``main`` in
    process on the card at its default size, the launch counts set to 0
    just before and read just after (``EXAMPLE_PHASES``): one JSON line
    each with the figures it returned, its wall seconds and its launches
    by kernel.
    Each example's own assertion must hold, each kernel output of an
    example must be within 1e-5 of its plain version's on the same inputs
    (quickstart's ``synchronous`` rows form and ``run_mp_sweep`` trial
    axis through ``graph_mix``; network_sim_demo's theta* through
    ``sparse_gather_mix`` at p = 16, against the reference backend on
    the example's problem rebuilt from its seed), each example must
    launch the kernels its path should (quickstart and federated_moons
    ``graph_mix``, network_sim_demo ``sparse_gather_mix`` for theta*,
    nonlinear_agents_demo ``cl_edge_step``), and
    ``tools/trace_report_torch.py`` must render the run directories that
    network_sim_demo and joint_graph_demo write with ``--out`` (under a
    temporary directory).  The serving demos take no kernel route
    (serve_demo's model attends by the plain ``ref`` route, as the JAX
    demo's; collab_serve_demo's scenario passes no backend, so its rounds
    and its service are torch ops) and fail the phase if they launch one:
    serve_demo must not exhaust its tick budget and must return
    ``SERVE_DEMO_TOKENS`` tokens for every request, collab_serve_demo's
    ``theta_hist`` must be bit for bit the same with serving and telemetry
    on and off.  The kernels line adds these launches to each
    kernel's ``launches_by_path`` under ``examples``.

Prints one JSON line per kernel, then ``{"kernels": [...]}`` (all six
kernels, with their launches on their paths; ``sparse_gather_mix``
counts 4b's, 9d's (one a block) and 9e's; ``graph_mix`` counts its
three paths and carries its trial-axis readings under ``trial_axis``;
its agent-axis form has its own entry with the launches of 7b and 7c's
mp run; ``flash_attention``'s launches (6b's and 8a-8f's) are split by
head dim: its hd-128 entry (Llama-3-8B's shape,
with OLMoE's and Qwen2-VL's under ``cases``) counts 6b, 8a, 8b and 8e,
its hd-256 entry 8c and its hd-64 entry 8f, each with its registers),
the card's name and power limit as nvidia-smi reports them, and last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib.util
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time
import types

ROOT = pathlib.Path(__file__).resolve().parent

# H100 SXM data-sheet peaks (dense, no sparsity) used for the bounds
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12            # float32 outside the tensor cores
TF32_FLOP_PER_S = 495e12           # TF32 tensor cores
BF16_FLOP_PER_S = 989e12           # bf16 tensor cores

N_AGENTS, K_NN, P = 1_000_000, 8, 32
BATCH, ROUNDS, RECORD = N_AGENTS // 10, 200, 50
SWEEPS = 50
WARM = 10          # rounds replayed before round_step is held and timed
PROFILE_ROUNDS = 50
N_DENSE, K_DENSE, D_DENSE, STEPS = 2048, 8, 4096, 100
# 4c': the same problem at the sweeps' largest alpha, read at these steps
DRIFT_ALPHA, DRIFT_MARKS = 0.99, (100, 300, 1000, 3000)
# 9a: a lossy halo codec's run against the f32 one is held above 0 (the
# codec was applied) and within its one-trip relative error times the
# largest |theta| (bf16 keeps 8 significant bits; int8 scales each row by
# its largest value / 127), which a wrong scale or a skipped halo fails
CODEC_REL = {"bf16": 2.0 ** -8, "int8": 2.0 ** -6}
SLEEP_CYCLES = 50_000_000   # device-side sleep that timed calls queue behind
ALPHA, SEED = 0.9, 0
MU, RHO = 0.1, 1.0          # CL-ADMM (the JAX benchmark's CL configuration)
DEVICE = "cuda"
# 4f: the paper's async gossip, one wake-up a tick
GOSSIP_TICKS, GOSSIP_RECORD = 4_000, 500          # dense and sparse, n = 2048
GOSSIP_TICKS_1M, GOSSIP_RECORD_1M = 20_000, 5_000  # sparse, n = 1M
# 4g: the JAX benchmark's graph-learning knobs (bench_network_sim.py:91)
JOINT_KW = dict(eta_graph=0.3, lam=1.0, graph_every=5, prune_eps=1e-3)
# 4h: the inexact primal at n = 1M (rounds of the b_steps = 8 pair), and
# federated moons with MLP agents at a larger n than the JAX acceptance
# test's 24: the problem's generator loops over agents on the host
INEXACT_ROUNDS, INEXACT_RECORD = 50, 25
MOONS_N, MOONS_BATCH, MOONS_ROUNDS, MOONS_RECORD = 20_000, 2_000, 200, 100
MOONS_SOLITARY_STEPS = 400
# 4j: the paper's §5.1 sweeps at the generator's default n = 300
SWEEP_N, SWEEP_SEEDS, SWEEP_ALPHAS, SWEEP_STEPS = 300, 100, (0.5, 0.9, 0.99), \
    300
JOINT_SWEEP_SEEDS, JOINT_SWEEP_ETAS, JOINT_SWEEP_EVERY = 10, (0.0, 0.3), 10
ADMM_SWEEP_SEEDS, ADMM_SWEEP_MUS, ADMM_SWEEP_ITERS = 5, (0.05, 0.2), 50
# 9a-9e: the partitioned simulator on SHARDS shards of one card (a
# LocalMesh); 9c re-compacts the halo (checked every 50 rounds, once 1 % of
# the live cross edges are pruned); 9e runs a DistMesh over NCCL at world
# size 1
SHARDS = 8
RECOMPACT = dict(recompact_every=50, recompact_frac=0.01)
DIST_SWEEPS, DIST_ROUNDS = 10, 20

# LM serving: Llama-3-8B at full width and depth
LM_ARCH = "llama3-8b"
LM_PROMPTS = (512, 1024, 2048, 4096, 1536, 3072)   # multiples of attn_chunk
LM_SLOTS, LM_CACHE, LM_NEW = 4, 8192, 32
LM_CHECK_PROMPT, LM_AGREE = 2048, 16
PROFILE_TICKS = 5
# Kernel and reference attention differ only in float32 summation order,
# so their bf16 outputs differ by an ulp here and there; through 32 bf16
# layers such a perturbation grows to the chaos floor of bf16 arithmetic,
# about 2^-8 * sqrt(32) = 2 % of the logits' norm.  A wrong kernel (a
# wrong head, mask or tile) moves them by O(1).  So: relative L2 <= 0.1.
LM_LOGIT_RTOL = 0.1
# 6d, 6e: float32 prefills through the 3xTF32 kernels, (phase, model,
# layers, prompt): Llama-3-8B's width at 2 layers (hd 128; float32 weights,
# 6 GB) and RecurrentGemma-2B's at 6 (rec, rec, attn, rec, rec, attn; hd
# 256, window 2048; 4.6 GB); the kernels are within 1e-5 of the plain
# attention, so two float32 attention layers keep the logits far inside
# 1e-4 (relative L2)
F32_PREFILLS = (("6d", LM_ARCH, 2, 4096), ("6e", "recurrentgemma-2b", 6, 4096))
F32_LOGIT_RTOL = 1e-4
# 4k: the personalization service's requests on the fused MP run
SERVE_RATE, SERVE_BATCH = 5000, 65536      # requests a round, batch width
# 7a: graph_mix's agent-axis form at the coupling's leaves: (n, D, dtype)
AGENT_CASES = ((2, 525_336_576, "float32"),    # Llama-3-8B's embedding
               (8, 16_777_216, "float32"),     # plm-100m's embedding
               (8, 16_777_216, "bfloat16"))
# 7b: Llama-3-8B at full width, depth cut to 2, 2 agents on a ring
TRAIN_LAYERS, TRAIN_AGENTS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = \
    2, 2, 2, 1024, 5
STREAM_VOCAB = 512      # the token stream's V (its generator holds A V^2)
# 10a: 7b's configuration at one agent, DRY_STEPS steps, against the dry
# run's prediction of its per-device peak memory
DRY_STEPS, DRY_PEAK_RTOL = 3, 0.25
DRY_TIMEOUT_S = 900
# 7c: the repo's example (examples/personalized_lm_torch.py): its plm-100m
# (``model_config(PLM_TINY)``), 8 agents
EXAMPLE = ROOT / "examples" / "personalized_lm_torch.py"
PLM_TINY = False
PLM_AGENTS, PLM_BATCH, PLM_SEQ, PLM_STEPS, PLM_EVERY = 8, 4, 128, 20, 4
PLM_MODES = ("none", "consensus", "mp", "cl")
# 11: the simulator examples and the serving demos at their default size,
# each with the kernels its path should launch on the card.
# network_sim_demo's scenarios pass no backend, as the JAX example's do,
# so they run the per-op MP round
# (round_step only runs under a backend: 4a); joint_graph_demo's graph
# step (edge_reweight) and rounds are torch ops.  Their launches are
# recorded all the same.
EXAMPLE_PHASES = (
    ("quickstart", ("graph_mix",)),
    ("federated_moons", ("graph_mix",)),
    ("network_sim_demo", ("sparse_gather_mix",)),
    ("joint_graph_demo", ()),
    ("nonlinear_agents_demo", ("cl_edge_step",)),
    ("serve_demo", ()),
    ("collab_serve_demo", ()))
EXAMPLE_RUN_DIRS = ("network_sim_demo", "joint_graph_demo")
EXAMPLE_CUDA_TOL = 1e-5
# the serving demos launch no kernel; every serve_demo request decodes
# its ServeConfig's max_new_tokens (no eos_id, and the longest prompt, 30,
# plus 24 fits the 128-position cache): the JAX demo's count, which
# tests/test_torch_examples.py holds the port to on the CPU
SERVING_DEMOS = ("serve_demo", "collab_serve_demo")
SERVE_DEMO_TOKENS = 24
# 8a-8f: the model families at full published width (random bf16 weights,
# attn_impl="flash"), one at a time: (phase, arch, depth or None, traffic).
# "engine": prompt lengths served by Engine through FAMILY_SLOTS slots;
# "prefill": Model.prefill of one sequence of that many positions (prefix
# included), then FAMILY_NEW decode_steps.  Every sequence through an
# attention layer is a multiple of attn_chunk (512), or attn_apply_seq
# takes the ref route instead of the kernel.
FAMILY_PHASES = (
    ("8a", "olmoe-1b-7b", None, "engine", (512, 1024, 2048, 1536)),
    # 32 layers of bf16 weights are 84 GB: the depth is cut to 8 (~21 GB)
    ("8b", "phi3.5-moe", 8, "prefill", 4096),
    ("8c", "recurrentgemma-2b", None, "engine", (1024, 2560, 4096, 3072)),
    ("8d", "xlstm-1.3b", None, "engine", (512, 1024, 768, 640)),
    ("8e", "qwen2-vl-7b", None, "prefill", 4096),    # 256 patches + 3840
    ("8f", "musicgen-medium", None, "prefill", 1024))  # 64 cond + 960 codes
FAMILY_SLOTS, FAMILY_NEW, MOE_CHECK_PROMPT = 4, 16, 2048
# 8d: the mLSTM's parallel and scan forms in float32, layer by layer on the
# same inputs: the JAX package's bar for the same two forms
# (tests/test_parallel_forms.py:30, 1e-4).  The parallel form takes
# F_i - F_j from one cumsum of the log forget gates, which loses about
# S |f| 2^-24 to cancellation (3e-5 at S = 640)
XLSTM_FORMS_RTOL, XLSTM_CHECK_LAYERS = 1e-4, (0, 22, 46)
VLM_GRID = 16                      # 8e: 256 patches on a 16 x 16 grid, t = 0
# flash_attention cases: (B, S, H, K, hd, window, dtype name)
# (Phi-3.5-MoE's 8b prefill has Llama-3-8B's shape)
FA_CASES = ((1, 4096, 32, 8, 128, None, "bfloat16"),    # Llama-3-8B prefill
            (1, 8192, 48, 4, 128, 4096, "bfloat16"),    # StarCoder2 window
            (2, 512, 8, 2, 64, None, "float32"),
            (1, 4096, 10, 1, 256, 2048, "bfloat16"),    # RecurrentGemma-2B
            (1, 512, 4, 2, 256, 128, "float32"),
            (1, 2048, 16, 16, 128, None, "bfloat16"),   # OLMoE-1B-7B
            (1, 4096, 28, 4, 128, None, "bfloat16"),    # Qwen2-VL-7B
            (1, 1024, 24, 24, 64, None, "bfloat16"),    # MusicGen-medium
            (1, 4096, 32, 8, 128, None, "float32"),     # Llama-3-8B, f32
            (1, 4096, 10, 1, 256, 2048, "float32"))     # RecurrentGemma, f32


def log(*a):
    print(*a, flush=True)


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    return 1


def bound_ms(n_bytes: float, n_ops: float, flop_per_s=FP32_FLOP_PER_S):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / flop_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def time_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls, from
    CUDA events after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def queued(torch, fn, iters: int, warmup: int = 3):
    """``fn``'s device ms and host µs a call: ``iters`` calls enqueued
    behind a device-side sleep, so CUDA events around them read the device
    alone and the host clock reads the enqueueing alone.  Returns ``(device
    ms, host µs, whether the host had enqueued every call before the sleep
    ended)``; without the last the events also read the host."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    torch.cuda._sleep(SLEEP_CYCLES)
    ev[1].record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = time.perf_counter() - t0
    ev[2].record()
    ev[2].synchronize()
    return (ev[1].elapsed_time(ev[2]) / iters, host_s * 1e6 / iters,
            host_s * 1e3 < ev[0].elapsed_time(ev[1]))


def check_graph_mix(torch, gm, graph_inputs):
    """graph_mix at the synchronous path's shapes and inputs.  The kernel
    meets the 1e-5 bar with three TF32 tensor-core passes (3xTF32), so its
    bound is those passes at the TF32 peak; the float32 FFMA floor of the
    same product is reported beside it."""
    theta, sol, A, b = graph_inputs
    n, D = theta.shape
    got = gm.graph_mix(theta, sol, A, b)
    want = gm.graph_mix_plain(theta, sol, A, b)
    err = (got - want).abs().max().item()
    bsol = b[:, None] * sol
    n_bytes = 4 * (n * n + 3 * n * D + n)
    bms, by = bound_ms(n_bytes, 3 * 2 * n * n * D, TF32_FLOP_PER_S)
    return dict(
        name="graph_mix", route="cuda",
        source="src/repro_torch/kernels/csrc/graph_mix.cu",
        replaces="src/repro/kernels/graph_mix.py:28",
        design="mma.sync 3xTF32, cp.async x3, each 8-deep step's partial "
               "sums from zero, added in IEEE float32",
        shape=f"n={n} D={D}", max_abs_err=err, tol=1e-5,
        ms=time_ms(torch, lambda: gm.graph_mix(theta, sol, A, b), 20),
        plain_ms=time_ms(torch, lambda: gm.graph_mix_plain(theta, sol, A, b),
                         20),
        bound_ms=bms, bound_by=by,
        ffma_floor_ms=bound_ms(n_bytes, 2 * n * n * D + 2 * n * D)[0],
        library_ms=time_ms(torch, lambda: torch.addmm(bsol, A, theta), 20),
        library_call="torch.addmm(b*sol, A, theta)")


def check_graph_mix_trials(torch, gm, args):
    """graph_mix over the sweep's trial axis at its shape and inputs (the
    first step of a sweep): one launch for T problems of D = 1, which take
    the kernel's FFMA rows path.  The work is A's T n^2 floats read once, so
    the bound is bytes; the library call is ``torch.baddbmm`` of the same
    function.  ``ms`` is the kernel's device time with its output made
    beforehand (the C entry launched directly, queued behind a sleep), and
    ``host_us`` the wrapper's host time a call; ``wrapper_ms`` times
    back-to-back wrapper calls as ``time_ms`` does, which reads the host
    where the host is the slower.  Each trial equals its own launch bit for
    bit, and a replay equals the first call."""
    from repro_torch.kernels import _build
    theta, sol, A, b = args
    T, n, D = theta.shape
    got = gm.graph_mix(theta, sol, A, b)
    err = (got - gm.graph_mix_plain(theta, sol, A, b)).abs().max().item()
    per_trial = all(torch.equal(got[t], gm.graph_mix(theta[t], sol[t], A[t],
                                                     b[t]))
                    for t in sorted({0, T // 2, T - 1}))
    replay = torch.equal(got, gm.graph_mix(theta, sol, A, b))
    bsol = b[..., None] * sol
    bms, by = bound_ms(4 * (T * n * n + 3 * T * n * D + T * n),
                       2 * T * n * n * D + 2 * T * n * D)
    out, lib_out = torch.empty_like(theta), torch.empty_like(theta)
    ptrs = [t.data_ptr() for t in (A, theta, sol, b, out)]
    ms, _, ok_k = queued(torch, lambda: _build.launch(
        "repro_graph_mix", *ptrs, T, n, D, device=theta.device), 50)
    _, host_us, ok_w = queued(torch, lambda: gm.graph_mix(theta, sol, A, b),
                              50)
    lib_ms, _, ok_l = queued(torch, lambda: torch.baddbmm(
        bsol, A, theta, out=lib_out), 50)
    return dict(
        design="16 lanes a row, 5 16-byte loads a lane in flight, theta "
               "staged in shared memory, FFMA (D <= 8)",
        shape=f"T={T} n={n} D={D}", max_abs_err=err, tol=1e-5,
        trials_bit_for_bit=per_trial, replay_bit_for_bit=replay,
        ms=ms, host_us=host_us, queued=ok_k and ok_w and ok_l,
        wrapper_ms=time_ms(torch, lambda: gm.graph_mix(theta, sol, A, b),
                           20),
        plain_ms=time_ms(torch, lambda: gm.graph_mix_plain(theta, sol, A,
                                                           b), 20),
        bound_ms=bms, bound_by=by, library_ms=lib_ms,
        library_call="torch.baddbmm(b*sol, A, theta, out=...)")


def check_drift(torch, dispatch, synchronous, g, sol, c, dev):
    """4c'. ``synchronous`` at alpha = DRIFT_ALPHA for the last of
    DRIFT_MARKS steps, through the kernel and through the reference
    backend, each continued from its own iterate between the marks; the
    largest |kernel - plain| at each mark, and the mean signed difference
    (a bias shows there).  Returns ``(reading, the kernel run's launches)``.
    """
    plain = dispatch.ReproBackend(default="reference")
    ker = ref = None
    done, readings, launches, secs = 0, {}, 0, 0.0
    for mark in DRIFT_MARKS:
        dispatch.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ker = synchronous(g, sol, c, DRIFT_ALPHA, mark - done, theta0=ker,
                          device=dev)
        torch.cuda.synchronize()
        secs += time.perf_counter() - t0
        launches += dispatch.launch_counts()["graph_mix"]
        ref = synchronous(g, sol, c, DRIFT_ALPHA, mark - done, theta0=ref,
                          device=dev, backend=plain)
        diff = ker - ref
        readings[str(mark)] = dict(max_abs=diff.abs().max().item(),
                                   mean_signed=diff.mean().item(),
                                   finite=bool(torch.isfinite(ker).all()))
        done = mark
    return dict(phase="4c'", alpha=DRIFT_ALPHA, shape=f"n={g.n} "
                f"D={sol.shape[-1]}", tol=1e-5, steps_per_s=done / secs,
                max_abs_ref=ref.abs().max().item(), readings=readings), \
        launches


def rel_err(got, want):
    """max |got - want| over max |want| (numpy arrays)."""
    return float(abs(got - want).max() / max(abs(want).max(), 1e-30))


def check_sweeps(torch, np, dispatch, gm, dev):
    """4j. The paper's §5.1 sweeps at n = 300: ``run_mp_sweep`` on 300
    trials, 300 sweeps, one ``graph_mix`` launch a sweep, against the
    plain path within 1e-5; the batched ``graph_mix`` at the sweep shape;
    ``closed_form_comparison``; ``run_joint_sweep`` with its eta = 0
    column equal to the MP sweep bit for bit; ``run_admm_sweep`` against
    the CPU on two trials.  Returns ``(the trial-axis kernel reading, the
    MP sweep's launches, failure message or None)``."""
    from repro_torch.core.model_propagation import mp_mix_operator
    from repro_torch.experiments import (admm_mean_estimation_trials,
                                         closed_form_comparison,
                                         joint_mean_estimation_trials,
                                         mean_estimation_trials,
                                         run_admm_sweep, run_joint_sweep,
                                         run_mp_sweep)
    plain = dispatch.ReproBackend(default="reference")
    t0 = time.perf_counter()
    trials = mean_estimation_trials(range(SWEEP_SEEDS), SWEEP_ALPHAS,
                                    n=SWEEP_N)
    T = trials.n_trials
    log(f"[4j] {T} trials of the §5.1 problem at n={SWEEP_N} built on the "
        f"host in {time.perf_counter() - t0:.2f} s")
    dispatch.reset_launch_counts()
    ker, secs = timed(torch, lambda: run_mp_sweep(
        trials, SWEEP_STEPS, device=dev))
    launches = dispatch.launch_counts()
    ref, secs_p = timed(torch, lambda: run_mp_sweep(
        trials, SWEEP_STEPS, backend=plain, device=dev))
    errs = dict(theta_final=float(abs(ker.theta_final
                                      - ref.theta_final).max()),
                objective_hist=rel_err(ker.objective_hist,
                                       ref.objective_hist),
                err_hist=rel_err(ker.err_hist, ref.err_hist))
    log(f"[4j] run_mp_sweep: {T} trials x {SWEEP_STEPS} sweeps, kernel "
        f"{T * SWEEP_STEPS / secs:.4g} trials*sweeps/s ({secs:.3f} s), "
        f"plain {T * SWEEP_STEPS / secs_p:.4g}; launches {launches}; "
        f"kernel vs plain {errs} (tol 1e-5; theta absolute, histories "
        f"relative)")
    if launches["graph_mix"] != SWEEP_STEPS \
            or sum(launches.values()) != SWEEP_STEPS:
        return None, launches, "4j: not one graph_mix launch a sweep"
    if not max(errs.values()) <= 1e-5 \
            or not np.isfinite(ker.objective_hist).all():
        return None, launches, "4j: the MP sweep's kernel vs plain"
    # the batched graph_mix on the sweep's own first-step inputs
    P, c, sol = (torch.as_tensor(a, device=dev)
                 for a in (trials.P, trials.c, trials.theta_sol))
    A_mix, b = mp_mix_operator(
        P, c, torch.as_tensor(trials.alpha, device=dev)[:, None])
    batched = [check_graph_mix_trials(torch, gm, (sol, sol, A_mix, b))]
    del P, A_mix, b, sol, c

    (e_c, e_nc, win), secs = timed(torch, lambda: closed_form_comparison(
        trials, device=dev))
    log(f"[4j] closed_form_comparison: {T} trials in {secs:.3f} s; "
        f"confidences win on {win.mean():.3f} of the trials; mean error "
        f"with {e_c.mean():.4g}, without {e_nc.mean():.4g}")
    if e_c.shape != (T,) or not np.isfinite(e_c).all() \
            or not np.isfinite(e_nc).all():
        return batched, launches, "4j: closed_form_comparison"

    jt = joint_mean_estimation_trials(range(JOINT_SWEEP_SEEDS), (0.9,),
                                      JOINT_SWEEP_ETAS, n=SWEEP_N)
    # the batched graph_mix at the joint sweep's shape, on its first step
    P, c, sol = (torch.as_tensor(a, device=dev)
                 for a in (jt.P, jt.c, jt.theta_sol))
    A_mix, b = mp_mix_operator(
        P, c, torch.as_tensor(jt.alpha, device=dev)[:, None])
    batched.append(check_graph_mix_trials(torch, gm, (sol, sol, A_mix, b)))
    del P, A_mix, b, sol, c
    for reading in batched:
        log("[4j] graph_mix over the trial axis: " + json.dumps(reading))
        if not reading["max_abs_err"] <= reading["tol"] \
                or not reading["trials_bit_for_bit"] \
                or not reading["replay_bit_for_bit"]:
            return batched, launches, "4j: batched graph_mix vs plain"
    dispatch.reset_launch_counts()
    jr, secs = timed(torch, lambda: run_joint_sweep(
        jt, SWEEP_STEPS, graph_every=JOINT_SWEEP_EVERY, device=dev))
    jl = dispatch.launch_counts()["graph_mix"]
    frozen = jt.eta == 0.0
    # the MP sweep's trial of the same seed at alpha = 0.9
    same = np.array_equal(jr.theta_final[frozen], ker.theta_final[
        np.asarray(jt.seed[frozen]) * len(SWEEP_ALPHAS)
        + SWEEP_ALPHAS.index(0.9)])
    mass = jr.intra_mass_hist[~frozen]
    log(f"[4j] run_joint_sweep: {jt.n_trials} trials x {SWEEP_STEPS} "
        f"sweeps in {secs:.3f} s = "
        f"{jt.n_trials * SWEEP_STEPS / secs:.4g} trials*sweeps/s; "
        f"graph_mix launches {jl}; eta=0 column equal to the MP sweep: "
        f"{same}; learned rows' intra-cluster weight share "
        f"{mass[:, 0].mean():.4f} -> {mass[:, -1].mean():.4f}")
    if jl != SWEEP_STEPS or not same \
            or not np.isfinite(jr.objective_hist).all():
        return batched, launches, "4j: run_joint_sweep"

    at = admm_mean_estimation_trials(range(ADMM_SWEEP_SEEDS),
                                     ADMM_SWEEP_MUS, (1.0,), n=SWEEP_N)
    ar, secs = timed(torch, lambda: run_admm_sweep(
        at, ADMM_SWEEP_ITERS, device=dev))
    two = dataclasses.replace(at, **{f.name: getattr(at, f.name)[:2]
                                     for f in dataclasses.fields(at)})
    cpu = run_admm_sweep(two, ADMM_SWEEP_ITERS, device="cpu")
    err = float(abs(ar.theta_final[:2] - cpu.theta_final).max())
    log(f"[4j] run_admm_sweep: {at.n_trials} trials x {ADMM_SWEEP_ITERS} "
        f"iterations in {secs:.3f} s = "
        f"{at.n_trials * ADMM_SWEEP_ITERS / secs:.4g} trials*iters/s; "
        f"card vs CPU on two trials max |diff| = {err:.3g} (tol 1e-4)")
    if not err <= 1e-4 or not np.isfinite(ar.objective_hist).all():
        return batched, launches, "4j: run_admm_sweep"
    return batched, launches, None


def telemetry_costs(torch, spec_mp):
    """4i, a reading (nothing is checked): what telemetry adds to the fused
    MP run, by part, with CUDA events over 20 calls after warm-up — a
    round's counters (``_Telemetry.round`` on round 0's sides) and one
    chunk's Eq. 3 objective on an (n*k, p+1) slot table of the run's size
    (standard normal) read through the fused body's strided (n, k, p)
    view, and on a contiguous copy of the same slots."""
    from repro_torch.simulate.engines import _Telemetry
    from repro_torch.telemetry import metrics as tm

    tabs = spec_mp["topology"].device_tables(spec_mp["device"])
    sol, c = spec_mp["theta_sol"], spec_mp["c"]
    n, k = tabs.nbr_idx.shape
    p = sol.shape[1]
    ev = spec_mp["stream"].batch_at(0)
    upd, got = torch.cat([ev.i, ev.j]), torch.cat([ev.deliver_ji,
                                                   ev.deliver_ij])
    tel = _Telemetry(n, sol.device)
    g = torch.Generator(device=sol.device).manual_seed(SEED)
    Ke = torch.randn((n * k, p + 1), generator=g, device=sol.device)
    view = Ke.view(n, k, p + 1)[:, :, :p]
    dense = view.contiguous()
    costs = dict(
        round_ms=time_ms(torch, lambda: tel.round(upd, got), 20),
        objective_strided_ms=time_ms(torch, lambda: tm.mp_local_objective(
            sol, view, tabs.nbr_p, c, sol, ALPHA), 20),
        objective_contiguous_ms=time_ms(
            torch, lambda: tm.mp_local_objective(sol, dense, tabs.nbr_p, c,
                                                 sol, ALPHA), 20))
    log(f"[4i] telemetry's costs at n={n}, k={k}, p={p}, {upd.numel()} "
        f"sides a round: " + json.dumps(costs))
    del Ke, view, dense


def check_telemetry(torch, np, dispatch, spec_mp, spec_cl):
    """4i. Run telemetry on the n = 1M paths (fused MP, exact CL, joint
    with the benchmark's knobs), each with telemetry off and on: theta
    bit for bit, the same launches, the frames' counters equal to the
    stream's, staleness equal to its replay (MP, CL) and updates to the
    deliveries; then a run directory written and read back.  Returns a
    failure message or None."""
    import os
    import tempfile

    from repro_torch.simulate import ScenarioSpec, run_scenario
    from repro_torch.telemetry import (TelemetryConfig, build_manifest,
                                       load_run, render_summary, trace_rows,
                                       write_run)
    from repro_torch.telemetry import metrics as tm

    stream, n = spec_mp["stream"], spec_mp["topology"].n
    n_rec = ROUNDS // RECORD
    totals = tm.stream_chunk_totals(stream, n_rec, RECORD)
    replay = tm.stream_staleness_chunks(stream, n, n_rec, RECORD)
    cells = (("mp-fused", dict(spec_mp, backend=dispatch.ReproBackend())),
             ("cl", dict(spec_cl, rounds=ROUNDS, record_every=RECORD)),
             ("joint", dict(spec_mp, algo="joint", **JOINT_KW)))
    rows = None
    for label, spec in cells:
        traces, rates, launches = [], [], []
        for tel in (None, TelemetryConfig(enabled=True)):
            dispatch.reset_launch_counts()
            tr, secs = timed(torch, lambda: run_scenario(ScenarioSpec(
                **spec, telemetry=tel)))
            launches.append(dispatch.launch_counts())
            if label == "cl":
                tr.final = None
            traces.append(tr)
            rates.append(tr.events / secs)
        off, on = traces
        f = on.telemetry
        same = torch.equal(off.theta_hist, on.theta_hist)
        drops = f.drop_link + f.drop_churn + f.drop_partition
        counters = all(np.array_equal(getattr(f, k), v)
                       for k, v in totals.items()) \
            and (drops[-1], f.delivered[-1], f.invalid[-1]) \
            == (on.dropped, on.delivered, on.invalid)
        if label == "joint":
            stale = bool((f.staleness >= replay).all())
            updates = np.array_equal(f.updates + f.suppressed, f.delivered)
        else:
            stale = np.array_equal(f.staleness, replay)
            updates = np.array_equal(f.updates, f.delivered)
        last = f.summarize()[-1]
        log(f"[4i] {label}: telemetry off {rates[0]:.4g} events/s, on "
            f"{rates[1]:.4g} ({rates[1] / rates[0]:.3f}x); theta_hist "
            f"equal: {same}; launches {launches[1]}; counters equal to "
            f"the stream's: {counters}; staleness "
            f"{'>= the replay' if label == 'joint' else 'equal to the replay'}"
            f": {stale}; updates: {updates}; last chunk objective "
            f"{last['objective']:.6e}, staleness p50/p99/max "
            f"{last['staleness_p50']:.0f}/{last['staleness_p99']:.0f}/"
            f"{last['staleness_max']}, drops l/c/p {last['drop_link']}/"
            f"{last['drop_churn']}/{last['drop_partition']}")
        if not (same and counters and stale and updates) \
                or launches[0] != launches[1] \
                or not np.isfinite(f.objective).all():
            return f"4i: {label} telemetry"
        if label == "mp-fused":
            rows = trace_rows(on)
        del traces, off, on, tr
    telemetry_costs(torch, spec_mp)
    manifest = build_manifest(backend=dispatch.ReproBackend(), seed=SEED,
                              extra=dict(phase="4i", scenario="lossy-10",
                                         n=n, rounds=ROUNDS, batch=BATCH))
    with tempfile.TemporaryDirectory() as tmp:
        m2, rows2 = load_run(write_run(os.path.join(tmp, "run"), manifest,
                                       rows))
    log("[4i] " + render_summary(m2, rows2).replace("\n", "\n[4i] "))
    if m2 != json.loads(json.dumps(manifest)) \
            or rows2 != json.loads(json.dumps(rows)):
        return "4i: the run directory did not round-trip"
    return None


def check_sparse_mix(torch, sm, table, idx, w, b, sol, order, label):
    """sparse_gather_mix at the sparse_sync_mp path's shapes and inputs:
    a steady-state sweep, whose table (the previous sweep's output) is a
    tensor apart from ``sol``, so each is counted once in the bound.  The
    kernel takes the rows in ``order`` (None: identity), held bit for bit
    either way."""
    n, k = idx.shape
    p = table.shape[1]
    if table.data_ptr() == sol.data_ptr():
        raise ValueError("check_sparse_mix: give a table apart from sol")
    got = sm.sparse_gather_mix(table, idx, w, b, sol, order=order)
    want = sm.sparse_gather_mix_plain(table, idx, w, b, sol)
    err = (got - want).abs().max().item()
    rows_read = torch.unique(idx).numel()
    n_bytes = 4 * (rows_read * p + 2 * n * k + n + 2 * n * p)
    if order is not None:
        n_bytes += 4 * n
    n_ops = 2 * n * k * p + 2 * n * p
    bms, by = bound_ms(n_bytes, n_ops)
    # one library call of the same function: a CSR sparse product
    crow = torch.arange(0, n * k + 1, k, device=idx.device)
    S = torch.sparse_csr_tensor(crow, idx.reshape(-1).long(), w.reshape(-1),
                                size=(n, table.shape[0]),
                                check_invariants=False)
    bsol = b[:, None] * sol
    lib_err = (torch.addmm(bsol, S, table) - want).abs().max().item()
    return dict(
        name="sparse_gather_mix", route="cuda",
        source="src/repro_torch/kernels/csrc/sparse_mix.cu",
        replaces="src/repro/kernels/sparse_mix.py:32",
        design=f"warp per row, k gathers in flight, {label} row order",
        shape=f"N={table.shape[0]} n={n} k={k} p={p} order={label}",
        max_abs_err=err, tol=0.0,
        ms=time_ms(torch, lambda: sm.sparse_gather_mix(
            table, idx, w, b, sol, order=order), 20),
        plain_ms=time_ms(torch, lambda: sm.sparse_gather_mix_plain(
            table, idx, w, b, sol), 20),
        bound_ms=bms, bound_by=by,
        library_ms=time_ms(torch, lambda: torch.addmm(bsol, S, table), 20),
        library_call="torch.addmm(b*sol, csr(w, idx), table)",
        library_max_abs_err=lib_err)


def check_round_step(torch, rf, state, ops):
    """round_step at the scenario path's shapes: the main path's state
    after ``WARM`` rounds and the next round's prefetched events, so that
    rows on their first receipt (start from theta_base) and rows past it
    (start from theta) are both held against the plain version."""
    theta, Ke, got_ever, theta_base, a_w = state
    msg, tgt_row, enc, k_old = ops

    def fresh():
        return theta.clone(), Ke.clone(), got_ever.clone()

    n, p = theta.shape
    k = Ke.shape[0] // n
    res = rf.round_step_resources(k, p)
    log(f"[3] round_step apply kernel for k={k}, p={p}: "
        f"{res['registers']} registers, {res['local_bytes']} bytes of "
        f"local memory a thread")

    got = rf.round_step(*fresh(), msg, tgt_row, enc, k_old, theta_base, a_w)
    want = rf.round_step_plain(*fresh(), msg, tgt_row, enc, k_old,
                               theta_base, a_w)
    if not (torch.equal(got[3], want[3]) and torch.equal(got[2], want[2])):
        raise AssertionError("round_step: keep/got_ever differ from the "
                             "plain version")
    err = max((got[0] - want[0]).abs().max().item(),
              (got[1] - want[1]).abs().max().item())
    keep = want[3]
    del got, want
    m = msg.shape[0]
    win_rows = tgt_row[keep].long()
    W = int(keep.sum())
    rows = torch.unique(win_rows)
    R = rows.numel()
    F = int((~got_ever[rows]).sum())
    if not 0 < F < R:
        raise AssertionError(f"round_step: {F} of {R} touched rows are "
                             f"first receipts; both branches must be held")
    # enc + tgt_row + keep per event; winners' msg, k_old, a_w and Ke row;
    # touched rows' theta (read unless first receipt) + write, theta_base
    # on first receipts, got_ever read + write
    n_bytes = (9 * m + W * (4 * 2 * p + 4 + 4 * (p + 1))
               + 4 * p * ((R - F) + R + F) + 2 * R)
    n_ops = 3 * W * p
    bms, by = bound_ms(n_bytes, n_ops)
    th, ke, ge = fresh()
    return dict(
        name="round_step", route="cuda",
        source="src/repro_torch/kernels/csrc/round_step.cu",
        replaces="src/repro/kernels/round_fuse.py:256",
        design="round-tagged 64-bit election words (no fill), 8 lanes "
               "an event, ballot leader, k <= 32 and p = 32 fixed at "
               "compile time",
        shape=f"n={n} k={k} p={p} m={m} winners={W} rows={R} first={F}",
        registers=res["registers"], local_bytes=res["local_bytes"],
        max_abs_err=err, tol=0.0,
        ms=time_ms(torch, lambda: rf.round_step(th, ke, ge, msg, tgt_row,
                                                enc, k_old, theta_base,
                                                a_w), 50),
        plain_ms=time_ms(torch, lambda: rf.round_step_plain(
            th, ke, ge, msg, tgt_row, enc, k_old, theta_base, a_w), 10),
        bound_ms=bms, bound_by=by, library_ms=None, library_call=None)


def cl_edge_bytes(upd, own_s, oth_a, oth_s, stale, got, k, p):
    """Bytes ``cl_edge_step`` must move on one round's sides, each counted
    once: every distinct theta row and every distinct (agent, slot) cell
    of K, L_own and L_nbr that a delivered side reads (its own, and its
    partner's where the payload is fresh), the four payload rows of every
    distinct stale target, every distinct target written in Z_own, Z_nbr,
    L_own and L_nbr; the four indices of each event (side b + B mirrors
    side b), each side's stale and got bytes, and one 4-byte election word
    written and read back per edge with a delivered side.  Returns
    ``(bytes, distinct targets)``."""
    import torch
    B = upd.shape[0] // 2
    u, o, a, s = upd.long(), own_s.long(), oth_a.long(), oth_s.long()
    tgt, ptn = u * k + o, a * k + s
    fresh = got & ~stale
    rows = torch.unique(torch.cat([u[got], a[fresh]])).numel()
    cells = torch.unique(torch.cat([tgt[got], ptn[fresh]])).numel()
    T = torch.unique(tgt[got]).numel()
    S = torch.unique(tgt[got & stale]).numel()
    any_got = got[:B] | got[B:]
    edges = torch.unique(torch.minimum(tgt[:B], ptn[:B])[any_got]).numel()
    n_bytes = (4 * p * (rows + 3 * cells + 4 * S + 4 * T) + 16 * B
               + 2 * upd.shape[0] + 8 * edges)
    return n_bytes, T


def check_cl_edge_step(torch, rf, args, rho):
    """cl_edge_step on round ``WARM`` of the CL run: the engine's own
    inputs (post-primal theta/K, round-start Z/L, the prefetched stale
    payload and the round's 2B sides), held bit for bit over two calls on
    the same state (the second on the first's output), with the kernel's
    election words all zero after each."""
    theta, K, *zl = args[:6]
    back = args[6:]
    upd, own_s, oth_a, oth_s, stale, got = back[4:]
    n, k, p = K.shape
    E = upd.shape[0]
    tgt = (upd.long() * k + own_s.long())[got]
    G = tgt.numel()
    dup = G - torch.unique(tgt).numel()
    n_stale = int((stale & got).sum())
    log(f"[3cl] cl_edge_step round {WARM}: {E} sides, {G} delivered, "
        f"{n_stale} of them stale, {dup} repeated targets")
    if not (dup > 0 and n_stale > 0):
        raise AssertionError("cl_edge_step: the held round needs stale "
                             "sides and repeated targets")

    za, zb = [a.clone() for a in zl], [a.clone() for a in zl]
    flags = rf.cl_edge_flags(n * k, theta.device)
    err = 0.0
    for call in (1, 2):
        out = rf.cl_edge_step(theta, K, *za, *back, rho=rho)
        want = rf.cl_edge_step_plain(theta, K, *zb, *back, rho=rho)
        err = max([err] + [(a - b).abs().max().item()
                           for a, b in zip(out, want)])
        left = int(torch.count_nonzero(flags))
        log(f"[3cl] cl_edge_step call {call}: max |kernel - plain| = "
            f"{err:.3g}, election words left nonzero: {left}")
        if left:
            raise AssertionError(f"cl_edge_step: {left} election words "
                                 f"nonzero after call {call}")
    del out, want
    n_bytes, T = cl_edge_bytes(upd, own_s, oth_a, oth_s, stale, got, k, p)
    bms, by = bound_ms(n_bytes, 16 * T * p)
    # the per-side count, reported beside the bound: every delivered side
    # charged its own four cells and the payload's four read and four
    # written, and 18 index and flag bytes, so shared cells count twice
    per_side_ms = bound_ms(G * 12 * p * 4 + E * 18, 16 * G * p)[0]
    return dict(
        name="cl_edge_step", route="cuda",
        source="src/repro_torch/kernels/csrc/cl_edge_step.cu",
        replaces="src/repro/kernels/round_fuse.py:419",
        design="warp per event, claim + atomicExch edge election, "
               "no scratch",
        shape=f"n={n} k={k} p={p} sides={E} delivered={G} "
              f"stale={n_stale} repeated={dup} targets={T}",
        max_abs_err=err, tol=0.0,
        ms=time_ms(torch, lambda: rf.cl_edge_step(theta, K, *za, *back,
                                                  rho=rho), 50),
        plain_ms=time_ms(torch, lambda: rf.cl_edge_step_plain(
            theta, K, *zb, *back, rho=rho), 10),
        bound_ms=bms, bound_by=by, bound_ms_per_side=per_side_ms,
        library_ms=None, library_call=None)


def edge_slabs(torch, tabs, st):
    """The eight (E, p) slabs of every undirected edge (i < j) of a sparse
    ADMM state, in ``admm_edge_update``'s order: i's and j's models and
    copies of each other, then i's and j's duals of the edge."""
    n, k = tabs.nbr_idx.shape
    ar = torch.arange(k, device=tabs.nbr_idx.device)
    live = ar[None, :] < tabs.deg_count[:, None]
    rows = torch.arange(n, device=tabs.nbr_idx.device)[:, None]
    i, s = torch.nonzero(live & (tabs.nbr_idx > rows), as_tuple=True)
    j, r = tabs.nbr_idx[i, s].long(), tabs.rev_slot[i, s].long()
    return (st.theta[i], st.K[j, r], st.theta[j], st.K[i, s],
            st.L_own[i, s], st.L_nbr[i, s], st.L_own[j, r], st.L_nbr[j, r])


def check_admm_edge(torch, au, slabs, rho):
    """admm_edge_update over every edge slab of the CL state at round
    ``WARM``."""
    E, p = slabs[0].shape
    out = au.admm_edge_update(*slabs, rho=rho)
    want = au.admm_edge_update_plain(*slabs, rho)
    err = max((a - b).abs().max().item() for a, b in zip(out, want))
    del out, want
    # eight inputs read once, six outputs written once; 22 operations
    # per element (two Z: add, divide, add, add, scale; four duals:
    # subtract, scale, add)
    bms, by = bound_ms(14 * E * p * 4, 22 * E * p)
    return dict(
        name="admm_edge_update", route="cuda",
        source="src/repro_torch/kernels/csrc/admm_edge.cu",
        replaces="src/repro/kernels/admm_update.py:21",
        design="grid-stride elementwise f32",
        shape=f"E={E} p={p}", max_abs_err=err, tol=0.0,
        ms=time_ms(torch, lambda: au.admm_edge_update(*slabs, rho=rho), 20),
        plain_ms=time_ms(torch, lambda: au.admm_edge_update_plain(*slabs,
                                                                  rho), 5),
        bound_ms=bms, bound_by=by, library_ms=None, library_call=None)


def flash_inputs(torch, case, seed):
    """Standard-normal q, k, v of one ``FA_CASES`` case, from the seed, on
    the card."""
    B, S, H, K, hd, window, dname = case
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    return tuple(torch.randn(shape, generator=g, device=DEVICE)
                 .to(getattr(torch, dname))
                 for shape in ((B, S, H, hd), (B, S, K, hd), (B, S, K, hd)))


def check_flash(torch, fa, case, seed):
    """flash_attention against its plain version on one case of
    ``FA_CASES`` (``flash_inputs``).  bf16 runs a wgmma kernel, which
    rounds the softmax weights to bf16 once per kv tile (128 keys at hd
    128, 80 at hd 256, 64 at hd 64) before P @ V (as the JAX oracle rounds
    them); the plain version keeps them in float32, so the two differ by
    about a bf16 ulp of the output: within 1e-2 abs and rel.  float32
    runs 3xTF32 on wgmma at every head dim (three TF32 passes, the bound
    those passes at the TF32 peak, the FFMA floor of the same work beside
    it; at hd 256 K and V stream through one ring in 32-hd pieces):
    within 1e-5.  The library call is
    SDPA on the kv heads repeated to H (a boolean mask for the window);
    for float32 the profiler names the kernel it ran.  ``ms`` times
    back-to-back calls, which at a small shape also reads the wrapper's
    host work; ``device_ms`` and ``host_us`` read the device and the host
    apart (``queued``), and ``host_kept_up`` says whether the host
    enqueued every call before the device reached them."""
    import torch.nn.functional as F
    B, S, H, K, hd, window, dname = case
    dtype = getattr(torch, dname)
    q, k, v = flash_inputs(torch, case, seed)
    got = fa.flash_attention(q, k, v, window=window)
    want = fa.flash_attention_plain(q, k, v, window=window)
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-5
    diff = (got.float() - want.float()).abs()
    excess = (diff - tol * want.float().abs()).max().item()
    err = diff.max().item()
    del got, want, diff
    W = S if window is None else min(window, S)
    pairs = W * (W + 1) // 2 + (S - W) * W      # live (query, key) pairs
    esize = q.element_size()
    n_bytes = esize * 2 * B * S * hd * (H + K)
    n_ops = 4 * B * H * hd * pairs
    if dtype == torch.bfloat16:
        bms, by = bound_ms(n_bytes, n_ops, BF16_FLOP_PER_S)
    else:
        bms, by = bound_ms(n_bytes, 3 * n_ops, TF32_FLOP_PER_S)
    qt = q.transpose(1, 2)
    kt = k.repeat_interleave(H // K, dim=2).transpose(1, 2)
    vt = v.repeat_interleave(H // K, dim=2).transpose(1, 2)
    mask = None
    if window is not None:
        pos = torch.arange(S, device=DEVICE)
        mask = (pos[None, :] <= pos[:, None]) \
            & (pos[None, :] > pos[:, None] - window)

    def sdpa():
        return F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=mask is None)

    def kernel():
        return fa.flash_attention(q, k, v, window=window)

    if dtype == torch.float32 and hd == 256:
        design = ("3xTF32 wgmma f32 (flash_fwd_3xtf32_pieces): Q's hi and "
                  "lo resident, K and V^T through one 5-stage ring of "
                  "64-key x 32-hd pieces that a producer warpgroup loads, "
                  "splits and transposes, one consumer warpgroup on 64 "
                  "queries, P's hi in registers and its lo in shared "
                  "memory, P V in 32-column parts")
    elif dtype == torch.float32:
        design = ("3xTF32 wgmma f32 (flash_fwd_3xtf32): a producer "
                  "warpgroup loads, splits and transposes into K and V "
                  f"rings of {1 if hd == 128 else 2} stage(s), one consumer "
                  "warpgroup on 64 queries, 64-key tiles, P V in 32-column "
                  "parts")
    elif hd == 128:
        design = "wgmma+TMA bf16, 128-key tiles, P in bf16"
    elif hd > 128:
        design = ("warp-specialised wgmma+TMA bf16: a producer warpgroup, "
                  "two consumer warpgroups in ping-pong, 80-key tiles, P in "
                  "bf16")
    else:
        design = ("warp-specialised wgmma+TMA bf16: two consumer warpgroups "
                  "splitting a 64-query tile's 64-key tiles, P in bf16")
    device_ms, host_us, kept_up = queued(torch, kernel, 10)
    plain_iters = 2 if S * H > 100_000 else 10
    rec = dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:31",
        design=design,
        shape=f"B={B} S={S} H={H} K={K} hd={hd} window={window} {dname}",
        max_abs_err=err, tol=tol, ok=excess <= tol,
        ms=time_ms(torch, kernel, 10),
        device_ms=device_ms, host_us=host_us, host_kept_up=kept_up,
        plain_ms=time_ms(torch, lambda: fa.flash_attention_plain(
            q, k, v, window=window), plain_iters, warmup=1),
        bound_ms=bms, bound_by=by,
        library_ms=time_ms(torch, sdpa, 10),
        library_device_ms=queued(torch, sdpa, 10)[0],
        library_call="F.scaled_dot_product_attention (kv heads repeated)")
    if dtype == torch.float32:
        rec["ffma_floor_ms"] = bound_ms(n_bytes, n_ops)[0]
        rec["library_kernels"] = device_kernel_names(
            torch, lambda: [sdpa() for _ in range(3)])
    return rec


def device_kernel_names(torch, run):
    """The names of the device kernels ``run()`` launches, from
    ``torch.profiler``'s raw events; "not measured" when it records no
    device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return sorted({ev.name for ev in prof.events()
                   if ev.device_type == DeviceType.CUDA}) or "not measured"


def f32_prefill_config(torch, arch, layers):
    """``arch``'s published config in float32 (``compute_dtype``) with
    ``attn_impl="flash"`` and its depth cut to ``layers``: a hybrid's
    ``pattern`` cut to its first ``layers`` entries."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    cut = dict(n_layers=layers)
    if cfg.pattern:
        cut["pattern"] = cfg.pattern[:layers]
    return dataclasses.replace(cfg, **cut, attn_impl="flash",
                               compute_dtype=torch.float32)


def check_prefill_f32(torch, dispatch, dev, rng, phase, arch, layers,
                      prompt):
    """6d, 6e (``F32_PREFILLS``).  ``arch`` at full width, depth cut to
    ``layers`` (``f32_prefill_config``), in float32, one ``prompt``-token
    prompt from ``rng`` prefilled through the ``attention`` op's ``cuda``
    implementation (a 3xTF32 kernel, once an attention layer) and its
    ``reference`` one with the same weights: last-position logits within
    ``F32_LOGIT_RTOL`` (relative L2).  Returns (the kernel path's
    ``flash_attention`` launches, an error or None)."""
    from repro_torch.models import Model
    f32 = f32_prefill_config(torch, arch, layers)
    n_attn = sum(kind.startswith("attn") for kind in f32.layer_kinds)
    model = Model(f32, device=dev).init(
        torch.Generator(device=dev).manual_seed(SEED))
    tok = torch.as_tensor(rng.integers(0, f32.vocab_size, prompt)[None],
                          device=dev)
    paths = {}
    for name, backend in (("cuda", None), ("reference",
                                           dispatch.ReproBackend.using(
                                               attention="reference"))):
        model.backend = backend
        torch.cuda.synchronize()
        dispatch.reset_launch_counts()
        t0 = time.perf_counter()
        logits, _ = model.prefill({"tokens": tok}, cache_len=prompt)
        torch.cuda.synchronize()
        paths[name] = (logits[0, 0], dispatch.launch_counts()[
            "flash_attention"], time.perf_counter() - t0)
    lk, lr = paths["cuda"][0], paths["reference"][0]
    rel = ((lk - lr).norm() / lr.norm()).item()
    log(json.dumps(dict(
        phase=phase, model=f32.name, layers=layers, prompt=prompt,
        attention_layers=n_attn, dtype="float32", logits_rel_l2=rel,
        tol=F32_LOGIT_RTOL,
        prefill_s={k: v[2] for k, v in paths.items()},
        launches={k: v[1] for k, v in paths.items()})))
    launches = paths["cuda"][1]
    if launches != n_attn or paths["reference"][1] != 0:
        return launches, (f"{phase} launches "
                          f"{[v[1] for v in paths.values()]}")
    if lk.shape != (f32.vocab_size,) or not torch.isfinite(lk).all() \
            or not rel <= F32_LOGIT_RTOL:
        return launches, (f"float32 kernel path logits {tuple(lk.shape)} "
                          f"off the reference path's by {rel} (relative L2 "
                          f"> {F32_LOGIT_RTOL}) or not finite")
    return launches, None


def check_serving(torch, np, dispatch, spec, fused_hist, fused_s, smi):
    """4k. ``run_scenario`` of 4a's fused MP run with a ``serve`` stream
    (``precompute_serve_stream(n, rounds, rate=SERVE_RATE)``, batch width
    SERVE_BATCH): theta_hist bit for bit 4a's, ``round_step`` once a
    round, every request served; requests/s (the service's seconds are the
    run's less 4a's fused run), the hit rate and the served staleness's
    p50 and p99.  Returns an error or None."""
    from repro_torch.simulate import (ScenarioSpec, precompute_serve_stream,
                                      run_scenario)
    sv = precompute_serve_stream(N_AGENTS, ROUNDS, rate=SERVE_RATE,
                                 seed=SEED)
    dispatch.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr = run_scenario(ScenarioSpec(**spec, backend=dispatch.ReproBackend(),
                                   serve=sv, serve_batch=SERVE_BATCH))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dispatch.launch_counts()["round_step"]
    same = torch.equal(tr.theta_hist, fused_hist)
    rep = tr.serve
    serve_s = secs - fused_s
    log(json.dumps(dict(
        phase="4k", serve_batch=SERVE_BATCH,
        run_s=secs, fused_run_s=fused_s, serve_s=serve_s,
        requests_per_s=rep.requests / serve_s if serve_s > 0 else None,
        theta_hist_bit_for_bit=same, round_step_launches=launches,
        **rep.summary(), device=smi)))
    if not same:
        return "4k: serving changed theta_hist"
    if launches != tr.rounds or rep.requests != sv.n_requests \
            or rep.hits + rep.misses != rep.requests:
        return (f"4k: {launches} round_step launches for {tr.rounds} "
                f"rounds, {rep.requests} of {sv.n_requests} requests "
                f"served, hits + misses {rep.hits + rep.misses}")
    return None


def check_graph_mix_agents(torch, gm, n, D, dtype, seed):
    """7a. graph_mix's agent-axis form (n <= 32, D > 8) at one coupling
    leaf's shape against its plain version: 1e-5 in float32; in bf16
    within ``gm.bf16_tolerance`` (one bf16 ulp of the plain result beyond
    the float32 sums' own error).  Bound: each input element read once
    and the output written once, ``(2 n D + n D) size + n^2 size + 4 n``
    bytes; the library call is ``torch.addmm(b*sol, A, theta)``."""
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    theta = torch.randn((n, D), generator=gen, device="cuda").to(dt)
    sol = torch.randn((n, D), generator=gen, device="cuda").to(dt)
    A = (torch.rand((n, n), generator=gen, device="cuda") / n).to(dt)
    b = torch.rand((n,), generator=gen, device="cuda")
    got = gm.graph_mix(theta, sol, A, b)
    want = gm.graph_mix_plain(theta, sol, A, b)
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    if dtype == "float32":
        tol, ok = 1e-5, err <= 1e-5
    else:
        tol = "bf16_tolerance"
        ok = bool((diff <= gm.bf16_tolerance(theta, sol, A, b)).all())
    del want, diff
    size = theta.element_size()
    bms, by = bound_ms(3 * n * D * size + n * n * size + 4 * n,
                       2 * n * n * D + 2 * n * D)
    iters = 5 if n * D > 1e9 else 20
    ms = time_ms(torch, lambda: gm.graph_mix(theta, sol, A, b), iters)
    plain_ms = time_ms(torch, lambda: gm.graph_mix_plain(theta, sol, A, b),
                       iters)
    bsol = (b[:, None] * sol).to(dt)
    lib_ms = time_ms(torch, lambda: torch.addmm(bsol, A, theta), iters)
    return dict(
        name="graph_mix (agent axis)", route="cuda",
        source="src/repro_torch/kernels/csrc/graph_mix.cu",
        replaces="src/repro/kernels/graph_mix.py:28",
        design="A and b in shared memory, theta and sol streamed once in "
               "16-byte chunks, FFMA over j ascending, float32 or bf16",
        shape=f"n={n} D={D} {dtype}", max_abs_err=err, tol=tol, ok=ok,
        replay_bit_for_bit=torch.equal(got, gm.graph_mix(theta, sol, A, b)),
        ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
        library_ms=lib_ms, library_call="torch.addmm(b*sol, A, theta)")


def lm_batches(np, lm_cfg, graph, n_batches, agents, batch, seq):
    """``n_batches`` training batches of the personalized token stream,
    each ``{"tokens", "labels"}`` of (agents * batch, seq)."""
    from repro_torch.data import make_lm_batches
    return [{"tokens": r[..., :-1].reshape(agents * batch, seq),
             "labels": r[..., 1:].reshape(agents * batch, seq)}
            for r in make_lm_batches(lm_cfg, graph, n_batches)]


def leaf_sample(torch, state):
    """A few of the parameters on the host: the norms and a corner of the
    head (enough to tell two runs apart)."""
    p = state.params
    return [p["final_norm"].cpu(), p["groups"][0]["b0"]["norm1"].cpu(),
            p["unembed"][:, :64, :64].cpu()]


def check_train_llama(torch, np, dispatch, dev, smi):
    """7b. Llama-3-8B at full width (depth cut to TRAIN_LAYERS), one
    agent-stacked model per agent on a ring, mp coupling every step
    through ``train_loop``: the loss falls over TRAIN_STEPS steps,
    ``graph_mix`` launches leaves x steps, the agents' parameters after
    one step differ from a ``mode="none"`` step from the same state;
    tokens/s, ms a step, a step's split by phase (CUDA events) and the
    peak device memory.  Returns ``(record, launches, error)``."""
    from repro_torch.configs import get_config
    from repro_torch.core.graph import ring_graph
    from repro_torch.coupling import CouplingConfig, make_state
    from repro_torch.data import PersonalizedLMConfig
    from repro_torch.models import Model
    from repro_torch.train import (TrainConfig, init_train_state,
                                   make_train_step, train_loop)
    from repro_torch.tree import tree_leaves
    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=TRAIN_LAYERS)
    model = Model(cfg, device="meta")
    A = TRAIN_AGENTS
    graph = ring_graph(A)
    batches = lm_batches(np, PersonalizedLMConfig(
        vocab_size=STREAM_VOCAB, n_agents=A, seq_len=TRAIN_SEQ,
        batch_per_agent=TRAIN_BATCH, seed=SEED), graph, TRAIN_STEPS + 1,
        A, TRAIN_BATCH, TRAIN_SEQ)
    cstate = make_state(graph, device=dev)
    tcfg = {mode: TrainConfig(n_agents=A, steps=TRAIN_STEPS, log_every=1,
                              coupling=CouplingConfig(mode=mode, alpha=0.99,
                                                      every=1))
            for mode in ("none", "mp")}

    def fresh():
        return init_train_state(model, tcfg["mp"], torch.Generator(
            device=dev).manual_seed(SEED), device=dev)

    quiet = []
    # one solitary step from the seed's state, a sample of it kept
    state = fresh()
    n_params = sum(leaf[0].numel() for leaf in tree_leaves(state.params))
    state, _ = make_train_step(model, tcfg["none"], cstate)(state,
                                                            batches[0])
    solo = leaf_sample(torch, state)
    del state
    torch.cuda.empty_cache()
    # the mp run from the same state: step 0, then steps 1 .. 4 timed
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    state = fresh()
    dispatch.reset_launch_counts()
    state, hist = train_loop(model, tcfg["mp"], cstate, batches[:1],
                             state=state, log=quiet.append)
    coupled = leaf_sample(torch, state)
    differ = any(not torch.equal(a, b) for a, b in zip(coupled, solo))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, more = train_loop(model, tcfg["mp"], cstate,
                             batches[1:TRAIN_STEPS], state=state,
                             log=quiet.append)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dispatch.launch_counts()["graph_mix"]
    peak = torch.cuda.max_memory_allocated()
    losses = [h["loss"] for h in hist + more]
    # one more step, split by phase
    marks = {}

    def mark(name):
        marks[name] = torch.cuda.Event(enable_timing=True)
        marks[name].record()
    start = torch.cuda.Event(enable_timing=True)
    start.record()
    make_train_step(model, tcfg["mp"], cstate)(state, batches[TRAIN_STEPS],
                                               mark=mark)
    torch.cuda.synchronize()
    split, prev = {}, start
    for name, ev in marks.items():
        split[name] = prev.elapsed_time(ev)
        prev = ev
    # and one under the profiler: device time by kernel (a reading)
    wall_ms, busy_ms, rows = profile_device(torch, lambda: make_train_step(
        model, tcfg["mp"], cstate)(state, batches[TRAIN_STEPS]))
    if busy_ms > 0:
        log(f"[7b] one step under the profiler: wall {wall_ms:.3f} ms, "
            f"device busy {busy_ms:.3f} ms "
            f"({100 * busy_ms / wall_ms:.1f} %)")
        for ms, key, count in rows[:16]:
            log(f"[7b]   {ms:9.3f} ms  {count:6d} x  {key[:100]}")
    else:
        log("[7b] the profiler recorded no device time: not measured")
    n_leaves = len(tree_leaves(state.params))
    del state
    torch.cuda.empty_cache()
    steps_timed = TRAIN_STEPS - 1
    tokens = A * TRAIN_BATCH * TRAIN_SEQ
    rec = dict(
        phase="7b", model=cfg.name, n_layers=cfg.n_layers,
        params_per_agent=n_params, agents=A, graph="ring_graph(2)",
        coupling="mp alpha=0.99 every=1", batch_per_agent=TRAIN_BATCH,
        seq=TRAIN_SEQ, stream_vocab=STREAM_VOCAB, steps=TRAIN_STEPS,
        losses=losses, tokens_per_step=tokens,
        tokens_per_s=steps_timed * tokens / secs,
        ms_per_step=secs * 1e3 / steps_timed, step_split_ms=split,
        max_memory_allocated=peak, allocated_before=before,
        graph_mix_launches=launches,
        leaves=n_leaves, differs_from_none=differ, device=smi)
    bad = None
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        bad = f"7b: losses {losses} not finite or not falling"
    elif launches != n_leaves * TRAIN_STEPS:
        bad = (f"7b: graph_mix launched {launches} times, not {n_leaves} "
               f"leaves x {TRAIN_STEPS} steps")
    elif not differ:
        bad = "7b: the mp step left the parameters of a mode='none' step"
    return rec, launches, bad


def load_module(path: pathlib.Path):
    """The script at ``path`` (an example or a tool) as a module."""
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_example():
    """The repo's example, ``examples/personalized_lm_torch.py``, as a
    module (7c runs its own ``run``)."""
    return load_module(EXAMPLE)


def scalar_figures(figures):
    """The scalars of an example's returned figures (its arrays, vectors
    and run-directory paths left out), for one JSON line."""
    out = {}
    for key, val in figures.items():
        if isinstance(val, dict) and key != "runs":
            out[str(key)] = scalar_figures(val)
        elif val is None or isinstance(val, (bool, int, float)):
            out[str(key)] = val
    return out


def example_theta_star_err(torch, dispatch, mod, figures):
    """max |theta* - plain| for network_sim_demo: its ``sparse_sync_mp``
    fixed point (``sparse_gather_mix`` on the card) against the reference
    backend's on the example's own problem, rebuilt from its seed."""
    from repro_torch.simulate import sparse_sync_mp
    topo, theta_sol, c = mod.problem(figures["n"], figures["p"],
                                     figures["seed"])
    plain = sparse_sync_mp(topo, theta_sol, c, figures["alpha"], mod.SWEEPS,
                           backend=dispatch.ReproBackend(default="reference"),
                           device="cuda")
    got = torch.as_tensor(figures["theta_star"])
    return (got - plain.cpu()).abs().max().item()


def serving_failure(name, figures, launches):
    """What is wrong with a serving demo's run in phase 11, or None: a
    kernel launched (neither demo's path has one, so no plain version is
    held against it here), serve_demo's tick budget exhausted or a
    request's token count other than ``SERVE_DEMO_TOKENS``,
    collab_serve_demo's trajectory other with serving on than off."""
    if launches:
        return (f"launched {launches}; its path has no kernel and no plain "
                f"version to hold one against")
    if name == "serve_demo":
        if figures["exhausted"]:
            return "the engine ran out of ticks"
        counts = figures["tokens_by_request"]
        if set(counts.values()) != {SERVE_DEMO_TOKENS}:
            return f"tokens by request {counts}, not {SERVE_DEMO_TOKENS} each"
    elif not figures["identical"]:
        return "theta_hist differs with serving on and off"
    return None


def check_examples(torch, dispatch, smi):
    """11. Each simulator example's ``main`` in process on the card at its
    default size (``EXAMPLE_PHASES``), the launch counts set to 0 just
    before and read just after: the figures it returns, its wall seconds
    and its launches by kernel.  Fails if an example's own assertion
    fails, if a kernel's output in an example differs from its plain
    version's on the same inputs by more than ``EXAMPLE_CUDA_TOL``
    (quickstart's ``synchronous`` rows form and ``run_mp_sweep`` trial
    axis, ``graph_mix``; network_sim_demo's theta*, ``sparse_gather_mix``
    at p = 16), if an example launches none of the kernels its
    path should launch, or if ``tools/trace_report_torch.py`` does not
    render the run directories the ``--out`` examples write; or if a
    serving demo launches a kernel, exhausts its ticks, decodes other than
    ``SERVE_DEMO_TOKENS`` tokens a request, or its trajectory differs
    with serving on (``serving_failure``).  Returns
    ``(records, launches summed over the examples, failure or None)``."""
    recs, total = [], {}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-examples-") as tmp:
        for name, expect in EXAMPLE_PHASES:
            mod = load_module(ROOT / "examples" / f"{name}_torch.py")
            argv = []                          # default size, on the card
            if name in EXAMPLE_RUN_DIRS:
                argv = ["--out", os.path.join(tmp, name)]
            dispatch.reset_launch_counts()
            t0 = time.perf_counter()
            try:
                figures = mod.main(argv)
            except AssertionError as e:
                return recs, total, f"11 {name}: its assertion failed: {e!r}"
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {k: v for k, v in dispatch.launch_counts().items()
                        if v}
            for k, v in launches.items():
                total[k] = total.get(k, 0) + v
            # each kernel output of the example against its plain version
            # on the same inputs (plain runs launch nothing)
            checks = {}
            if name == "quickstart":
                checks = {k: figures["backends"][k] for k in (
                    "cuda_vs_reference", "sweep_cuda_vs_reference")}
            if name == "network_sim_demo":
                checks["theta_star_cuda_vs_reference"] = \
                    example_theta_star_err(torch, dispatch, mod, figures)
            rec = dict(phase="11", example=name, wall_s=wall,
                       launches=launches, expected=list(expect),
                       cuda_vs_reference=checks, tol=EXAMPLE_CUDA_TOL,
                       figures=scalar_figures(figures), device=smi)
            if name in EXAMPLE_RUN_DIRS:
                dirs = list(figures["runs"].values())
                res = subprocess.run(
                    [sys.executable, str(ROOT / "tools" /
                                         "trace_report_torch.py"), *dirs],
                    capture_output=True, text=True, timeout=120)
                rec["trace_report"] = dict(run_dirs=len(dirs),
                                           rc=res.returncode,
                                           lines=len(res.stdout.splitlines()))
            recs.append(rec)
            log(json.dumps(rec))
            if name in SERVING_DEMOS:
                bad = serving_failure(name, figures, launches)
                if bad:
                    return recs, total, f"11 {name}: {bad}"
            missing = [k for k in expect if not launches.get(k)]
            if missing:
                return recs, total, (f"11 {name}: launched no {missing} "
                                     f"(launches {launches})")
            for key, err in checks.items():
                if err is None or not err <= EXAMPLE_CUDA_TOL:
                    return recs, total, (f"11 {name}: {key} = {err} over "
                                         f"{EXAMPLE_CUDA_TOL}")
            if name in EXAMPLE_RUN_DIRS and res.returncode != 0:
                return recs, total, (f"11 {name}: trace_report_torch.py "
                                     f"exited {res.returncode}: "
                                     f"{res.stderr[-2000:]}")
    return recs, total, None


def check_train_modes(torch, np, dispatch, dev, smi):
    """7c. The example's plm-100m on 8 agents, every coupling mode for
    PLM_STEPS steps from one state (seed SEED's, made before the clock
    starts), through the example's own ``run``:
    the loss falls in each; consensus leaves the agents equal within 1e-6
    right after a coupled step; mp launches ``graph_mix`` leaves x
    ceil(steps / every) times; the mp state's checkpoint round-trips bit
    for bit.  Returns ``(record, mp launches, error)``."""
    import tempfile
    from repro_torch.core.graph import random_geometric_graph
    from repro_torch.data import PersonalizedLMConfig
    from repro_torch.models import Model
    from repro_torch.train import (init_train_state, load_checkpoint,
                                   save_checkpoint)
    from repro_torch.tree import tree_leaves
    example = load_example()
    cfg = example.model_config(PLM_TINY)
    model = Model(cfg, device="meta")
    A = PLM_AGENTS
    graph = random_geometric_graph(A, k=3, seed=0)
    batches = lm_batches(np, PersonalizedLMConfig(
        vocab_size=STREAM_VOCAB, n_agents=A, seq_len=PLM_SEQ,
        batch_per_agent=PLM_BATCH, seed=SEED), graph, PLM_STEPS, A,
        PLM_BATCH, PLM_SEQ)
    args = argparse.Namespace(agents=A, steps=PLM_STEPS, batch=PLM_BATCH,
                              seq=PLM_SEQ, ckpt="", device=dev)
    assert example.train_config("mp", args).coupling.every == PLM_EVERY
    rec = dict(phase="7c", model=cfg.name, agents=A,
               graph="random_geometric_graph(8, k=3, seed=0)",
               batch_per_agent=PLM_BATCH, seq=PLM_SEQ, steps=PLM_STEPS,
               every=PLM_EVERY, modes={}, device=smi)
    quiet, mp_launches, bad = [], 0, None
    last_mix = (PLM_STEPS - 1) // PLM_EVERY * PLM_EVERY
    for mode in PLM_MODES:
        # the initial state is set-up, made before the clock starts
        state = init_train_state(
            model, example.train_config(mode, args, log_every=1),
            torch.Generator(device=dev).manual_seed(SEED), device=dev)
        dispatch.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        # through the last coupled step, then the rest
        _, _, state, h1 = example.run(mode, args, graph,
                                      batches[:last_mix + 1], model,
                                      state=state, log=quiet.append,
                                      log_every=1)
        spread = max((leaf - leaf[:1]).abs().max().item()
                     for leaf in tree_leaves(state.params))
        _, _, state, h2 = example.run(mode, args, graph,
                                      batches[last_mix + 1:], model,
                                      state=state, log=quiet.append,
                                      log_every=1)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = dispatch.launch_counts()["graph_mix"]
        losses = [h["loss"] for h in h1 + h2]
        rec["modes"][mode] = dict(
            first_loss=losses[0], last_loss=losses[-1],
            tokens_per_s=PLM_STEPS * A * PLM_BATCH * PLM_SEQ / secs,
            ms_per_step=secs * 1e3 / PLM_STEPS, graph_mix_launches=launches,
            agent_spread_after_last_mix=spread)
        n_leaves = len(tree_leaves(state.params))
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            bad = bad or f"7c {mode}: losses {losses} not falling"
        if mode == "consensus" and not spread <= 1e-6:
            bad = bad or f"7c consensus: agents differ by {spread}"
        if mode == "mp":
            mp_launches = launches
            want = n_leaves * -(-PLM_STEPS // PLM_EVERY)
            if launches != want:
                bad = bad or f"7c mp: {launches} graph_mix launches, not {want}"
            with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
                t0 = time.perf_counter()
                save_checkpoint(state, d, PLM_STEPS)
                back, step = load_checkpoint(state, d)
                same = step == PLM_STEPS and all(
                    a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(
                        tree_leaves((back.params, back.opt_state,
                                     back.solitary, back.step)),
                        tree_leaves((state.params, state.opt_state,
                                     state.solitary, state.step))))
                rec["checkpoint_s"] = time.perf_counter() - t0
            rec["checkpoint_bit_for_bit"] = same
            del back
            if not same:
                bad = bad or "7c: the mp checkpoint did not round-trip"
        elif launches:
            bad = bad or f"7c {mode}: graph_mix launched {launches} times"
        del state
        torch.cuda.empty_cache()
    return rec, mp_launches, bad


def run_dryrun(*flags):
    """``python -m repro_torch.launch.dryrun`` with ``flags`` in a process
    of its own (the fake process group it sets up is that process's), its
    record read back from a file under ``build/``.  Returns ``(record or
    None, wall seconds, error or None)``."""
    import tempfile
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        out = pathlib.Path(d) / "dryrun.json"
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.dryrun", *flags,
                 "--out", str(out)], env=env, capture_output=True,
                text=True, timeout=DRY_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            return None, time.perf_counter() - t0, \
                f"dry run {flags} past {DRY_TIMEOUT_S} s"
        wall = time.perf_counter() - t0
        if proc.returncode != 0 or not out.exists():
            return None, wall, (f"dry run {flags} failed (rc "
                                f"{proc.returncode}): {proc.stdout[-1500:]}"
                                f"{proc.stderr[-1500:]}")
        rec = json.loads(out.read_text())[-1]
    return rec, wall, None if rec.get("ok") else f"dry run: {rec}"


def check_dryrun_card(torch, np, dispatch, dev, smi):
    """10a. 7b's configuration at one agent on the card (Llama-3-8B cut to
    TRAIN_LAYERS layers, batch TRAIN_BATCH at TRAIN_SEQ, mp coupling,
    DRY_STEPS steps of ``make_train_step``): peak device memory above what
    was allocated before the state and the steps' times; then the dry run
    of the same configuration on a 1 x 1 mesh: its predicted peak within
    DRY_PEAK_RTOL of the measured one.  Returns ``(record, error)``."""
    from repro_torch.configs import get_config
    from repro_torch.core.graph import ring_graph
    from repro_torch.coupling import CouplingConfig
    from repro_torch.data import PersonalizedLMConfig
    from repro_torch.launch.dryrun import coupling_state
    from repro_torch.models import Model
    from repro_torch.train import (TrainConfig, init_train_state,
                                   make_train_step)
    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=TRAIN_LAYERS)
    model = Model(cfg, device="meta")
    # 7b's stream on its ring of two; this agent takes the first agent's
    # rows
    batches = [{k: v[:TRAIN_BATCH] for k, v in b.items()}
               for b in lm_batches(np, PersonalizedLMConfig(
                   vocab_size=STREAM_VOCAB, n_agents=2, seq_len=TRAIN_SEQ,
                   batch_per_agent=TRAIN_BATCH, seed=SEED), ring_graph(2),
                   DRY_STEPS, 2, TRAIN_BATCH, TRAIN_SEQ)]
    tcfg = TrainConfig(n_agents=1, steps=DRY_STEPS, log_every=1,
                       coupling=CouplingConfig(mode="mp", alpha=0.99,
                                               every=1))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(model, tcfg, torch.Generator(
        device=dev).manual_seed(SEED), device=dev)
    step = make_train_step(model, tcfg, coupling_state(1, 0.99, dev))
    dispatch.reset_launch_counts()
    secs, losses = [], []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, b)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
    peak = torch.cuda.max_memory_allocated() - before
    held = torch.cuda.memory_allocated() - before
    launches = dispatch.launch_counts()["graph_mix"]
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    dry, wall, bad = run_dryrun(
        "--arch", LM_ARCH, "--shape", "train_4k", "--mesh", "1x1",
        "--layers", str(TRAIN_LAYERS), "--seq", str(TRAIN_SEQ), "--batch",
        str(TRAIN_BATCH), "--coupling", "mp", "--schedule", "dense",
        "--tag", "10a")
    rec = dict(phase="10a", model=cfg.name, n_layers=cfg.n_layers,
               agents=1, batch=TRAIN_BATCH, seq=TRAIN_SEQ, steps=DRY_STEPS,
               losses=losses, step_s=secs,
               measured_peak_bytes=peak, measured_held_bytes=held,
               graph_mix_launches=launches, dryrun_wall_s=wall, device=smi)
    if bad:
        return rec, bad
    pred = dry["peak_size_in_bytes"]
    rec.update(predicted_peak_bytes=pred,
               predicted_argument_bytes=dry["argument_size_in_bytes"],
               predicted_temp_bytes=dry["temp_size_in_bytes"],
               predicted_matmul_flops=dry["cost_flops"],
               predicted_cost_bytes=dry["cost_bytes"],
               predicted_roofline=dry["roofline"],
               traced_with=dry["traced_with"],
               peak_rel_diff=(pred - peak) / peak,
               matmul_flops_per_s_measured=dry["cost_flops"]
               / min(secs[1:] or secs))
    if not all(np.isfinite(losses)):
        return rec, f"10a: losses {losses} not finite"
    if launches != DRY_STEPS * 12:
        return rec, (f"10a: graph_mix launched {launches} times, not 12 "
                     f"leaves x {DRY_STEPS} steps")
    if abs(pred - peak) > DRY_PEAK_RTOL * peak:
        return rec, (f"10a: the dry run predicts a peak of {pred} bytes, "
                     f"the card measured {peak}: more than "
                     f"{DRY_PEAK_RTOL:.0%} apart")
    return rec, None


def check_dryrun_mesh(smi):
    """10b. ``llama3_8b x train_4k`` on the 16 x 16 production mesh with
    the gossip schedule: the record, its wall seconds and collectives;
    the agents exchange point to point and never all-gather.  Returns
    ``(record, error)``."""
    dry, wall, bad = run_dryrun("--arch", "llama3_8b", "--shape",
                                "train_4k", "--schedule", "gossip",
                                "--tag", "10b")
    if bad:
        return dict(phase="10b", process_wall_s=wall, device=smi), bad
    rec = dict(phase="10b", process_wall_s=wall, device=smi, **dry)
    agents = dry["collectives_by_axis"].get("agents", {})
    if not agents.get("collective-permute"):
        return rec, "10b: gossip recorded no point-to-point exchange"
    if agents.get("all-gather"):
        return rec, (f"10b: gossip all-gathered across the agents "
                     f"{agents['all-gather']} times")
    return rec, None


def rel_l2(torch, got, want) -> float:
    got, want = got.float(), want.float()
    return ((got - want).norm() / want.norm()).item()


def family_batch(torch, np, cfg, S, dev):
    """8b/8e/8f: one sequence of S positions in all.  Text: uniform
    tokens.  VLM: 0.02 * normal patch
    embeddings with M-RoPE ids on a VLM_GRID x VLM_GRID grid (t = 0),
    then text tokens whose ids continue from the grid's largest + 1 on all
    three planes.  Audio: 0.02 * normal conditioning embeddings, then
    uniform codes of every codebook in MusicGen's delay pattern (the pad
    is the last id: the config has no row of its own for one)."""
    from repro_torch.data import delay_pattern
    rng = np.random.default_rng(SEED + 8)
    g = torch.Generator(device=dev).manual_seed(SEED + 8)
    d, V = cfg.d_model, cfg.vocab_size
    if cfg.family not in ("vlm", "audio"):
        return {"tokens": torch.as_tensor(rng.integers(0, V, (1, S)),
                                          device=dev)}
    if cfg.family == "vlm":
        n = cfg.n_media_tokens
        p3 = np.zeros((3, 1, S), np.int64)
        p3[1, 0, :n] = np.arange(n) // VLM_GRID
        p3[2, 0, :n] = np.arange(n) % VLM_GRID
        p3[:, 0, n:] = np.arange(S - n) + VLM_GRID
        return {"tokens": torch.as_tensor(rng.integers(0, V, (1, S - n)),
                                          device=dev),
                "patch_embeds": 0.02 * torch.randn(
                    (1, n, d), generator=g, device=dev).to(cfg.compute_dtype),
                "positions3": torch.as_tensor(p3, device=dev)}
    n, K = cfg.n_cond_tokens, cfg.n_codebooks
    codes = rng.integers(0, V - 1, (1, K, S - n - K + 1))
    return {"tokens": torch.as_tensor(delay_pattern(codes, V - 1),
                                      device=dev),
            "cond_embeds": 0.02 * torch.randn(
                (1, n, d), generator=g, device=dev).to(cfg.compute_dtype)}


def check_mlstm_forms(torch, dev, cfg, batch):
    """8d: the mLSTM's ``parallel`` and ``scan`` forms layer by layer, in
    a float32 copy of the model (weights from the same seed) on the last
    prompt: at each layer of XLSTM_CHECK_LAYERS both forms take that
    layer's own input from the ``parallel`` run, and their outputs and
    final states are compared: relative L2 of the output, C and n, the
    largest absolute difference of the log-domain stabilizer m (the
    worst of these is reported).  Layer
    by layer, because through the 48 layers any two roundings part ways:
    the whole model's logits read 0.33 apart in bf16 and 1.1e-3 in
    float32."""
    from repro_torch.models import Model
    from repro_torch.models.blocks import (Ctx, block_apply_seq,
                                           mlstm_apply_seq)
    from repro_torch.models.common import rms_norm
    f32 = dataclasses.replace(cfg, compute_dtype=torch.float32,
                              mlstm_impl="parallel")
    scan = dataclasses.replace(f32, mlstm_impl="scan")
    model = Model(f32, device=dev).init(
        torch.Generator(device=dev).manual_seed(SEED))
    x = model.embed[batch["tokens"].long()]
    S = x.shape[1]
    ctx = Ctx(positions=torch.arange(S, device=dev)[None], window="auto",
              cache_len=1)
    errs = {}
    with torch.no_grad():
        for i, layer in enumerate(model.layers):
            if i in XLSTM_CHECK_LAYERS:
                assert layer.kind == "mlstm", (i, layer.kind)
                h = rms_norm(x, layer.norm1)
                ya, ca = mlstm_apply_seq(f32, "mlstm", layer.mixer, h, ctx)
                yb, cb = mlstm_apply_seq(scan, "mlstm", layer.mixer, h, ctx)
                errs[i] = [rel_l2(torch, ya, yb),
                           rel_l2(torch, ca["C"], cb["C"]),
                           rel_l2(torch, ca["n"], cb["n"]),
                           (ca["m"] - cb["m"]).abs().max().item()]
            x, _, _ = block_apply_seq(f32, layer.kind, layer, x, ctx)
    del model, x
    gc.collect()
    torch.cuda.empty_cache()
    flat = [e for v in errs.values() for e in v]
    # a NaN anywhere is the worst reading (max() would pass it over)
    worst = max(flat) if all(e == e for e in flat) else float("nan")
    return dict(mlstm_forms_err=worst, mlstm_forms_by_layer=errs,
                mlstm_forms_tol=XLSTM_FORMS_RTOL)


def check_family(torch, np, dispatch, dev, smi, phase, arch, depth, kind,
                 traffic):
    """One of 8a-8f: ``arch`` at its published width (depth cut to
    ``depth`` where given), random bf16 weights from the seed and
    ``attn_impl="flash"``, driven through ``Engine`` (kind "engine") or
    ``Model.prefill`` and FAMILY_NEW greedy ``decode_step``s ("prefill"),
    the launch counts set to 0 just before and read just after.  Checks:
    every request finishes in the vocab with finite logits;
    ``flash_attention`` launched once per attention layer a prefill; the
    last prefill's logits within LM_LOGIT_RTOL (relative L2) of the same
    model with ``attn_impl="chunked"`` (MoE: with the kernel path's expert
    ids replayed in the chunked path); MoE: the ``gather`` form's
    logits equal to ``scatter``'s bit for bit on one MOE_CHECK_PROMPT-token
    prefill; xLSTM (no attention, so the chunked path is the same
    computation): its ``parallel`` and ``scan`` mLSTM in float32 within
    XLSTM_FORMS_RTOL layer by layer (``check_mlstm_forms``).  Returns
    (record, launches, error or None)."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model, blocks
    from repro_torch.serve import Engine, ServeConfig
    cfg = dataclasses.replace(get_config(arch), attn_impl="flash")
    if depth:
        cfg = dataclasses.replace(cfg, n_layers=depth)
    t0 = time.perf_counter()
    model = Model(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_attn = sum(k.startswith("attn") for k in cfg.layer_kinds)
    rec = dict(phase=phase, model=cfg.name, family=cfg.family,
               n_layers=cfg.n_layers, published_layers=get_config(arch)
               .n_layers, d_model=cfg.d_model, head_dim=cfg.hd,
               params=model.param_count(), init_s=init_s)
    st = dict(prefill_s=0.0, prefill_tok=0, decode_s=0.0, decode_tok=0)
    last = {}

    def timed(fn, secs, count, n):
        def run(*args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            st[secs] += time.perf_counter() - t
            st[count] += n(*args)
            return out
        return run

    def greedy(logits):
        return torch.argmax(logits, dim=-1)

    if kind == "engine":
        prompts = [np.random.default_rng(SEED + len(phase) + i).integers(
            0, cfg.vocab_size, n) for i, n in enumerate(traffic)]
        cache_len = max(traffic) + FAMILY_NEW
        model.prefill({"tokens": torch.as_tensor(prompts[0][None],
                                                 device=dev)},
                      cache_len=cache_len)                    # warm-up
        eng = Engine(model, ServeConfig(batch_size=FAMILY_SLOTS,
                                        cache_len=cache_len,
                                        max_new_tokens=FAMILY_NEW))
        prefill_one = timed(eng._prefill_one, "prefill_s", "prefill_tok",
                            lambda tokens: tokens.shape[1])

        def keep_last(tokens):
            last["batch"] = {"tokens": tokens}
            last["logits"], cache = prefill_one(tokens)
            return last["logits"], cache
        eng._prefill_one = keep_last
        eng._decode = timed(eng._decode, "decode_s", "decode_tok",
                            lambda tok: 0)
        rids = [eng.submit(p) for p in prompts]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        dispatch.reset_launch_counts()
        t0 = time.perf_counter()
        results = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dispatch.launch_counts()["flash_attention"]
        st["decode_tok"] = sum(len(results.get(r, [])) - 1 for r in rids)
        n_prefills = len(prompts)
        rec.update(prompts=list(traffic), slots=FAMILY_SLOTS,
                   cache_len=cache_len)
        bad = None
        if eng.exhausted or sorted(results) != sorted(rids) or any(
                len(results[r]) != FAMILY_NEW for r in rids):
            bad = (f"exhausted={eng.exhausted}, lengths "
                   f"{[len(results.get(r, [])) for r in rids]}")
        elif not all(0 <= t < cfg.vocab_size for r in rids
                     for t in results[r]):
            bad = "a token outside the vocab"
        del eng
    else:
        batch = family_batch(torch, np, cfg, traffic, dev)
        cache_len = traffic + FAMILY_NEW
        model.prefill(batch, cache_len=cache_len)               # warm-up
        prefill = timed(model.prefill, "prefill_s", "prefill_tok",
                        lambda b, cache_len: traffic)
        decode = timed(model.decode_step, "decode_s", "decode_tok",
                       lambda c, b: b["token"].numel() // (
                           cfg.n_codebooks if cfg.family == "audio" else 1))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        dispatch.reset_launch_counts()
        t0 = time.perf_counter()
        logits, cache = prefill(batch, cache_len)
        tok = greedy(logits[..., -1, :])
        finite = bool(torch.isfinite(logits).all())
        for _ in range(FAMILY_NEW):
            step, cache = decode(cache, {"token": tok})
            finite &= bool(torch.isfinite(step).all())
            tok = greedy(step)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dispatch.launch_counts()["flash_attention"]
        last.update(batch=batch, logits=logits)
        n_prefills = 1
        want_shape = (1, cfg.n_codebooks, 1, cfg.vocab_size) \
            if cfg.family == "audio" else (1, 1, cfg.vocab_size)
        rec.update(positions=traffic, cache_len=cache_len,
                   pos_after=int(cache["pos"][0]))
        bad = None
        if not finite or tuple(logits.shape) != want_shape \
                or int(cache["pos"][0]) != traffic + FAMILY_NEW:
            bad = (f"logits {tuple(logits.shape)} finite={finite}, "
                   f"pos {int(cache['pos'][0])}")
        del cache, step
    peak = torch.cuda.max_memory_allocated()
    rec.update(wall_s=wall, prefill_s=st["prefill_s"],
               prefill_tokens=st["prefill_tok"],
               prefill_tokens_per_s=st["prefill_tok"] / st["prefill_s"],
               decode_s=st["decode_s"], decode_tokens=st["decode_tok"],
               decode_tokens_per_s=st["decode_tok"] / st["decode_s"],
               max_memory_allocated=peak, flash_attention_launches=launches,
               want_launches=n_attn * n_prefills, device=smi)
    if bad is None and launches != n_attn * n_prefills:
        bad = (f"flash_attention launched {launches} times, not {n_attn} "
               f"attention layers x {n_prefills} prefills")

    # the last prefill against the reference attention path
    model.cfg = dataclasses.replace(cfg, attn_impl="chunked")
    ref, _ = model.prefill(last["batch"], cache_len=cache_len)
    rel = rel_l2(torch, last["logits"][..., -1, :], ref[..., -1, :])
    rec.update(check="attn_impl chunked", logits_rel_l2=rel,
               tol=LM_LOGIT_RTOL)
    if cfg.n_experts:
        # capacity is taken in token order: a top-k choice that flips under
        # another rounding (any two attention paths round apart in bf16)
        # moves every later token's drops, the last token's most.  So the
        # bar holds the last position with the routing pinned: the kernel
        # path's expert ids, layer by layer, replayed in the chunked path,
        # each path weighing them by its own gates.  The unpinned reading
        # above stays in the record.
        routes, route = [], blocks.moe_route

        def record(gates, k):
            topv, topi = route(gates, k)
            routes.append(topi)
            return topv, topi

        def replay(gates, k):
            topi = routes.pop(0)
            return torch.gather(gates, 1, topi), topi
        del ref
        try:
            blocks.moe_route = record
            model.cfg = dataclasses.replace(cfg, attn_impl="flash")
            got, _ = model.prefill(last["batch"], cache_len=cache_len)
            n_routes = len(routes)
            blocks.moe_route = replay
            model.cfg = dataclasses.replace(cfg, attn_impl="chunked")
            ref, _ = model.prefill(last["batch"], cache_len=cache_len)
        finally:
            blocks.moe_route = route
        rel = rel_l2(torch, got[..., -1, :], ref[..., -1, :])
        rec.update(unpinned_logits_rel_l2=rec["logits_rel_l2"],
                   logits_rel_l2=rel, routing="pinned",
                   routes_replayed=n_routes - len(routes))
        del got
        if bad is None and (routes or n_routes != n_attn):
            bad = (f"{n_routes} MoE routings recorded, {len(routes)} not "
                   f"replayed, for {n_attn} MoE layers")
    model.cfg = cfg
    if bad is None and not (torch.isfinite(ref).all() and
                            rel <= LM_LOGIT_RTOL):
        bad = (f"the last prefill's logits off the chunked path's by "
               f"{rel} (relative L2 > {LM_LOGIT_RTOL})")
    del ref
    if cfg.n_experts:
        tok = torch.as_tensor(np.random.default_rng(SEED + 9).integers(
            0, cfg.vocab_size, (1, MOE_CHECK_PROMPT)), device=dev)
        forms = {}
        for impl in ("scatter", "gather"):
            model.cfg = dataclasses.replace(cfg, moe_impl=impl)
            forms[impl] = model.prefill({"tokens": tok}, cache_len=0)[0]
        model.cfg = cfg
        same = torch.equal(forms["scatter"], forms["gather"])
        rec.update(moe_forms_bit_for_bit=same,
                   moe_check_prompt=MOE_CHECK_PROMPT)
        if bad is None and not same:
            bad = ("the gather form's logits differ from scatter's by "
                   f"{(forms['scatter'] - forms['gather']).abs().max()}")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    if not n_attn:
        rec.update(check_mlstm_forms(torch, dev, cfg, last["batch"]))
        if bad is None and not rec["mlstm_forms_err"] <= \
                XLSTM_FORMS_RTOL:
            bad = (f"float32 parallel and scan mLSTM apart by "
                   f"{rec['mlstm_forms_err']} (> {XLSTM_FORMS_RTOL})")
    return rec, launches, bad and f"{phase} {arch}: {bad}"


def profile_device(torch, run):
    """Device time by kernel over ``run()``, and the device's busy share of
    its wall time, from ``torch.profiler`` (CPU and CUDA activity; only
    the device-side events are summed)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        if dev_us > 0:
            rows.append((dev_us / 1e3, ev.key, ev.count))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    return wall_ms, busy_ms, rows


def device_split(rows, kernel, tags):
    """Device ms of profiler rows by kind: ``kernel`` (the rows whose name
    holds one of ``tags``), matrix products (cuBLAS/CUTLASS kernels), and
    the rest (elementwise passes, gathers, reductions, copies)."""
    split = {kernel: 0.0, "gemms": 0.0, "other": 0.0}
    for ms, key, _ in rows:
        name = key.lower()
        if any(t in name for t in tags):
            split[kernel] += ms
        elif any(t in name for t in ("gemm", "gemv", "cutlass", "xmma",
                                     "nvjet", "cublas")):
            split["gemms"] += ms
        else:
            split["other"] += ms
    return split


def profile_rounds(torch, run, tag):
    """The device timeline of ``run()`` between the first and the last
    start of a kernel whose name holds ``tag`` (one launch a round): the
    set-up before the first round and the recording after the last fall
    outside.  Returns ``(span_ms, busy_ms, rows, rounds)``: the window's
    length, the device time inside it, ``(ms, name, count)`` by operation,
    and the rounds it spans (launches of ``tag`` less one); None when the
    profiler saw fewer than two such launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    dev = [ev for ev in prof.events() if ev.device_type == DeviceType.CUDA]
    marks = sorted(ev.time_range.start for ev in dev if tag in ev.name)
    if len(marks) < 2:
        return None
    t0, t1 = marks[0], marks[-1]
    by_name = {}
    for ev in dev:
        if t0 <= ev.time_range.start < t1:
            ms, count = by_name.get(ev.name, (0.0, 0))
            by_name[ev.name] = (ms + ev.time_range.elapsed_us() / 1e3,
                                count + 1)
    rows = sorted(((ms, name, count) for name, (ms, count)
                   in by_name.items()), reverse=True)
    return (t1 - t0) / 1e3, sum(r[0] for r in rows), rows, len(marks) - 1


def timed(torch, fn):
    """``(fn(), host seconds)``, synchronized before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def check_async_gossip(torch, np, dev, g, topo, sol, c):
    """4f. The paper's async gossip (§3.2): the dense engine (Theta_tilde,
    n x n x p) and the exact sparse engine on ``g`` with the same
    wake-ups, drawn once by a seeded ``torch.Generator``, must agree bit
    for bit (theta_hist, and every live slot against its dense knowledge
    cell); then the sparse engine on the n = 1M topology must stay
    finite.  Returns a failure message or None."""
    from repro_torch.core.model_propagation import async_gossip
    from repro_torch.core.sparse import wakeups
    from repro_torch.simulate import sparse_async_gossip
    from repro_torch.simulate.topology import SparseTopology

    n = g.n
    rng = np.random.default_rng(SEED + 2)
    sol_g = rng.standard_normal((n, P)).astype(np.float32)
    c_g = rng.uniform(0.05, 1.0, n).astype(np.float32)
    topo_g = SparseTopology.from_graph(g)
    draws = [np.array(a) for a in zip(*wakeups(n, topo_g.tables,
                                               GOSSIP_TICKS, seed=SEED))]
    kw = dict(record_every=GOSSIP_RECORD, draws=draws, device=dev)
    dense, secs_d = timed(torch, lambda: async_gossip(
        g, sol_g, c_g, ALPHA, GOSSIP_TICKS, **kw))
    sparse, secs_s = timed(torch, lambda: sparse_async_gossip(
        topo_g, sol_g, c_g, ALPHA, GOSSIP_TICKS, **kw))
    tabs = topo_g.tables
    rows, slots = (torch.as_tensor(a, device=dev) for a in np.nonzero(
        np.arange(topo_g.k_max)[None, :] < tabs.deg_count[:, None]))
    cols = torch.as_tensor(tabs.nbr_idx, device=dev).long()[rows, slots]
    same_hist = torch.equal(dense.theta_hist, sparse.theta_hist)
    same_slots = torch.equal(sparse.final_knowledge[rows, slots],
                             dense.final_knowledge[rows, cols])
    log(f"[4f] async gossip on random_geometric_graph({n}, k={K_DENSE}), "
        f"p={P}: dense {GOSSIP_TICKS / secs_d:.4g} ticks/s "
        f"(Theta_tilde {dense.final_knowledge.numel() * 4 / 1e6:.0f} MB), "
        f"sparse {GOSSIP_TICKS / secs_s:.4g} ticks/s; theta_hist equal: "
        f"{same_hist}, {rows.numel()} live slots equal to the dense "
        f"knowledge: {same_slots}")
    if not (same_hist and same_slots) \
            or not torch.isfinite(sparse.theta_hist).all():
        return "4f: sparse async gossip differs from the dense engine"
    del dense, sparse
    tr, secs = timed(torch, lambda: sparse_async_gossip(
        topo, sol, c, ALPHA, GOSSIP_TICKS_1M, seed=SEED,
        record_every=GOSSIP_RECORD_1M, device=dev))
    moved = (tr.theta_hist[-1] - sol).abs().max().item()
    log(f"[4f] sparse async gossip n={topo.n}: {GOSSIP_TICKS_1M} ticks in "
        f"{secs:.3f} s = {GOSSIP_TICKS_1M / secs:.4g} ticks/s (host "
        f"draws); max |theta - theta_sol| = {moved:.3g}")
    if tr.theta_hist.shape != (GOSSIP_TICKS_1M // GOSSIP_RECORD_1M,
                               topo.n, P) \
            or not torch.isfinite(tr.theta_hist).all() or not moved > 0:
        return "4f: the n = 1M sparse async gossip run"
    return None


def check_joint(torch, dispatch, dev, spec, per_op, per_op_rate):
    """4g. Joint graph learning on the MP path's topology, models and
    stream: at eta_graph = 0 it must equal 4a's per-op trace ``per_op``
    bit for bit; with the JAX benchmark's knobs the learned weights must
    be non-negative, exactly 0 at dead slots, with each row's mass within
    the prune's bound below 1, the live mask and the live-edge count must
    never grow, the voided deliveries must be a subset of the delivered
    ones, and the stream counters must equal 4a's; the last graph step,
    on its own inputs, must project onto the simplex and blend within
    1e-5, and its ``edge_reweight`` on the card must agree with the CPU
    within 1e-5.  Returns a failure message or None."""
    from repro_torch.core.sparse import live_slots
    from repro_torch.kernels import ref
    from repro_torch.simulate import ScenarioSpec, run_scenario

    spec = dict(spec, algo="joint")
    counters = (per_op.delivered, per_op.dropped, per_op.invalid,
                per_op.events)
    tr, secs = timed(torch, lambda: run_scenario(ScenarioSpec(
        **spec, eta_graph=0.0)))
    same = torch.equal(tr.theta_hist, per_op.theta_hist)
    log(f"[4g] joint, eta_graph=0: {tr.events / secs:.4g} events/s "
        f"(4a per-op {per_op_rate:.4g}); theta_hist equal to 4a's per-op: "
        f"{same}")
    if not same or (tr.delivered, tr.dropped, tr.invalid, tr.events) \
            != counters or tr.suppressed != 0:
        return "4g: joint at eta_graph=0 is not 4a's per-op run"
    del tr

    plain = dispatch.resolve("edge_reweight", None, dev)
    last = []

    def capture(d, w, live, *, eta, lam):
        last[:] = [d, w, live]                    # references, no copies
        return plain(d, w, live, eta=eta, lam=lam)

    dispatch.register("edge_reweight", "reference")(capture)
    try:
        tr, secs = timed(torch, lambda: run_scenario(ScenarioSpec(
            **spec, **JOINT_KW)))
    finally:
        dispatch.register("edge_reweight", "reference")(plain)
    w, live = tr.final_w, tr.final_live
    tabs = spec["topology"].device_tables(dev)
    k = tabs.nbr_idx.shape[1]
    cand = live_slots(tabs.deg_count, k)
    has = live.any(dim=1)
    sums = w.sum(dim=1)[has]
    edges = tr.live_edges_hist
    steps = tr.rounds // JOINT_KW["graph_every"]
    # a prune zeroes weights <= prune_eps without renormalising the row
    # (as the JAX package does), and each later blend gives back a share
    # eta of the deficit, so a row's mass lies in [1 - k * prune_eps, 1]
    floor = 1.0 - k * JOINT_KW["prune_eps"]
    log(f"[4g] joint, {JOINT_KW}: {tr.events / secs:.4g} events/s "
        f"(4a per-op {per_op_rate:.4g}); {steps} graph steps; live "
        f"edges {edges.tolist()} of {int(cand.sum())} candidates; row "
        f"mass {sums.min().item():.7g} to {sums.max().item():.7g} (in "
        f"[{floor:.4g}, 1 + 1e-5]); suppressed {tr.suppressed} of "
        f"{tr.delivered} delivered")
    if (w[~live] != 0).any() or (w < 0).any() \
            or not sums.min().item() >= floor - 1e-5 \
            or not sums.max().item() <= 1.0 + 1e-5:
        return "4g: learned rows off the simplex"
    if (live & ~cand).any() or (edges[1:] > edges[:-1]).any():
        return "4g: a pruned slot revived"
    if not 0 <= tr.suppressed <= tr.delivered \
            or (tr.delivered, tr.dropped, tr.invalid, tr.events) \
            != counters or not torch.isfinite(tr.theta_hist).all():
        return "4g: learned run's counters"
    del tr
    # the last graph step, on its own inputs: its projection target is on
    # the simplex, the blend keeps (1 - eta) of the row's mass and adds
    # eta, and the card agrees with the CPU
    d, w, live = last
    eta, lam = JOINT_KW["eta_graph"], JOINT_KW["lam"]
    has = live.any(dim=1)
    target = ref.simplex_project_rows(-d / (2.0 * lam), live)
    target_err = (target.sum(dim=1)[has] - 1.0).abs().max().item()
    got = plain(d, w, live, eta=eta, lam=lam)
    blend_err = (got.sum(dim=1) - ((1.0 - eta) * w.sum(dim=1) + eta))[has] \
        .abs().max().item()
    want = plain(d.cpu(), w.cpu(), live.cpu(), eta=eta, lam=lam)
    got = got.cpu()
    err = (got - want).abs().max().item()
    support = int(((got > 0) != (want > 0)).sum())
    log(f"[4g] the last graph step ({tuple(d.shape)}): projection rows' "
        f"max |sum - 1| = {target_err:.3g}, blend's max |mass error| = "
        f"{blend_err:.3g} (tol 1e-5 each); edge_reweight on the card vs "
        f"the CPU max abs err {err:.3g} (tol 1e-5), {support} slots "
        f"differ in support")
    if not target_err <= 1e-5 or not blend_err <= 1e-5 \
            or (target[~live] != 0).any():
        return "4g: the graph step left the simplex"
    if not err <= 1e-5:
        return "4g: edge_reweight on the card disagrees with the CPU"
    return None


def cl_pair(torch, dispatch, run, label, rounds):
    """Run a CL scenario with the kernel (auto) and with the reference
    backend; check equal counters, theta_hist within 1e-5, finite, and
    ``cl_edge_step`` launched once per round on the kernel run.  Returns
    ``(kernel trace, events/s, failure message or None)``."""
    ref_backend = dispatch.ReproBackend(default="reference")
    traces, rates, launches = [], [], []
    for backend in (None, ref_backend):
        dispatch.reset_launch_counts()
        tr, secs = timed(torch, lambda: run(backend))
        launches.append(dispatch.launch_counts()["cl_edge_step"])
        tr.final = None                      # the state is not used here
        traces.append(tr)
        rates.append(tr.events / secs)
    ker, ref = traces
    err = (ker.theta_hist - ref.theta_hist).abs().max().item()
    log(f"[{label}] kernel {rates[0]:.4g} events/s, reference "
        f"{rates[1]:.4g}; cl_edge_step launches {launches}; theta_hist "
        f"kernel vs reference max |diff| = {err:.3g} (tol 1e-5)")
    if launches != [rounds, 0] or not err <= 1e-5 \
            or (ker.delivered, ker.dropped, ker.invalid) \
            != (ref.delivered, ref.dropped, ref.invalid) \
            or not torch.isfinite(ker.theta_hist).all():
        return ker, rates[0], f"{label}: kernel vs reference CL run"
    return ker, rates[0], None


def check_inexact(torch, np, dispatch, dev, spec_cl, exact, exact_rate):
    """4h. CL-ADMM with the inexact primal: the B -> inf quadratic solver
    on 4d's data and stream against 4d's exact kernel run ``exact``;
    ``b_steps=8`` with the kernel and the reference backend; then
    federated moons with MLP agents (p = 33, ``cl_edge_step``'s generic-p
    path), kernel and reference.  Returns a failure message or None."""
    from repro_torch.core.primal import (InexactPrimal, flat_predictor,
                                         solitary_adamw)
    from repro_torch.data import federated_moons_problem, model_accuracy
    from repro_torch.models import MLPAgent
    from repro_torch.simulate import (NetworkConditions, ScenarioSpec,
                                      precompute_event_stream, run_scenario)

    tr, secs = timed(torch, lambda: run_scenario(ScenarioSpec(
        **spec_cl, rounds=ROUNDS, record_every=RECORD,
        primal=InexactPrimal(loss="quadratic", b_steps=None))))
    tr.final = None
    err = (tr.theta_hist - exact.theta_hist).abs().max().item()
    log(f"[4h] InexactPrimal(quadratic, b_steps=None): {tr.events / secs:.4g}"
        f" events/s (4d exact {exact_rate:.4g}); theta_hist vs 4d's exact "
        f"run max |diff| = {err:.3g} (tol 1e-5)")
    if not err <= 1e-5 or (tr.delivered, tr.dropped, tr.invalid) != \
            (exact.delivered, exact.dropped, exact.invalid):
        return "4h: the B -> inf anchor differs from the exact run"
    del tr

    inexact = InexactPrimal(loss="quadratic", b_steps=8, lr=0.05)
    _, rate, bad = cl_pair(torch, dispatch, lambda backend: run_scenario(
        ScenarioSpec(**spec_cl, rounds=INEXACT_ROUNDS,
                     record_every=INEXACT_RECORD, primal=inexact,
                     backend=backend)), "4h b_steps=8", INEXACT_ROUNDS)
    log(f"[4h] b_steps=8 at n={spec_cl['topology'].n}: {rate:.4g} events/s"
        f" against 4d's exact {exact_rate:.4g} ({rate / exact_rate:.3g}x)")
    if bad:
        return bad

    (mtopo, train, tx, ty), gen_s = timed(torch, lambda: (
        federated_moons_problem(n=MOONS_N, seed=SEED, device=dev)))
    model = MLPAgent(in_dim=2, hidden=(8,))
    pred = flat_predictor(model)
    sol, sol_s = timed(torch, lambda: solitary_adamw(
        train, loss="logistic", model=model, steps=MOONS_SOLITARY_STEPS,
        seed=SEED))
    acc_sol = float(model_accuracy(sol, pred, tx, ty).mean())
    cond = NetworkConditions()
    stream = precompute_event_stream(
        mtopo.device_tables(dev), torch.as_tensor(mtopo.partition_halves()),
        cond, MOONS_BATCH, SEED, MOONS_ROUNDS, device=dev)
    primal = InexactPrimal(loss="logistic", model=model, b_steps=10, lr=0.1)
    ker, rate, bad = cl_pair(torch, dispatch, lambda backend: run_scenario(
        ScenarioSpec(algo="cl", topology=mtopo, data=train, mu=0.5, rho=0.2,
                     conditions=cond, rounds=MOONS_ROUNDS,
                     batch=MOONS_BATCH, seed=SEED,
                     record_every=MOONS_RECORD, theta_sol=sol,
                     stream=stream, primal=primal, backend=backend,
                     device=dev)), "4h moons", MOONS_ROUNDS)
    acc = float(model_accuracy(ker.theta_hist[-1], pred, tx, ty).mean())
    log(f"[4h] federated moons n={MOONS_N}, MLPAgent(2, (8,)) p="
        f"{sol.shape[1]}: generator {gen_s:.2f} s on the host, solitary "
        f"AdamW ({MOONS_SOLITARY_STEPS} steps) {sol_s:.2f} s; mean test "
        f"accuracy solitary {acc_sol:.4f}, collaborative {acc:.4f} "
        f"(a reading); CL {rate:.4g} events/s")
    if bad:
        return bad
    if ker.theta_hist.shape != (MOONS_ROUNDS // MOONS_RECORD, MOONS_N,
                                model.flattener().dim):
        return f"4h: moons theta_hist {tuple(ker.theta_hist.shape)}"
    return None


def free_port() -> int:
    """A free TCP port on the loopback interface."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def check_sharded_mp(torch, dispatch, dev, spec, smi):
    """9a. The partitioned MP runner on a LocalMesh of ``SHARDS`` shards of
    the card, on 4a's problem: the greedy partition (host seconds, edge
    cut, halo and boundary sizes), then the f32 codec under all_gather and
    ring — no overflow, within 1e-5 of the single-device fused run, and
    (printed) whether equal to the per-op one, the counters and activity
    equal — then the bf16 and int8 codecs once each against f32, within
    ``CODEC_REL`` of the largest value and not equal to it.  Returns
    ``(record, assignment, failure message or None)``."""
    from repro_torch.launch import LocalMesh, resolve_halo_codec
    from repro_torch.launch import halo_payload_bytes
    from repro_torch.simulate import ScenarioSpec, run_scenario
    from repro_torch.simulate.partition import (GraphPartition,
                                                greedy_partition)

    topo = spec["topology"]
    t0 = time.perf_counter()
    assignment = greedy_partition(topo, SHARDS, seed=SEED)
    part_s = time.perf_counter() - t0
    part = GraphPartition.build(topo, assignment, SHARDS)
    row_bytes = {name: resolve_halo_codec(name).row_nbytes((P,))
                 for name in ("f32", "bf16", "int8")}
    wire = {name: halo_payload_bytes(SHARDS, part.boundary_size, b,
                                     part.halo_size)
            for name, b in row_bytes.items()}
    log(f"[9a] greedy partition of n={topo.n} into {SHARDS} shards in "
        f"{part_s:.2f} s on the host: edge cut {part.edge_cut} of "
        f"{topo.n_edges} edges, shard size {part.shard_size}, halo "
        f"{part.halo_size}, boundary {part.boundary_size}; halo bytes a "
        f"round {wire}")
    rec = dict(phase="9a", shards=SHARDS, partition_s=part_s,
               edge_cut=part.edge_cut, shard_size=part.shard_size,
               halo_size=part.halo_size, boundary_size=part.boundary_size,
               halo_bytes_per_round=wire, device=smi)
    one = {}
    for name, backend in (("per-op", None),
                          ("fused", dispatch.ReproBackend())):
        tr, secs = timed(torch, lambda: run_scenario(ScenarioSpec(
            **spec, backend=backend)))
        one[name] = tr
        rec[f"{name}_events_per_s"] = tr.events / secs
    mesh = LocalMesh(SHARDS, dev)
    hists = {}
    for exchange in ("all_gather", "ring"):
        dispatch.reset_launch_counts()
        tr, secs = timed(torch, lambda: run_scenario(ScenarioSpec(
            **spec, sharded=True, mesh=mesh, assignment=assignment,
            exchange=exchange)))
        fused_err = (tr.theta_hist - one["fused"].theta_hist).abs().max() \
            .item()
        per_op_err = (tr.theta_hist - one["per-op"].theta_hist).abs() \
            .max().item()
        rec[f"sharded_{exchange}_events_per_s"] = tr.events / secs
        rec[f"{exchange}_vs_fused_max_abs_err"] = fused_err
        rec[f"{exchange}_vs_per_op_max_abs_err"] = per_op_err
        log(f"[9a] sharded MP, {exchange}: {tr.events / secs:.4g} events/s "
            f"(single-device per-op {rec['per-op_events_per_s']:.4g}, "
            f"fused {rec['fused_events_per_s']:.4g}); overflow "
            f"{tr.overflow}; max |sharded - fused| = {fused_err:.3g} (tol "
            f"1e-5); max |sharded - per-op| = {per_op_err:.3g} (bit for "
            f"bit: {per_op_err == 0}); launches "
            f"{dispatch.launch_counts()}")
        po = one["per-op"]
        if tr.overflow != 0 or not fused_err <= 1e-5 \
                or not per_op_err <= 1e-5 \
                or (tr.delivered, tr.dropped, tr.invalid, tr.events) != \
                (po.delivered, po.dropped, po.invalid, po.events) \
                or not torch.equal(tr.active_hist, po.active_hist):
            return rec, assignment, f"9a: sharded MP ({exchange}) is not " \
                f"the single-device run"
        hists[exchange] = tr.theta_hist
        del tr
    if not torch.equal(hists["all_gather"], hists["ring"]):
        return rec, assignment, "9a: ring and all_gather differ"
    del one
    top = hists["all_gather"].abs().max().item()
    for codec, rel in CODEC_REL.items():
        tr, secs = timed(torch, lambda: run_scenario(ScenarioSpec(
            **spec, sharded=True, mesh=mesh, assignment=assignment,
            halo_codec=codec)))
        err = (tr.theta_hist - hists["all_gather"]).abs().max().item()
        bar = rel * top
        rec[f"{codec}_vs_f32_max_abs_err"] = err
        rec[f"{codec}_vs_f32_bar"] = bar
        log(f"[9a] halo codec {codec}: {tr.events / secs:.4g} events/s; "
            f"max |{codec} - f32| = {err:.3g} (bar: above 0 and at most "
            f"{rel:.3g} x max |theta| {top:.4g} = {bar:.3g}); wire "
            f"{wire[codec]} bytes a round ({wire['f32']} in f32)")
        if tr.overflow != 0 or not torch.isfinite(tr.theta_hist).all() \
                or not 0 < err <= bar:
            return rec, assignment, f"9a: the {codec} codec's run"
        del tr
    log(json.dumps(rec))
    return rec, assignment, None


def check_sharded_cl(torch, dev, spec_cl, assignment, single, single_rate,
                     smi):
    """9b. The partitioned CL-ADMM runner on a LocalMesh of ``SHARDS``
    shards, on 4d's problem: no overflow and theta_hist equal to 4d's
    single-device kernel run (``single``) bit for bit.  Returns
    ``(record, failure message or None)``."""
    from repro_torch.launch import LocalMesh
    from repro_torch.simulate import ScenarioSpec, run_scenario

    torch.cuda.reset_peak_memory_stats()
    tr, secs = timed(torch, lambda: run_scenario(ScenarioSpec(
        **spec_cl, rounds=ROUNDS, record_every=RECORD, sharded=True,
        mesh=LocalMesh(SHARDS, dev), assignment=assignment)))
    err = (tr.theta_hist - single.theta_hist).abs().max().item()
    rec = dict(phase="9b", shards=SHARDS, events_per_s=tr.events / secs,
               single_device_events_per_s=single_rate, overflow=tr.overflow,
               max_abs_err=err, halo_size=tr.halo_size,
               max_memory_allocated=torch.cuda.max_memory_allocated(),
               device=smi)
    log(f"[9b] sharded CL-ADMM: {tr.events / secs:.4g} events/s "
        f"(single-device kernel run {single_rate:.4g}); overflow "
        f"{tr.overflow}; max |sharded - single-device| = {err} (tol 0); "
        f"peak {rec['max_memory_allocated'] / 2**30:.1f} GiB")
    log(json.dumps(rec))
    if tr.overflow != 0 or err != 0 \
            or (tr.delivered, tr.dropped, tr.invalid, tr.events) != \
            (single.delivered, single.dropped, single.invalid,
             single.events):
        return rec, "9b: sharded CL-ADMM is not the single-device run"
    return rec, None


def check_sharded_joint(torch, dev, spec, assignment, smi):
    """9c. The partitioned joint runner with the JAX benchmark's knobs and
    halo re-compaction (``RECOMPACT``) on a LocalMesh of ``SHARDS``
    shards: theta_hist, final_w, final_live, the live-edge history and the
    suppressed count equal to the single-device joint run.  Returns
    ``(record, failure message or None)``."""
    from repro_torch.launch import LocalMesh
    from repro_torch.simulate import ScenarioSpec, run_scenario
    from repro_torch.simulate.partition import GraphPartition

    spec = dict(spec, algo="joint", **JOINT_KW)
    one, one_s = timed(torch, lambda: run_scenario(ScenarioSpec(**spec)))
    tr, secs = timed(torch, lambda: run_scenario(ScenarioSpec(
        **spec, sharded=True, mesh=LocalMesh(SHARDS, dev),
        assignment=assignment, **RECOMPACT)))
    halo0 = GraphPartition.build(spec["topology"], assignment,
                                 SHARDS).halo_size
    same = dict(theta_hist=torch.equal(tr.theta_hist, one.theta_hist),
                final_w=torch.equal(tr.final_w, one.final_w),
                final_live=torch.equal(tr.final_live, one.final_live),
                live_edges=torch.equal(tr.live_edges_hist,
                                       one.live_edges_hist),
                suppressed=tr.suppressed == one.suppressed)
    rec = dict(phase="9c", shards=SHARDS, **RECOMPACT,
               events_per_s=tr.events / secs,
               single_device_events_per_s=one.events / one_s,
               overflow=tr.overflow, recompactions=tr.recompactions,
               halo_size_before=halo0, halo_size_after=tr.halo_size,
               equal=same, device=smi)
    log(f"[9c] sharded joint ({JOINT_KW}, {RECOMPACT}): "
        f"{tr.events / secs:.4g} events/s (single-device "
        f"{one.events / one_s:.4g}); overflow {tr.overflow}; "
        f"{tr.recompactions} re-compactions, halo {halo0} -> "
        f"{tr.halo_size}; live edges {tr.live_edges_hist.tolist()}; "
        f"equal to the single-device run: {same}")
    log(json.dumps(rec))
    if tr.overflow != 0 or not all(same.values()):
        return rec, "9c: sharded joint learning is not the single-device run"
    return rec, None


def check_sharded_sweep(torch, dispatch, sm, dev, topo, sol, c, whole, smi):
    """9d. ``sparse_sync_mp`` with ``sparse_mix="cuda_sharded"`` on a
    LocalMesh of ``SHARDS`` shards: one ``sparse_gather_mix`` launch a
    block a sweep, each given its block's share of the RCM order, bit for
    bit with ``reference_sharded`` and with the single-device kernel
    sweep; the per-block kernel time beside the whole-table time of phase
    3 (``whole``, its JSON record) and the block's byte bound.  Returns
    ``(record, launches, failure message or None)``."""
    from repro_torch.core.model_propagation import mp_mix_operator
    from repro_torch.kernels.sharded import _block_orders
    from repro_torch.launch import LocalMesh, use_mesh
    from repro_torch.simulate import sparse_sync_mp

    one = sparse_sync_mp(topo, sol, c, ALPHA, SWEEPS, device=dev)
    mesh = LocalMesh(SHARDS, dev)
    with use_mesh(mesh):
        dispatch.reset_launch_counts()
        got, secs = timed(torch, lambda: sparse_sync_mp(
            topo, sol, c, ALPHA, SWEEPS, device=dev,
            backend=dispatch.ReproBackend.using(sparse_mix="cuda_sharded")))
        launches = dispatch.launch_counts()["sparse_gather_mix"]
        ordered = sm.ordered_launches
        plain = sparse_sync_mp(topo, sol, c, ALPHA, SWEEPS, device=dev,
                               backend=dispatch.ReproBackend.using(
                                   sparse_mix="reference_sharded"))
    err_plain = (got - plain).abs().max().item()
    err_one = (got - one).abs().max().item()
    # one block of a steady-state sweep, timed alone
    tabs = topo.device_tables(dev)
    w, b = mp_mix_operator(tabs.nbr_p, c, ALPHA)
    n, k = tabs.nbr_idx.shape
    blk = -(-n // SHARDS)
    order = torch.as_tensor(topo.locality_order, device=dev)
    blk_order = _block_orders(order, n, SHARDS, blk)[0]
    args = (one, tabs.nbr_idx[:blk].contiguous(), w[:blk].contiguous(),
            b[:blk].contiguous(), sol[:blk].contiguous())
    block_ms = time_ms(torch, lambda: sm.sparse_gather_mix(
        *args, order=blk_order), 20)
    rows_read = torch.unique(args[1]).numel()
    n_bytes = 4 * (rows_read * P + 2 * blk * k + blk + 2 * blk * P + blk)
    bms, by = bound_ms(n_bytes, 2 * blk * k * P + 2 * blk * P)
    rec = dict(phase="9d", shards=SHARDS, sweeps=SWEEPS, launches=launches,
               ordered_launches=ordered, sweeps_per_s=SWEEPS / secs,
               max_abs_err_vs_reference_sharded=err_plain,
               max_abs_err_vs_single_device=err_one,
               block_shape=f"N={n} n={blk} k={k} p={P}", block_ms=block_ms,
               block_bound_ms=bms, block_bound_by=by,
               whole_table_ms=whole["ms"], whole_table_bound_ms=whole[
                   "bound_ms"], device=smi)
    log(f"[9d] sparse_sync_mp, cuda_sharded on {SHARDS} shards: "
        f"{SWEEPS} sweeps in {secs:.3f} s, {launches} launches ({ordered} "
        f"with the order); max |cuda_sharded - reference_sharded| = "
        f"{err_plain}, max |cuda_sharded - single device| = {err_one} "
        f"(tol 0); one block ({rec['block_shape']}) {block_ms:.4f} ms "
        f"against a {bms:.4f} ms bound ({by}); the whole table "
        f"{whole['ms']:.4f} ms against {whole['bound_ms']:.4f} ms")
    log(json.dumps(rec))
    if launches != SWEEPS * SHARDS or ordered != SWEEPS * SHARDS \
            or err_plain != 0 or err_one != 0:
        return rec, launches, "9d: the cuda_sharded sweep"
    return rec, launches, None


def check_dist_mesh(torch, dispatch, dev, topo, sol, c, spec, smi):
    """9e. A DistMesh over an NCCL process group of world size 1 on the
    card: the cuda_sharded sweep (its table and outputs all-gathered
    through NCCL) and a short partitioned MP run, each bit for bit with
    the same on a LocalMesh of one shard; and the dense mp coupling over
    the DistMesh, one ``graph_mix`` launch a leaf, bit for bit with
    ``dense_mix_tree`` on the stacked leaves.  Returns ``(record, launches,
    failure message or None)``."""
    import torch.distributed as dist

    from repro_torch.coupling import (CouplingConfig, CouplingState,
                                      dense_mix_tree, make_coupling)
    from repro_torch.launch import DistMesh, LocalMesh, use_mesh
    from repro_torch.simulate import ScenarioSpec, run_scenario, \
        sparse_sync_mp

    backend = dispatch.ReproBackend.using(sparse_mix="cuda_sharded")
    short = dict(spec, rounds=DIST_ROUNDS, record_every=DIST_ROUNDS)
    with use_mesh(LocalMesh(1, dev)):
        want_sweep = sparse_sync_mp(topo, sol, c, ALPHA, DIST_SWEEPS,
                                    device=dev, backend=backend)
    # one agent's tree, a self weight and an anchor weight
    gen = torch.Generator(device=dev).manual_seed(SEED)
    mix_tree = {"w": torch.randn((1, 64, 48), generator=gen, device=dev),
                "b": torch.randn((1, 64), generator=gen, device=dev)}
    mix_sol = {k: torch.randn(v.shape, generator=gen, device=dev)
               for k, v in mix_tree.items()}
    mix_state = CouplingState(
        A_mix=torch.tensor([[0.3]], device=dev),
        b_anchor=torch.tensor([0.7], device=dev),
        W=torch.zeros((1, 1), device=dev))
    mix_cfg = CouplingConfig(mode="mp")
    want_mix = dense_mix_tree(mix_tree, mix_sol, mix_state, mix_cfg)
    want_mp = run_scenario(ScenarioSpec(**short, sharded=True,
                                        mesh=LocalMesh(1, dev)))
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        mesh = DistMesh(device=dev)
        dispatch.reset_launch_counts()
        with use_mesh(mesh):
            got_sweep = sparse_sync_mp(topo, sol, c, ALPHA, DIST_SWEEPS,
                                       device=dev, backend=backend)
        torch.cuda.synchronize()
        launches = dispatch.launch_counts()["sparse_gather_mix"]
        got_mp = run_scenario(ScenarioSpec(**short, sharded=True,
                                           mesh=mesh))
        torch.cuda.synchronize()
        # the dense coupling over the DistMesh: all-gathered, then the
        # stacked mp operator, whose mix op is graph_mix on the card
        dispatch.reset_launch_counts()
        got_mix = make_coupling(mix_cfg, mix_state, mesh=mesh)(
            {k: v.clone() for k, v in mix_tree.items()}, mix_sol, 0)
        torch.cuda.synchronize()
        mix_launches = dispatch.launch_counts()["graph_mix"]
    finally:
        dist.destroy_process_group()
    same = dict(sweep=torch.equal(got_sweep, want_sweep),
                mp=torch.equal(got_mp.theta_hist, want_mp.theta_hist),
                dense_coupling=all(torch.equal(got_mix[k], want_mix[k])
                                   for k in want_mix))
    rec = dict(phase="9e", backend="nccl", world_size=1, launches=launches,
               coupling_graph_mix_launches=mix_launches,
               equal_to_local_mesh=same, device=smi)
    log(f"[9e] DistMesh over NCCL, world size 1: {DIST_SWEEPS} "
        f"cuda_sharded sweeps ({launches} launches) and {DIST_ROUNDS} MP "
        f"rounds, and the dense coupling ({mix_launches} graph_mix "
        f"launches), equal to a LocalMesh of one shard: {same}.  One card "
        f"hosts one NCCL rank: the multi-rank runs were checked on the "
        f"CPU under gloo only (tests/test_torch_sim_mesh.py)")
    log(json.dumps(rec))
    if not all(same.values()) or launches != DIST_SWEEPS \
            or got_mp.overflow != 0:
        return rec, launches, "9e: the DistMesh runs differ from the " \
            "LocalMesh ones"
    if mix_launches != len(mix_tree):
        return rec, launches, (f"9e: the dense coupling launched graph_mix "
                               f"{mix_launches} times, not {len(mix_tree)}")
    return rec, launches, None


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is False: this smoke run "
                    "needs a CUDA card")
    src = ROOT / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        return fail(f"{src / 'repro_torch'} not found: run chip_smoke.py "
                    f"from a checkout of the repository")
    sys.path.insert(0, str(src))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import numpy as np

    from repro_torch.core.graph import random_geometric_graph
    from repro_torch.core.losses import AgentData, solitary_mean
    from repro_torch.core.model_propagation import (mp_mix_operator,
                                                    synchronous)
    from repro_torch.core.sparse import batched_model_update
    from repro_torch.kernels import _build, dispatch
    from repro_torch.configs import get_config
    from repro_torch.kernels import admm_update as au
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import graph_mix as gm
    from repro_torch.kernels import round_fuse as rf
    from repro_torch.kernels import sparse_mix as sm
    from repro_torch.simulate import (ScenarioSpec, get_scenario,
                                      precompute_event_stream,
                                      random_geometric_topology,
                                      run_scenario, sparse_sync_mp)
    from repro_torch.models import Model
    from repro_torch.serve import Engine, ServeConfig

    dev = torch.device(DEVICE)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"device: {kind} ({smi}); torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    # 1. build -------------------------------------------------------------
    _build.library()
    log(f"[1] kernels built and loaded in {_build.build_seconds:.1f} s")

    # 2. main-path data ----------------------------------------------------
    t0 = time.perf_counter()
    topo = random_geometric_topology(N_AGENTS, k=K_NN, seed=SEED)
    topo_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED)
    sol_np = rng.standard_normal((N_AGENTS, P)).astype(np.float32)
    c_np = rng.uniform(0.05, 1.0, N_AGENTS).astype(np.float32)
    tabs = topo.device_tables(dev)
    sol = torch.as_tensor(sol_np, device=dev)
    c = torch.as_tensor(c_np, device=dev)
    cond = get_scenario("lossy-10").make_conditions(ROUNDS)
    t0 = time.perf_counter()
    stream = precompute_event_stream(
        tabs, torch.as_tensor(topo.partition_halves()), cond, BATCH, SEED,
        ROUNDS, device=dev)
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t0
    log(f"[2] topology n={topo.n} k_max={topo.k_max} edges={topo.n_edges} "
        f"built on the host in {topo_s:.2f} s; lossy-10 stream "
        f"({ROUNDS} x {BATCH}) drawn on the card in {stream_s:.2f} s")

    # 3. each kernel against its plain version ------------------------------
    w, b = mp_mix_operator(tabs.nbr_p, c, ALPHA)
    w, b = w.contiguous(), b.contiguous()
    K0 = sol[tabs.nbr_idx]
    theta, Ke = sol.clone(), rf.encode_slots(K0)
    got_ever = torch.zeros(N_AGENTS, dtype=torch.bool, device=dev)
    theta_base = batched_model_update(tabs.nbr_p, K0, c, sol,
                                      ALPHA).contiguous()
    a_w = rf.round_scales(tabs.nbr_p, c, alpha=ALPHA).contiguous()
    del K0
    # the fused body's first WARM rounds (stale messages read the model at
    # the start of the previous round), then round WARM's operands
    prev = theta.clone()
    for t in range(WARM + 1):
        ev = stream.batch_at(t)
        ops = rf.round_prefetch(theta, prev, Ke, ev.i, ev.j, ev.s, ev.r,
                                ev.deliver_ij, ev.deliver_ji, ev.stale_ij,
                                ev.stale_ji)
        if t == WARM:
            break
        prev.copy_(theta)
        theta, Ke, got_ever, _ = rf.round_step(theta, Ke, got_ever, *ops,
                                               theta_base, a_w)
    del prev
    state = (theta, Ke, got_ever, theta_base, a_w)
    del theta, Ke, got_ever
    # sweep 2 of sparse_sync_mp: its table is sweep 1's output
    table = sm.sparse_gather_mix_plain(sol, tabs.nbr_idx, w, b, sol)
    g = random_geometric_graph(N_DENSE, k=K_DENSE, seed=SEED)
    P_dense = torch.as_tensor(g.P, dtype=torch.float32, device=dev)
    c_dense = torch.as_tensor(rng.uniform(0.05, 1.0, N_DENSE),
                              dtype=torch.float32, device=dev)
    sol_dense = torch.as_tensor(
        rng.standard_normal((N_DENSE, D_DENSE)), dtype=torch.float32,
        device=dev)
    A_mix, b_dense = mp_mix_operator(P_dense, c_dense, ALPHA)
    graph_inputs = (sol_dense, sol_dense, A_mix.contiguous(),
                    b_dense.contiguous())

    # the locality order sparse_sync_mp schedules its rows by, built on
    # the host once per topology (cached there: 4b reuses it)
    t0 = time.perf_counter()
    order = torch.as_tensor(topo.locality_order, device=dev)
    log(f"[3] RCM locality order built on the host in "
        f"{time.perf_counter() - t0:.3f} s")
    identity = check_sparse_mix(torch, sm, table, tabs.nbr_idx, w, b, sol,
                                None, "identity")
    kernels = [check_round_step(torch, rf, state, ops),
               check_sparse_mix(torch, sm, table, tabs.nbr_idx, w, b, sol,
                                order, "RCM"),
               check_graph_mix(torch, gm, graph_inputs)]
    del state, ops, table, order
    for kr in [identity] + kernels:
        log(json.dumps(kr))
        if not kr["max_abs_err"] <= kr["tol"]:
            return fail(f"{kr['name']}: max_abs_err {kr['max_abs_err']} "
                        f"> {kr['tol']}")
    log("[3] every kernel agrees with its plain version")

    # 4a. the scenario path: fused (round_step kernel) and per-op ----------
    spec = dict(algo="mp", topology=topo, conditions=cond, rounds=ROUNDS,
                batch=BATCH, seed=SEED, record_every=RECORD, theta_sol=sol,
                c=c, alpha=ALPHA, stream=stream, device=dev)
    runs, counts, rates, runs_s = {}, {}, {}, {}
    for name, backend in (("fused", dispatch.ReproBackend()),
                          ("per-op", None)):
        dispatch.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr = run_scenario(ScenarioSpec(**spec, backend=backend))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts[name] = dispatch.launch_counts()
        runs[name] = tr
        rates[name] = tr.events / secs
        runs_s[name] = secs
        log(f"[4a] {name}: {tr.rounds} rounds, {tr.events} events in "
            f"{secs:.3f} s = {tr.events / secs:.4g} events/s; "
            f"delivered={tr.delivered} dropped={tr.dropped} "
            f"invalid={tr.invalid}; launches {counts[name]}")
    fu, po = runs["fused"], runs["per-op"]
    if counts["fused"]["round_step"] != fu.rounds:
        return fail(f"fused run launched round_step "
                    f"{counts['fused']['round_step']} times for "
                    f"{fu.rounds} rounds")
    if any(counts["per-op"].values()):
        return fail(f"per-op run launched kernels: {counts['per-op']}")
    if (fu.delivered, fu.dropped, fu.invalid, fu.events) != \
            (po.delivered, po.dropped, po.invalid, po.events):
        return fail("fused and per-op counters differ")
    if fu.delivered + fu.dropped != 2 * (fu.events - fu.invalid):
        return fail("accounting invariant broken")
    if fu.theta_hist.shape != (ROUNDS // RECORD, N_AGENTS, P) \
            or not torch.isfinite(fu.theta_hist).all():
        return fail(f"theta_hist {tuple(fu.theta_hist.shape)} not finite "
                    f"or of the wrong shape")
    hist_err = (fu.theta_hist - po.theta_hist).abs().max().item()
    moved = (fu.theta_hist[-1] - sol).abs().max().item()
    log(f"[4a] theta_hist fused vs per-op max |diff| = {hist_err:.3g} "
        f"(tol 1e-5); max |theta - theta_sol| = {moved:.3g}")
    if not hist_err <= 1e-5 or not moved > 0:
        return fail("fused trajectory disagrees with the per-op one")
    fused_hist, fused_s = fu.theta_hist, runs_s["fused"]
    del runs, fu                  # 4g holds joint learning against ``po``

    # 4k. the personalization service on the fused MP run -----------------
    bad = check_serving(torch, np, dispatch, spec, fused_hist, fused_s, smi)
    if bad:
        return fail(bad)
    del fused_hist

    # 5mp. where a fused MP round's time goes (a reading; nothing is
    # checked): the device timeline from round 0's round_step to the last
    # round's, so the set-up (table copies, warm start) is left out
    got = profile_rounds(torch, lambda: run_scenario(ScenarioSpec(
        **dict(spec, rounds=PROFILE_ROUNDS, record_every=PROFILE_ROUNDS),
        backend=dispatch.ReproBackend())), "round_elect")
    if got is None:
        log("[5mp] the profiler recorded no device time: not measured")
    else:
        span_ms, busy_ms, rows, n_rounds = got
        log(f"[5mp] fused MP, {n_rounds} rounds on the device timeline: "
            f"{span_ms:.3f} ms ({span_ms / n_rounds:.4f} ms a round), "
            f"device busy {busy_ms:.3f} ms ({100 * busy_ms / span_ms:.1f} "
            f"%)")
        for ms, key, count in rows[:14]:
            log(f"[5mp]   {ms:9.3f} ms  {count:6d} x  {key[:100]}")
        split = device_split(rows, "round_step", ("round_elect",
                                                  "round_apply"))
        log("[5mp] a round's device time: " + ", ".join(
            f"{k} {v / n_rounds:.4f} ms ({100 * v / busy_ms:.1f} %)"
            for k, v in split.items()))
    del got

    # 4b. sparse_sync_mp through sparse_gather_mix -------------------------
    dispatch.reset_launch_counts()
    t0 = time.perf_counter()
    got = sparse_sync_mp(topo, sol, c, ALPHA, SWEEPS, device=dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts["sparse_sync_mp"] = dispatch.launch_counts()
    ordered = sm.ordered_launches
    want = sparse_sync_mp(topo, sol, c, ALPHA, SWEEPS, device=dev,
                          backend=dispatch.ReproBackend(default="reference"))
    err = (got - want).abs().max().item()
    log(f"[4b] sparse_sync_mp: {SWEEPS} sweeps in {secs:.3f} s, "
        f"launches {counts['sparse_sync_mp']} ({ordered} with the RCM "
        f"order), max |kernel - plain| = {err:.3g} (tol 1e-5)")
    if counts["sparse_sync_mp"]["sparse_gather_mix"] != SWEEPS \
            or ordered != SWEEPS or not err <= 1e-5 \
            or not torch.isfinite(got).all():
        return fail("sparse_sync_mp path")

    # 4c. synchronous through graph_mix ------------------------------------
    sol_d = sol_dense.cpu().numpy()
    c_d = c_dense.cpu().numpy()
    dispatch.reset_launch_counts()
    t0 = time.perf_counter()
    got = synchronous(g, sol_d, c_d, ALPHA, STEPS, device=dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts["synchronous"] = dispatch.launch_counts()
    want = synchronous(g, sol_d, c_d, ALPHA, STEPS, device=dev,
                       backend=dispatch.ReproBackend(default="reference"))
    err = (got - want).abs().max().item()
    log(f"[4c] synchronous: {STEPS} steps in {secs:.3f} s, launches "
        f"{counts['synchronous']}, max |kernel - plain| = {err:.3g} "
        f"(tol 1e-5)")
    if counts["synchronous"]["graph_mix"] != STEPS or not err <= 1e-5 \
            or not torch.isfinite(got).all():
        return fail("synchronous path")

    # 4c'. the same problem over a long run at alpha = 0.99 ----------------
    drift, counts["synchronous_long"] = check_drift(
        torch, dispatch, synchronous, g, sol_d, c_d, dev)
    log(json.dumps(drift))
    if counts["synchronous_long"] != DRIFT_MARKS[-1] or not all(
            r["max_abs"] <= 1e-5 and r["finite"]
            for r in drift["readings"].values()):
        return fail("4c': the long synchronous run drifted past 1e-5 or "
                    "missed its launches")
    del got, want, graph_inputs, sol_dense, P_dense, A_mix

    # 4j. the multi-trial sweeps through graph_mix's trial axis ------------
    batched, counts["sweep"], bad = check_sweeps(torch, np, dispatch, gm,
                                                 dev)
    if bad:
        return fail(bad)

    # 4f. the paper's async gossip, dense and sparse ------------------------
    bad = check_async_gossip(torch, np, dev, g, topo, sol, c)
    if bad:
        return fail(bad)

    # 4g. joint graph learning on the MP path -----------------------------
    bad = check_joint(torch, dispatch, dev, spec, po, rates["per-op"])
    if bad:
        return fail(bad)
    del po, w, b                    # 4i runs MP again on ``spec``

    # 2cl. CL-ADMM data ----------------------------------------------------
    rng_cl = np.random.default_rng(SEED + 1)
    x = torch.as_tensor(rng_cl.standard_normal((N_AGENTS, 3, P)),
                        dtype=torch.float32, device=dev)
    data = AgentData(x, torch.zeros(N_AGENTS, 3, device=dev),
                     torch.ones(N_AGENTS, 3, device=dev))
    sol_cl = solitary_mean(data)
    spec_cl = dict(algo="cl", topology=topo, conditions=cond, seed=SEED,
                   batch=BATCH, data=data, mu=MU, rho=RHO, theta_sol=sol_cl,
                   stream=stream, device=dev)
    log(f"[2cl] CL data (n={N_AGENTS}, 3 draws, p={P}); mu={MU} rho={RHO}")

    # 3cl. the CL kernels on round WARM's own inputs ------------------------
    # run WARM + 1 rounds of the plain body, capturing the edge step's
    # inputs on round WARM
    plain_edge = dispatch.resolve("cl_edge_step", dispatch.ReproBackend(
        default="reference"), dev)
    captured = []

    def capture(*args, rho):
        # Z/L are updated in place below; the rest is not written again
        captured.append(None if len(captured) != WARM else
                        [a.clone() if 2 <= q < 6 else a
                         for q, a in enumerate(args)])
        return plain_edge(*args, rho=rho)

    dispatch.register("cl_edge_step", "reference")(capture)
    try:
        warm = run_scenario(ScenarioSpec(
            **spec_cl, rounds=WARM + 1, record_every=WARM + 1,
            backend=dispatch.ReproBackend(default="reference")))
    finally:
        dispatch.register("cl_edge_step", "reference")(plain_edge)
    del warm
    args = captured[WARM]
    del captured
    cl_kernels = [check_cl_edge_step(torch, rf, args, RHO)]
    warm_state = types.SimpleNamespace(theta=args[0], K=args[1],
                                       L_own=args[4], L_nbr=args[5])
    del args
    slabs = edge_slabs(torch, tabs, warm_state)
    if slabs[0].shape[0] != topo.n_edges:
        return fail(f"edge slabs: {slabs[0].shape[0]} edges, topology has "
                    f"{topo.n_edges}")
    log(f"[3cl] admm_edge_update over E={topo.n_edges} edges of round "
        f"{WARM}'s state")
    cl_kernels.append(check_admm_edge(torch, au, slabs, RHO))
    del slabs, warm_state
    for kr in cl_kernels:
        log(json.dumps(kr))
        if not kr["max_abs_err"] <= kr["tol"]:
            return fail(f"{kr['name']}: max_abs_err {kr['max_abs_err']} "
                        f"> {kr['tol']}")
    kernels += cl_kernels
    log("[3cl] both CL kernels agree with their plain versions bit for bit")

    # 4d. the CL scenario path: kernel (auto) and reference ---------------
    cl_runs, cl_rates = {}, {}
    for name, backend in (("cl-kernel", None),
                          ("cl-reference",
                           dispatch.ReproBackend(default="reference"))):
        dispatch.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr = run_scenario(ScenarioSpec(**spec_cl, rounds=ROUNDS,
                                       record_every=RECORD,
                                       backend=backend))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts[name] = dispatch.launch_counts()
        cl_rates[name] = tr.events / secs
        log(f"[4d] {name}: {tr.rounds} rounds, {tr.events} events in "
            f"{secs:.3f} s = {tr.events / secs:.4g} events/s; "
            f"delivered={tr.delivered} dropped={tr.dropped} "
            f"invalid={tr.invalid}; launches {counts[name]}")
        if name == "cl-reference":
            tr.final = None                  # 11.5 GB; only the kernel's
        cl_runs[name] = tr                   # final state is used below
    ck, cr = cl_runs["cl-kernel"], cl_runs["cl-reference"]
    if counts["cl-kernel"]["cl_edge_step"] != ck.rounds:
        return fail(f"CL run launched cl_edge_step "
                    f"{counts['cl-kernel']['cl_edge_step']} times for "
                    f"{ck.rounds} rounds")
    if any(counts["cl-reference"].values()):
        return fail(f"CL reference run launched kernels: "
                    f"{counts['cl-reference']}")
    if (ck.delivered, ck.dropped, ck.invalid, ck.events) != \
            (cr.delivered, cr.dropped, cr.invalid, cr.events):
        return fail("CL kernel and reference counters differ")
    if ck.delivered + ck.dropped != 2 * (ck.events - ck.invalid):
        return fail("CL accounting invariant broken")
    if ck.theta_hist.shape != (ROUNDS // RECORD, N_AGENTS, P) \
            or not torch.isfinite(ck.theta_hist).all():
        return fail(f"CL theta_hist {tuple(ck.theta_hist.shape)} not "
                    f"finite or of the wrong shape")
    hist_err = (ck.theta_hist - cr.theta_hist).abs().max().item()
    moved = (ck.theta_hist[-1] - sol_cl).abs().max().item()
    log(f"[4d] CL theta_hist kernel vs reference max |diff| = "
        f"{hist_err:.3g} (tol 1e-5); max |theta - theta_sol| = {moved:.3g}")
    if not hist_err <= 1e-5 or not moved > 0:
        return fail("CL kernel trajectory disagrees with the reference")

    # 4e. admm_edge over every edge of the CL run's final state -----------
    slabs = edge_slabs(torch, tabs, ck.final)
    del cl_runs, cr
    ck.final = None
    admm_edge = dispatch.resolve("admm_edge", None, dev)
    dispatch.reset_launch_counts()
    out = admm_edge(*slabs, rho=RHO)
    torch.cuda.synchronize()
    counts["admm_edge"] = dispatch.launch_counts()
    want = au.admm_edge_update_plain(*slabs, RHO)
    err = max((a - b).abs().max().item() for a, b in zip(out, want))
    finite = all(bool(torch.isfinite(a).all()) for a in out)
    log(f"[4e] admm_edge over E={slabs[0].shape[0]} edges of the final "
        f"state: launches {counts['admm_edge']}, max |kernel - plain| = "
        f"{err:.3g} (tol 0)")
    if counts["admm_edge"]["admm_edge_update"] != 1 or err != 0 \
            or not finite:
        return fail("admm_edge path")
    del slabs, out, want

    # 4h. CL-ADMM with the inexact primal ----------------------------------
    bad = check_inexact(torch, np, dispatch, dev, spec_cl, ck,
                        cl_rates["cl-kernel"])
    if bad:
        return fail(bad)

    # 5. where a CL round's time goes (a reading; nothing is checked) ----
    wall_ms, busy_ms, rows = profile_device(torch, lambda: run_scenario(
        ScenarioSpec(**spec_cl, rounds=PROFILE_ROUNDS,
                     record_every=PROFILE_ROUNDS)))
    if busy_ms > 0:
        log(f"[5] CL kernel path, {PROFILE_ROUNDS} rounds under the "
            f"profiler: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
            f"({100 * busy_ms / wall_ms:.1f} %)")
        for ms, key, count in rows[:14]:
            log(f"[5]   {ms:9.3f} ms  {count:6d} x  {key[:100]}")
    else:
        log("[5] the profiler recorded no device time: not measured")

    # 4i. run telemetry on the MP, CL and joint paths ---------------------
    bad = check_telemetry(torch, np, dispatch, spec, spec_cl)
    if bad:
        return fail(bad)

    # 9a-9e. the partitioned simulator on SHARDS shards of the card ------
    sharded = {}
    sharded["9a"], assignment, bad = check_sharded_mp(torch, dispatch, dev,
                                                      spec, smi)
    if bad:
        return fail(bad)
    sharded["9b"], bad = check_sharded_cl(torch, dev, spec_cl, assignment,
                                          ck, cl_rates["cl-kernel"], smi)
    if bad:
        return fail(bad)
    sharded["9c"], bad = check_sharded_joint(torch, dev, spec, assignment,
                                             smi)
    if bad:
        return fail(bad)
    sharded["9d"], counts["sharded_sweep"], bad = check_sharded_sweep(
        torch, dispatch, sm, dev, topo, sol, c, kernels[1], smi)
    if bad:
        return fail(bad)
    sharded["9e"], counts["dist_sweep"], bad = check_dist_mesh(
        torch, dispatch, dev, topo, sol, c, spec, smi)
    if bad:
        return fail(bad)
    del assignment
    torch.cuda.empty_cache()

    # LM serving: free the simulator's state first ------------------------
    del ck, tr, ev, spec_cl, spec, data, x, sol_cl, stream, tabs, topo
    del sol, c
    del cond, g, sol_np, c_np
    torch.cuda.empty_cache()

    # 6a. flash_attention against its plain version -------------------------
    fa_cases = []
    for i, case in enumerate(FA_CASES):
        kr = check_flash(torch, fa, case, SEED + i)
        ok = kr.pop("ok")
        log(json.dumps(kr))
        if not ok:
            return fail(f"flash_attention {kr['shape']}: outside "
                        f"{kr['tol']} abs and rel (max abs err "
                        f"{kr['max_abs_err']})")
        fa_cases.append(kr)
        torch.cuda.empty_cache()
    kernels.append(fa_cases[0])               # the main path's shape
    log("[6a] flash_attention agrees with its plain version on all "
        f"{len(FA_CASES)} cases")

    # 6b. Llama-3-8B serving through the Engine -----------------------------
    cfg = dataclasses.replace(get_config(LM_ARCH), attn_impl="flash")
    t0 = time.perf_counter()
    model = Model(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    log(f"[6b] {cfg.name}: {model.param_count()} parameters "
        f"({cfg.n_layers} layers, d_model {cfg.d_model}), "
        f"{model.embed.dtype}, drawn on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    lm_rng = np.random.default_rng(SEED + 2)
    prompts = [lm_rng.integers(0, cfg.vocab_size, n) for n in LM_PROMPTS]
    model.prefill({"tokens": torch.as_tensor(prompts[0][None], device=dev)},
                  cache_len=LM_CACHE)                         # warm-up
    eng = Engine(model, ServeConfig(batch_size=LM_SLOTS, cache_len=LM_CACHE,
                                    max_new_tokens=LM_NEW, temperature=0.0))
    st = dict(prefill_s=0.0, prefill_tok=0, decode_s=0.0, ticks=0)

    def timed(fn, secs, count, n):
        def run(arg):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(arg)
            torch.cuda.synchronize()
            st[secs] += time.perf_counter() - t
            st[count] += n(arg)
            return out
        return run

    eng._prefill_one = timed(eng._prefill_one, "prefill_s", "prefill_tok",
                             lambda tokens: tokens.shape[1])
    eng._decode = timed(eng._decode, "decode_s", "ticks", lambda tok: 1)
    rids = [eng.submit(p) for p in prompts]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launch_counts()
    t0 = time.perf_counter()
    results = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts["serve"] = dispatch.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    decoded = sum(len(results.get(r, [])) - 1 for r in rids)
    serve = dict(
        phase="6b", model=cfg.name, prompts=list(LM_PROMPTS),
        slots=LM_SLOTS, cache_len=LM_CACHE, max_new_tokens=LM_NEW,
        wall_s=wall, prefill_s=st["prefill_s"],
        prefill_tokens=st["prefill_tok"],
        prefill_tokens_per_s=st["prefill_tok"] / st["prefill_s"],
        decode_s=st["decode_s"], decode_ticks=st["ticks"],
        decode_tokens=decoded, decode_tokens_per_s=decoded / st["decode_s"],
        max_memory_allocated=peak, launches=counts["serve"], device=smi)
    log(json.dumps(serve))
    want_launches = cfg.n_layers * len(LM_PROMPTS)
    if eng.exhausted or sorted(results) != sorted(rids) \
            or any(len(results[r]) != LM_NEW for r in rids):
        return fail(f"serving: exhausted={eng.exhausted}, lengths "
                    f"{[len(results.get(r, [])) for r in rids]}")
    if not all(0 <= t < cfg.vocab_size for r in rids for t in results[r]):
        return fail("serving: a token outside the vocab")
    if counts["serve"]["flash_attention"] != want_launches:
        return fail(f"serving launched flash_attention "
                    f"{counts['serve']['flash_attention']} times, not "
                    f"{cfg.n_layers} layers x {len(LM_PROMPTS)} prefills")
    # where a decode tick and a prefill go (a reading; nothing is checked):
    # PROFILE_TICKS ticks on the engine's full batch cache, then one
    # prefill of the longest prompt
    tok4 = torch.zeros(LM_SLOTS, dtype=torch.int32, device=dev)
    longest = torch.as_tensor(prompts[LM_PROMPTS.index(max(LM_PROMPTS))][None],
                              device=dev)
    for what, run in (
            (f"{PROFILE_TICKS} decode ticks", lambda: [
                model.decode_step(eng.cache, {"token": tok4})
                for _ in range(PROFILE_TICKS)]),
            (f"one {max(LM_PROMPTS)}-token prefill", lambda: model.prefill(
                {"tokens": longest}, cache_len=LM_CACHE))):
        wall_ms, busy_ms, rows = profile_device(torch, run)
        if busy_ms > 0:
            log(f"[6b] {what} under the profiler: wall {wall_ms:.3f} ms, "
                f"device busy {busy_ms:.3f} ms "
                f"({100 * busy_ms / wall_ms:.1f} %)")
            for ms, key, count in rows[:10]:
                log(f"[6b]   {ms:9.3f} ms  {count:6d} x  {key[:100]}")
            if "prefill" in what:
                split = device_split(rows, "flash_attention",
                                     ("flash_fwd",))
                log("[6b] prefill device time: " + ", ".join(
                    f"{k} {v:.3f} ms ({100 * v / busy_ms:.1f} %)"
                    for k, v in split.items()))
        else:
            log(f"[6b] {what}: the profiler recorded no device time: "
                f"not measured")
    del eng, results, run, tok4, longest      # ``run`` holds the model

    # 6c. the kernel path against the reference path ------------------------
    check = lm_rng.integers(0, cfg.vocab_size, LM_CHECK_PROMPT)
    tok = torch.as_tensor(check[None], device=dev)
    paths = {}
    for name, backend in (("cuda", None), ("reference",
                                           dispatch.ReproBackend.using(
                                               attention="reference"))):
        model.backend = backend
        dispatch.reset_launch_counts()
        logits, _ = model.prefill({"tokens": tok},
                                  cache_len=LM_CHECK_PROMPT + LM_AGREE)
        launched = dispatch.launch_counts()["flash_attention"]
        e1 = Engine(model, ServeConfig(batch_size=1,
                                       cache_len=LM_CHECK_PROMPT + LM_AGREE,
                                       max_new_tokens=LM_AGREE))
        rid = e1.submit(check)
        paths[name] = (logits[0, 0], launched, e1.run()[rid])
    model.backend = None
    lk, lr = paths["cuda"][0], paths["reference"][0]
    rel = ((lk - lr).norm() / lr.norm()).item()
    same = np.array(paths["cuda"][2]) == np.array(paths["reference"][2])
    agree = float(same.mean())
    first_diff = int(np.argmin(same)) if not same.all() else None
    log(json.dumps(dict(
        phase="6c", prompt=LM_CHECK_PROMPT, logits_rel_l2=rel,
        tol=LM_LOGIT_RTOL, logits_max_abs_diff=(lk - lr).abs().max().item(),
        logits_max_abs=lr.abs().max().item(),
        greedy_agreement=agree, greedy_tokens=LM_AGREE,
        first_differing_token=first_diff,
        launches={k: v[1] for k, v in paths.items()})))
    if paths["cuda"][1] != cfg.n_layers or paths["reference"][1] != 0:
        return fail(f"6c launches {[v[1] for v in paths.values()]}")
    if lk.shape != (cfg.vocab_size,) or not torch.isfinite(lk).all() \
            or not rel <= LM_LOGIT_RTOL:
        return fail(f"kernel path logits {tuple(lk.shape)} off the "
                    f"reference path's by {rel} (relative L2 > "
                    f"{LM_LOGIT_RTOL}) or not finite")
    del model, paths, lk, lr, e1, logits     # ``e1`` holds the model
    gc.collect()     # the engine's timed methods close a reference cycle
    torch.cuda.empty_cache()

    # 6d, 6e. float32 prefills through the 3xTF32 kernels -----------------
    for phase, arch, layers, prompt in F32_PREFILLS:
        counts[f"prefill_f32_{phase}"], bad = check_prefill_f32(
            torch, dispatch, dev, lm_rng, phase, arch, layers, prompt)
        if bad:
            return fail(bad)
        torch.cuda.empty_cache()

    # 7a. graph_mix's agent-axis form at the coupling's leaves ------------
    agent_cases = []
    for i, (n, D, dtype) in enumerate(AGENT_CASES):
        kr = check_graph_mix_agents(torch, gm, n, D, dtype, SEED + i)
        ok = kr.pop("ok")
        log(json.dumps(kr))
        if not ok or not kr["replay_bit_for_bit"]:
            return fail(f"graph_mix agent axis {kr['shape']}: max abs err "
                        f"{kr['max_abs_err']} outside {kr['tol']}, or a "
                        f"replay differed")
        agent_cases.append(kr)
        torch.cuda.empty_cache()
    log(f"[7a] graph_mix's agent-axis form agrees with its plain version on "
        f"all {len(AGENT_CASES)} cases")

    # 7b. Llama-3-8B (full width, 2 layers) trained on 2 agents, mp ------
    train, counts["train_llama"], bad = check_train_llama(torch, np,
                                                          dispatch, dev, smi)
    log(json.dumps(train))
    if bad:
        return fail(bad)

    # 10a. the dry run's prediction against the card at one agent --------
    dry_card, bad = check_dryrun_card(torch, np, dispatch, dev, smi)
    log(json.dumps(dry_card))
    if bad:
        return fail(bad)
    steps_ms = ", ".join(f"{s * 1e3:.1f}" for s in dry_card["step_s"])
    log(f"[10a] {smi}: predicted peak "
        f"{dry_card['predicted_peak_bytes'] / 1e9:.3f} GB and "
        f"{dry_card['predicted_matmul_flops'] / 1e12:.3f} TFLOP of matmuls "
        f"a step; measured peak {dry_card['measured_peak_bytes'] / 1e9:.3f}"
        f" GB, steps {steps_ms} ms")

    # 10b. the production mesh's dry run, gossip -------------------------
    dry_mesh, bad = check_dryrun_mesh(smi)
    log(json.dumps(dry_mesh))
    if bad:
        return fail(bad)
    log(f"[10b] {smi}: llama3_8b x train_4k on 16 x 16, gossip: "
        f"{dry_mesh['process_wall_s']:.1f} s wall (the process); "
        f"collectives {json.dumps(dry_mesh['collectives_by_axis'])}")

    # 7c. plm-100m on 8 agents, every coupling mode -----------------------
    modes, counts["train_plm_mp"], bad = check_train_modes(torch, np,
                                                           dispatch, dev,
                                                           smi)
    log(json.dumps(modes))
    if bad:
        return fail(bad)

    # 8a-8f. the model families at full width, one at a time ---------------
    families = {}
    for family in FAMILY_PHASES:
        phase = family[0]
        t0 = time.perf_counter()
        rec, counts[phase], bad = check_family(torch, np, dispatch, dev,
                                               smi, *family)
        rec["phase_s"] = time.perf_counter() - t0
        log(json.dumps(rec))
        if bad:
            return fail(bad)
        families[phase] = rec
    log(f"[8] {len(families)} model families served at full width in "
        f"{sum(r['phase_s'] for r in families.values()):.1f} s")

    # 11. the examples at their default size ----------------------------
    t0 = time.perf_counter()
    examples, counts["examples"], bad = check_examples(torch, dispatch, smi)
    if bad:
        return fail(bad)
    log(f"[11] {smi}: {len(examples)} examples at their default "
        f"size in {time.perf_counter() - t0:.1f} s; launches "
        f"{json.dumps(counts['examples'])}")

    path_of = {"round_step": "fused", "sparse_gather_mix": "sparse_sync_mp",
               "graph_mix": "synchronous", "cl_edge_step": "cl-kernel",
               "admm_edge_update": "admm_edge", "flash_attention": "serve"}
    summary = []
    for kr in kernels:
        kr["launches"] = counts[path_of[kr["name"]]][kr["name"]]
        row = {k: kr[k] for k in (
            "name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "design")}
        if kr["name"] == "flash_attention":     # 6b and the hd-128 families
            row["launches_by_path"] = {"serve": kr["launches"], **{
                phase: counts[phase] for phase, rec in families.items()
                if rec["head_dim"] == 128 and counts[phase]}}
            row["launches"] = sum(row["launches_by_path"].values())
            row["cases"] = [{k: c[k] for k in (
                "shape", "max_abs_err", "ms", "plain_ms", "bound_ms",
                "library_ms")} for c in fa_cases
                if "hd=128" in c["shape"] and "bfloat16" in c["shape"]]
        if kr["name"] == "sparse_gather_mix":   # 4b, 9d's blocks, 9e, 11
            row["launches_by_path"] = {
                "sparse_sync_mp": kr["launches"],
                "sharded_sweep": counts["sharded_sweep"],
                "dist_sweep": counts["dist_sweep"],
                "examples": counts["examples"].get(kr["name"], 0)}
            row["launches"] = sum(row["launches_by_path"].values())
            row["sharded_block"] = {k: sharded["9d"][k] for k in (
                "block_shape", "block_ms", "block_bound_ms",
                "block_bound_by")}
        if kr["name"] == "graph_mix":           # its paths and 11's
            row["launches_by_path"] = {
                "synchronous": kr["launches"],
                "synchronous_long": counts["synchronous_long"],
                "sweep": counts["sweep"]["graph_mix"],
                "examples": counts["examples"].get(kr["name"], 0)}
            row["launches"] = sum(row["launches_by_path"].values())
            row["trial_axis"] = batched
        if kr["name"] in ("round_step", "cl_edge_step"):    # and 11's
            row["launches_by_path"] = {
                path_of[kr["name"]]: kr["launches"],
                "examples": counts["examples"].get(kr["name"], 0)}
            row["launches"] = sum(row["launches_by_path"].values())
        summary.append(row)
    agent = {k: agent_cases[0][k] for k in (
        "name", "route", "source", "replaces", "max_abs_err", "ms",
        "plain_ms", "bound_ms", "bound_by", "library_ms", "design")}
    agent["launches"] = counts["train_llama"] + counts["train_plm_mp"]
    agent["launches_by_path"] = {"train_llama": counts["train_llama"],
                                 "train_plm_mp": counts["train_plm_mp"]}
    agent["cases"] = [{k: kr[k] for k in ("shape", "max_abs_err", "ms",
                                          "plain_ms", "bound_ms",
                                          "library_ms")}
                      for kr in agent_cases]
    summary.append(agent)
    # the bf16 kernel's other head dims, each at its family's shape with
    # that family's launches: hd 256 (8c, RecurrentGemma's MQA heads,
    # 80-key tiles) and hd 64 (8f, MusicGen's MHA heads)
    for hd in (256, 64):
        case = next(kr for kr in fa_cases if f"hd={hd} " in kr["shape"]
                    and "bfloat16" in kr["shape"])
        row = {k: case[k] for k in (
            "name", "route", "source", "replaces", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "design",
            "shape")}
        row["launches_by_path"] = {phase: counts[phase]
                                   for phase, rec in families.items()
                                   if rec["head_dim"] == hd}
        row["launches"] = sum(row["launches_by_path"].values())
        row["resources"] = fa.flash_attention_resources(hd, torch.bfloat16)
        summary.append(row)
    # the float32 kernels (3xTF32 at every head dim): 6d's and 6e's
    # launches, timed at Llama-3-8B's prefill shape, every float32 6a case
    # beside it
    f32_cases = [kr for kr in fa_cases if "float32" in kr["shape"]]
    case = next(kr for kr in f32_cases if "hd=128 " in kr["shape"])
    row = {k: case[k] for k in (
        "name", "route", "source", "replaces", "max_abs_err", "ms",
        "plain_ms", "bound_ms", "bound_by", "library_ms", "design", "shape",
        "ffma_floor_ms", "library_kernels")}
    row["launches_by_path"] = {
        f"prefill_f32_{phase}": counts[f"prefill_f32_{phase}"]
        for phase, *_ in F32_PREFILLS}
    row["launches"] = sum(row["launches_by_path"].values())
    row["cases"] = [{k: c[k] for k in (
        "shape", "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
        "ffma_floor_ms", "library_ms", "library_device_ms", "design")}
        for c in f32_cases]
    row["resources"] = {hd: fa.flash_attention_resources(hd, torch.float32)
                        for hd in fa.HEAD_DIMS}
    summary.append(row)
    log(json.dumps({"kernels": summary}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
