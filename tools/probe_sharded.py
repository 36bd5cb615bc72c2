"""Where a sharded MP round's time goes on the card, at the main path's
size: ``chip_smoke.py`` 4a's problem (``random_geometric_topology(n=1M,
k=8)``, p = 32, a ``lossy-10`` stream of batch 100,000) on a
``LocalMesh`` of 8 shards of one card.

    python3 tools/probe_sharded.py [--shards 8] [--rounds 20] [--n N]

``--n`` sets the agent count (batch n / 10).  Builds the greedy
partition (timed on the host), then runs the sharded
round body (``simulate.partition._MPShards.round``) for ``WARM`` rounds
and ``--rounds`` more under ``torch.profiler``: host ms and device busy
ms a round, and device time by operation.  For comparison it reads the
single-device per-op body the same way (``engines._per_op_rounds`` over
the same stream, its set-up outside the profiled window).  Needs a CUDA
card.  Prints one JSON line per reading, then the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
N, K_NN, P, SEED = 1_000_000, 8, 32, 0
ALPHA, WARM = 0.9, 5


def profile(torch, run):
    """(host ms, device busy ms, [(device ms, op, count)]) over run()."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as prof_ctx
    torch.cuda.synchronize()
    with prof_ctx(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0))
        if us > 0:
            rows.append((us / 1e3, ev.key, ev.count))
    rows.sort(reverse=True)
    return host_ms, sum(r[0] for r in rows), rows


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--n", type=int, default=N)
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("probe_sharded: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch import LocalMesh, resolve_halo_codec
    from repro_torch.simulate import (get_scenario, precompute_event_stream,
                                      random_geometric_topology)
    from repro_torch.simulate import engines
    from repro_torch.simulate import partition as pt

    dev = torch.device("cuda")
    R, n = args.rounds, args.n
    batch = n // 10
    topo = random_geometric_topology(n, k=K_NN, seed=SEED)
    rng = np.random.default_rng(SEED)
    sol = torch.as_tensor(rng.standard_normal((n, P)), dtype=torch.float32,
                          device=dev)
    c = torch.as_tensor(rng.uniform(0.05, 1.0, n), dtype=torch.float32,
                        device=dev)
    tabs = topo.device_tables(dev)
    cond = get_scenario("lossy-10").make_conditions(WARM + R)
    stream = precompute_event_stream(
        tabs, torch.as_tensor(topo.partition_halves()), cond, batch, SEED,
        WARM + R, device=dev)
    t0 = time.perf_counter()
    assignment = pt.greedy_partition(topo, args.shards, seed=SEED)
    part_s = time.perf_counter() - t0
    part = pt.GraphPartition.build(topo, assignment, args.shards)
    E, U = pt._local_capacities(batch, args.shards, None)
    lay = pt._Layout(part, LocalMesh(args.shards, dev), "all_gather",
                     resolve_halo_codec("f32"))
    st = pt._MPShards(lay, sol, c, sol[tabs.nbr_idx.long()], tabs.nbr_p,
                      tabs.deg_count, ALPHA, E, U, None)
    for t in range(WARM):
        st.round(stream.batch_at(t), t)

    def sharded():
        for t in range(WARM, WARM + R):
            st.round(stream.batch_at(t), t)

    host_ms, busy_ms, rows = profile(torch, sharded)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps(dict(
        what="sharded MP round", shards=args.shards, partition_s=part_s,
        halo=part.halo_size, E=E, U=U, rounds=R, host_ms_a_round=host_ms / R,
        device_busy_ms_a_round=busy_ms / R, device=smi,
        by_op=[(round(ms / R, 5), key[:80], cnt // R)
               for ms, key, cnt in rows[:20]])), flush=True)
    del st, lay

    # the single-device per-op body on the same stream: its whole run of
    # WARM + R rounds, less a run of WARM rounds (set-up and warm-up)
    def per_op(rounds):
        return engines._per_op_rounds(tabs, sol, c, ALPHA, cond, stream,
                                      1, rounds, None)

    per_op(WARM)
    h0, b0, _ = profile(torch, lambda: per_op(WARM))
    h1, b1, rows = profile(torch, lambda: per_op(WARM + R))
    print(json.dumps(dict(
        what="single-device per-op round", rounds=R,
        host_ms_a_round=(h1 - h0) / R, device_busy_ms_a_round=(b1 - b0) / R,
        device=smi, by_op_whole_run=[(round(ms, 4), key[:80], cnt)
                                     for ms, key, cnt in rows[:14]])),
        flush=True)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
