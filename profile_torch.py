#!/usr/bin/env python3
"""Where a served ALS query's time goes in the PyTorch/H100 port.

    python3 profile_torch.py [--queries N]

Builds the model ``chip_smoke.py`` serves (5,000 users x 100,000 items x
rank 32, random factors from a seed) on the CUDA card and measures, after
a warm-up:

1. library predict latency (``Engine.predictor``, no HTTP) and batch
   predict latency at the serving micro-batch (64 queries), host clock;
2. the per-query stages one at a time, each ended by a synchronize:
   exclusion mask on the device, the masked-score kernel, the
   ``lax.top_k``-ordered top-k, the device→host copy, host result assembly;
3. a ``torch.profiler`` window over ``--queries`` predicts: the device's
   busy share of the wall time and kernel time by kernel name.

Needs a CUDA card; imports neither JAX nor the JAX package.  Prints one
JSON object as its last line.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch


def _ms(samples):
    samples = sorted(samples)
    return {"p50": statistics.median(samples),
            "p99": samples[min(len(samples) - 1, int(len(samples) * 0.99))],
            "n": len(samples)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--queries", type=int, default=200)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import chip_smoke
    from predictionio_tpu_torch.controller import EngineParams
    from predictionio_tpu_torch.models import recommendation as reco
    from predictionio_tpu_torch.ops import als as als_ops
    from predictionio_tpu_torch.ops.hopper_kernels import masked_score_matmul
    from predictionio_tpu_torch.ops.topk import topk_desc

    rng = np.random.default_rng(chip_smoke.SEED)
    model = reco.als_model_from_state(chip_smoke.make_state(rng), device="cuda")
    engine = reco.RecommendationEngine.apply()
    ep = EngineParams(algorithm_params_list=[("als", reco.ALSAlgorithmParams())])
    predict = engine.predictor(ep, [model])
    predict_batch = engine.batch_predictor(ep, [model])
    qs = [reco.RecoQuery.from_json(b) for b in chip_smoke.queries(rng, args.queries)]
    t0 = time.perf_counter()
    predict(qs[0])
    first_ms = (time.perf_counter() - t0) * 1e3
    for q in qs[:20]:
        predict(q)
    predict_batch(qs[:64])
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi)

    # 1. end-to-end library latency
    lat = []
    for q in qs:
        t0 = time.perf_counter()
        predict(q)
        lat.append((time.perf_counter() - t0) * 1e3)
    batch = []
    for s in range(0, len(qs) - 63, 64):
        t0 = time.perf_counter()
        predict_batch(qs[s:s + 64])
        batch.append((time.perf_counter() - t0) * 1e3)

    # 2. stages of one query, each ended by a synchronize
    algo = reco.ALSAlgorithm()
    stages = {k: [] for k in ("mask", "kernel", "topk", "readback", "assemble")}
    for q in qs:
        uid = model.user_dict.id(q.user)
        k = algo._k_bucket(min(q.num, len(model.item_factors)), len(model.item_factors))
        excl = als_ops.pad_ids(algo._exclusions(model, q, uid))
        torch.cuda.synchronize()
        t = [time.perf_counter()]
        mask = als_ops.exclusion_mask(excl[None], len(model.item_factors), model.device)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        scores = masked_score_matmul(model.user_factors_device()[uid][None],
                                     model.item_factors_device(), mask)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        stacked = als_ops._stack_topk(*topk_desc(scores, k))
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        out = stacked.cpu().numpy()
        t.append(time.perf_counter())
        [(model.item_dict.str(int(i)), float(s)) for s, i in zip(out[0, 0], out[0, 1])]
        t.append(time.perf_counter())
        for name, a, b in zip(stages, t, t[1:]):
            stages[name].append((b - a) * 1e3)

    # 3. profiler window: device busy share and kernel time by name
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for q in qs:
            predict(q)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", 0) or 0
        if dev_us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels[ev.key] = {"us_per_query": dev_us / len(qs), "calls": ev.count}
    busy_us = sum(k["us_per_query"] for k in kernels.values()) * len(qs)
    top = dict(sorted(kernels.items(), key=lambda kv: -kv[1]["us_per_query"])[:12])
    for name, k in top.items():
        print(f"  {k['us_per_query']:9.2f} us/query  {k['calls']:6d} calls  {name[:90]}")
    print(json.dumps({
        "card": smi, "first_query_ms": first_ms,
        "predict_ms": _ms(lat), "batch64_ms": _ms(batch),
        "stages_ms": {k: _ms(v) for k, v in stages.items()},
        "profiler": {"queries": len(qs), "wall_ms": wall_us / 1e3,
                     "device_busy_ms": busy_us / 1e3,
                     "device_busy_share": busy_us / wall_us if wall_us else None,
                     "kernels": top},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
