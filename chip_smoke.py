#!/usr/bin/env python3
"""Drive the PyTorch/H100 port's main path on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout: it imports ``predictionio_tpu_torch``
from beside this file (never JAX, never ``predictionio_tpu``).  Phases,
each of which fails the run (exit code != 0, no final ``ok`` line):

1. print the card's name and power limit (``nvidia-smi``);
2. build every CUDA kernel from the checkout's sources (one ``nvcc`` each,
   started together) and print the build seconds and ptxas reports;
3. hold each kernel against its plain PyTorch version on the card, at the
   shapes the serving path gives it (-inf positions exact, finite values
   within rtol 1e-5, atol 1e-5);
4. build the full-width ALS model — 5,000 users x 100,000 items x rank 32,
   random factors from a seed — through ``als_model_from_state``;
5. serve it with ``deploy_models`` and POST ``/queries.json`` over HTTP;
6. score 256 queries through ``batch_predictor``;
   every answer of 5 and 6 is checked against the same query scored by the
   plain version on the card and ranked on the host (score descending,
   lower item id first);
7. show from the launch counters that phases 5 and 6 went through the
   kernels;
8. time each kernel, its plain version and a PyTorch yardstick with CUDA
   events, beside its bound (bytes over 3.35 TB/s or fp32 operations over
   67 TFLOP/s, the H100 SXM data sheet's peaks).

The line before the last is one JSON object with a row per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
import traceback
import urllib.request
from pathlib import Path

import numpy as np
import torch

SEED = 20261016
N_USERS, N_ITEMS, RANK = 5_000, 100_000, 32
RTOL, ATOL = 1e-5, 1e-5
PEAK_BYTES_S = 3.35e12        # H100 SXM HBM3
PEAK_F32_FLOP_S = 67e12       # H100 SXM fp32 outside the tensor cores
REPLACES = "predictionio_tpu/ops/pallas_kernels.py:105"


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


# -- phase 3: kernel against its plain version --------------------------------


def score_inputs(b, k, n, dev, gen, mask_dtype=torch.uint8):
    u = torch.randn(b, k, generator=gen, device=dev)
    v = torch.randn(n, k, generator=gen, device=dev)
    mask = (torch.rand(b, n, generator=gen, device=dev) < 0.1).to(mask_dtype)
    bias = torch.randn(n, generator=gen, device=dev)
    return u, v, mask, bias


def compare_kernel(hk, dev, gen) -> float:
    """Max |kernel - plain| over every finite score of every shape."""
    shapes = [(b, k, N_ITEMS) for b in (1, 8, 256) for k in (32, 64)]
    shapes += [(5, 12, 300), (64, 32, N_ITEMS)]
    worst = 0.0
    for b, k, n in shapes:
        for with_bias in (False, True):
            for mask_dtype in ((torch.uint8, torch.float32) if (b, k) == (8, 32)
                               else (torch.uint8,)):
                u, v, mask, bias = score_inputs(b, k, n, dev, gen, mask_dtype)
                bias = bias if with_bias else None
                got = hk.masked_score_matmul(u, v, mask, bias)
                want = hk.masked_score_matmul_plain(u, v, mask, bias)
                torch.cuda.synchronize()
                tag = f"B={b} K={k} I={n} bias={with_bias} mask={mask_dtype}"
                check(torch.equal(torch.isneginf(got), torch.isneginf(want)),
                      f"-inf positions differ at {tag}")
                fin = torch.isfinite(want)
                check(bool(torch.isfinite(got[fin]).all()), f"non-finite score at {tag}")
                err = (got[fin] - want[fin]).abs()
                tol = ATOL + RTOL * want[fin].abs()
                check(bool((err <= tol).all()),
                      f"kernel vs plain beyond rtol/atol 1e-5 at {tag}: "
                      f"max abs err {err.max().item()}")
                worst = max(worst, err.max().item())
                print(f"  ok {tag} max_abs_err={err.max().item():.3e}")
    return worst


# -- phases 4-6: the served model ----------------------------------------------


def make_state(rng):
    """JAX-ALSModel-shaped state: factors, id lists, per-user seen CSR."""
    from predictionio_tpu_torch.store.columnar import CSRLookup

    x = rng.normal(scale=0.5, size=(N_USERS, RANK)).astype(np.float32)
    y = rng.normal(scale=0.5, size=(N_ITEMS, RANK)).astype(np.float32)
    per_user = rng.integers(3, 25, size=N_USERS)
    rows = np.repeat(np.arange(N_USERS), per_user)
    items = rng.integers(0, N_ITEMS, size=len(rows))
    seen = CSRLookup.from_pairs(rows, items, N_USERS)
    return {"X": x, "Y": y,
            "users": [f"u{i}" for i in range(N_USERS)],
            "items": [f"i{i}" for i in range(N_ITEMS)],
            "seen": seen.to_state()}


def queries(rng, n):
    """Query bodies of every kind the template takes."""
    out = []
    for j in range(n):
        body = {"user": f"u{int(rng.integers(N_USERS))}",
                "num": int(rng.choice([1, 4, 10, 20, 100]))}
        if j % 3 == 1:
            body["unseenOnly"] = True
        if j % 4 == 2:
            body["blackList"] = [f"i{int(i)}" for i in rng.integers(N_ITEMS, size=5)]
        out.append(body)
    return out


def reference(model, hk, body):
    """The query scored by the plain version on the card and ranked on the
    host by (score desc, item id asc): [(item, score)], and the full score
    row (for telling a near-tie swap from a wrong answer)."""
    uid = model.user_dict.id(str(body["user"]))
    if uid is None:
        return [], None
    excl = list(model.seen.row(uid)) if body.get("unseenOnly") else []
    excl += [model.item_dict.id(b) for b in body.get("blackList", [])
             if model.item_dict.id(b) is not None]
    n = len(model.item_factors)
    mask = torch.zeros((1, n), dtype=torch.uint8, device=model.device)
    if excl:
        mask[0, torch.as_tensor(excl, dtype=torch.int64, device=model.device)] = 1
    s = hk.masked_score_matmul_plain(model.user_factors_device()[uid][None],
                                     model.item_factors_device(), mask)[0]
    s = s.cpu().numpy()
    order = np.lexsort((np.arange(n), -s))[: min(int(body.get("num", 10)), n)]
    return [(model.item_dict.str(int(i)), float(s[i])) for i in order
            if np.isfinite(s[i])], s


def check_answer(model, hk, body, got) -> int:
    """Same items as the reference, in its order, scores within tolerance.
    Two items may trade places only where their plain scores tie within the
    tolerance (the kernel and cuBLAS sum in different orders); returns how
    many such positions there were."""
    want, s = reference(model, hk, body)
    got = [(d["item"], d["score"]) for d in got["itemScores"]]
    check(len(got) == len(want), f"{body}: {len(got)} items, want {len(want)}")
    swaps = 0
    for (gi, gs), (wi, ws) in zip(got, want):
        tol = ATOL + RTOL * abs(ws)
        check(abs(gs - ws) <= tol, f"{body}: score {gs} vs {ws}")
        if gi != wi:
            plain_gi = s[model.item_dict.id(gi)]
            check(abs(plain_gi - ws) <= tol, f"{body}: item {gi} where {wi} belongs")
            swaps += 1
    return swaps


def post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        check(resp.status == 200, f"HTTP {resp.status} for {body}")
        return json.loads(resp.read())


# -- phase 8: timing -----------------------------------------------------------


def time_cold(fn, flush, reps=50):
    """Median ms of one call with the L2 cache flushed before it (the
    catalog's factors are not left in L2 by the previous query)."""
    for _ in range(5):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound_ms(b, k, n, with_bias=False, mask_bytes=1):
    bytes_ = 4 * (b * k + n * k + b * n) + mask_bytes * b * n + (4 * n if with_bias else 0)
    flops = 2 * b * n * k + (b * n if with_bias else 0)
    t_bytes, t_ops = bytes_ / PEAK_BYTES_S * 1e3, flops / PEAK_F32_FLOP_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_masked_score(hk, dev, gen, b, k, n, flush):
    u, v, mask, _ = score_inputs(b, k, n, dev, gen)
    fill, zero = mask.bool(), torch.zeros(n, device=dev)

    def library():
        return torch.addmm(zero, u, v.T).masked_fill_(fill, float("-inf"))

    launches = hk.masked_score_matmul.launches
    row = {"B": b, "K": k, "I": n,
           "ms": time_cold(lambda: hk.masked_score_matmul(u, v, mask), flush),
           "plain_ms": time_cold(lambda: hk.masked_score_matmul_plain(u, v, mask), flush),
           "library_ms": time_cold(library, flush)}
    hk.masked_score_matmul.launches = launches   # timing launches do not count
    row["bound_ms"], row["bound_by"] = bound_ms(b, k, n)
    return row


# -- the run ---------------------------------------------------------------------


def run() -> None:
    if not torch.cuda.is_available():
        raise SmokeFailure("no CUDA card: the port's main path runs on the GPU")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    try:
        from predictionio_tpu_torch.controller import EngineParams
        from predictionio_tpu_torch.device import resolve_device
        from predictionio_tpu_torch.models import recommendation as reco
        from predictionio_tpu_torch.ops import build
        from predictionio_tpu_torch.ops import hopper_kernels as hk
        from predictionio_tpu_torch.workflow.create_server import deploy_models
    except ImportError as e:
        raise SmokeFailure(f"the port is not beside this script: {e}") from e

    phase("1. card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(smi.splitlines()[0])
    dev = resolve_device("cuda")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    phase("2. build")
    build_s = build.build_all()
    print(f"build_s={build_s:.3f} kernels={sorted(build.SIGNATURES)}")
    for name, log in build.build_logs.items():
        for line in log.splitlines():
            if "Used" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    phase("3. kernel vs plain")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    max_abs_err = compare_kernel(hk, dev, gen)

    phase("4. model")
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    model = reco.als_model_from_state(make_state(rng), device="cuda")
    engine = reco.RecommendationEngine.apply()
    ep = EngineParams(algorithm_params_list=[("als", reco.ALSAlgorithmParams(rank=RANK))])
    print(f"users={N_USERS} items={N_ITEMS} rank={RANK} seen_nnz={model.seen.nnz} "
          f"build_s={time.perf_counter() - t0:.3f}")

    phase("5. HTTP /queries.json")
    listed = [{"user": "u1", "num": 10},
              {"user": "u2", "num": 10, "unseenOnly": True},
              {"user": "u3", "num": 10, "blackList": ["i0", "i1", "i99999", "nope"]},
              {"user": "u4", "num": 1},
              {"user": "u5", "num": 100},
              {"user": "no-such-user", "num": 10}]
    bodies = listed + queries(rng, 44)
    swaps = 0
    hk.masked_score_matmul.launches = 0
    server = deploy_models(engine, ep, [model], port=0, query_class=reco.RecoQuery)
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}/queries.json"
        answers, lat_ms = [], []
        for body in bodies:
            t0 = time.perf_counter()
            answers.append(post(url, body))
            lat_ms.append((time.perf_counter() - t0) * 1e3)
        http_launches = hk.masked_score_matmul.launches
    finally:
        server.shutdown()
        server.server_close()
    check(answers[5] == {"itemScores": []}, f"unknown user answered {answers[5]}")
    for body, got in zip(bodies, answers):
        swaps += check_answer(model, hk, body, got)
    rest = sorted(lat_ms[1:])
    print(f"queries={len(bodies)} launches={http_launches} latency_ms "
          f"first={lat_ms[0]:.3f} then p50={rest[len(rest) // 2]:.3f} "
          f"max={rest[-1]:.3f} (host clock, one client, a connection per request)")

    phase("6. batch_predictor")
    batch_bodies = queries(rng, 256)
    predict_batch = engine.batch_predictor(ep, [model])
    hk.masked_score_matmul.launches = 0
    t0 = time.perf_counter()
    results = predict_batch([reco.RecoQuery.from_json(b) for b in batch_bodies])
    batch_s = time.perf_counter() - t0
    batch_launches = hk.masked_score_matmul.launches
    for body, res in zip(batch_bodies, results):
        swaps += check_answer(model, hk, body, res.to_json())
    print(f"queries={len(batch_bodies)} launches={batch_launches} "
          f"max_batch={predict_batch.max_batch} wall_s={batch_s:.4f} "
          f"near_tie_swaps={swaps}")

    phase("7. launch counters")
    check(http_launches > 0, "the HTTP path launched no masked_score kernel")
    check(batch_launches > 0, "batch_predictor launched no masked_score kernel")
    print(f"masked_score launches: http={http_launches} batch={batch_launches}")

    phase("8. timing")
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)   # > 50 MB L2
    rows = [time_masked_score(hk, dev, gen, b, k, N_ITEMS, flush)
            for b, k in ((1, 32), (64, 32), (256, 64))]
    for r in rows:
        print(f"  masked_score B={r['B']} K={r['K']} I={r['I']}: "
              f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"addmm+masked_fill_ {r['library_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}) | {smi}")
    main = rows[0]   # the per-query launch of the served path
    print(json.dumps({"kernels": [{
        "name": "masked_score", "route": "cuda",
        "source": "predictionio_tpu_torch/ops/csrc/masked_score.cu",
        "replaces": REPLACES, "launches": http_launches + batch_launches,
        "max_abs_err": max_abs_err, "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": main["library_ms"], "shapes": rows,
        "card": smi}]}))


def main() -> int:
    try:
        run()
    except Exception:   # any failed phase: report it, print no result
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
