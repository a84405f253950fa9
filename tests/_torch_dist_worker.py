"""One rank of tests/test_torch_distributed.py's two-rank run, on the CPU
(gloo).  Joins the process group from the PIO_* variables, then runs every
case in turn and writes what it got to the .npz named by argv[1]:

- ``PEventStore.batch(local_shard=True)`` on the sharedfs store;
- CCO over the mesh: the dense runner and the chunked strategy, its counts
  two a word (the users fit 15 bits) and one a word;
- ALS over the mesh at dp 2 (explicit, plain and checkpointed) and dp 4
  (implicit), from the initial factors the test gives (JAX's);
- logistic regression over the mesh, L-BFGS and Adam;
- ``process_local_rows``;
- ``pio train`` of a small UR (``cli.main.main``, in this process).

The collective counters are recorded after each case.  argv[2] is a JSON
file of the test's inputs (paths).
"""

import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from predictionio_tpu_torch.ops import als, cco, logreg  # noqa: E402
from predictionio_tpu_torch.parallel import distributed as dist  # noqa: E402
from predictionio_tpu_torch.parallel.mesh import create_mesh  # noqa: E402

# the "resident" corpus of tests/_torch_cco_cases.py
CCO = dict(n_users=70, n_ip=14, n_it=19, seeds=(101, 102), n_events=(400, 600))
ALS = dict(n_users=32, n_items=24, n_events=400, seed=5)


def random_events(n_users, n_items, n_events, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n_users, n_events).astype(np.int32),
            rng.integers(0, n_items, n_events).astype(np.int32))


def cco_corpus():
    pu, pi = random_events(CCO["n_users"], CCO["n_ip"], CCO["n_events"][0], CCO["seeds"][0])
    vu, vi = random_events(CCO["n_users"], CCO["n_it"], CCO["n_events"][1], CCO["seeds"][1])
    return pu, pi, vu, vi


def als_corpus():
    rng = np.random.default_rng(ALS["seed"])
    n = ALS["n_events"]
    return (rng.integers(0, ALS["n_users"], n).astype(np.int32),
            rng.integers(0, ALS["n_items"], n).astype(np.int32),
            rng.integers(1, 6, n).astype(np.float32))


def logreg_corpus():
    rng = np.random.default_rng(11)
    x = rng.normal(size=(203, 5)).astype(np.float32)
    y = (x[:, 0] + 0.5 * x[:, 1] > 0).astype(np.int32) + (x[:, 2] > 1).astype(np.int32)
    return x, y


def counts():
    return {k: int(v["calls"]) for k, v in dist.collective_counts().items()}


def main(out_path: str, spec_path: str) -> None:
    spec = json.loads(open(spec_path).read())
    dist.init_distributed(device="cpu")
    mesh = create_mesh()
    out = {"rank": dist.process_index(), "world": dist.process_count(),
           "backend": dist.backend(), "dp": mesh.shape["dp"]}

    from predictionio_tpu_torch.store.event_store import PEventStore

    local = PEventStore.batch(spec["app"], local_shard=True)
    out["shard_times"] = np.asarray(local.times_us, np.int64)

    pu, pi, vu, vi = cco_corpus()
    others = [("buy", pu, pi, CCO["n_ip"]), ("view", vu, vi, CCO["n_it"])]
    for strategy, dense in (("dense", "on"), ("chunked", "off"), ("chunked_wide", "off")):
        os.environ["PIO_CCO_DENSE"] = dense
        # "chunked_wide": counts travel one a word, as past 2**15 users
        cco._PACK_USERS = 0 if strategy == "chunked_wide" else 1 << 15
        dist.reset_collective_counts()
        got = cco.cco_train_indicators(pu, pi, others, CCO["n_users"], CCO["n_ip"],
                                       top_k=5, exclude_self_for="buy", item_tile=8,
                                       user_block=16, mesh=mesh, device="cpu")
        for name, (s, i) in got.items():
            out[f"cco_{strategy}_{name}_s"], out[f"cco_{strategy}_{name}_i"] = s, i
        out[f"cco_{strategy}_all_reduce"] = counts()["all_reduce"]
        out[f"cco_{strategy}_bytes"] = dist.collective_counts()["all_reduce"]["bytes"]
    os.environ.pop("PIO_CCO_DENSE")

    u, i, r = als_corpus()
    from predictionio_tpu_torch.utils.checkpoint import CheckpointStore

    for case, dp, implicit, ckpt in (("dp2", 2, False, False), ("dp4", 4, True, False),
                                     ("dp2_ckpt", 2, False, True)):
        init = np.load(spec["als_init"][str(dp)])
        als._als_init = lambda data, k, seed, _i=init: (torch.as_tensor(_i["x0"]),
                                                        torch.as_tensor(_i["y0"]))
        data = als.prepare_als_data(u, i, r, ALS["n_users"], ALS["n_items"], dp)
        dist.reset_collective_counts()
        checkpoint = CheckpointStore(spec["checkpoint_dir"]) if ckpt else None
        X, Y = als.als_train(data, k=6, reg=0.1, iterations=2, mesh=mesh, implicit=implicit,
                             alpha=2.0, device="cpu", checkpoint=checkpoint,
                             checkpoint_every=1 if ckpt else 0)
        out[f"als_{case}_X"], out[f"als_{case}_Y"] = X, Y
        out[f"als_{case}_all_gather"] = counts()["all_gather"]

    x, y = logreg_corpus()
    for opt in ("lbfgs", "adam"):
        w, b = logreg.logreg_train(x, y, 3, l2=1e-3, iterations=20, optimizer=opt,
                                   mesh=mesh, device="cpu")
        out[f"logreg_{opt}_w"], out[f"logreg_{opt}_b"] = w, b

    out["local_rows"] = np.asarray(dist.process_local_rows(800, mesh))

    from predictionio_tpu_torch.cli.main import main as pio

    dist.reset_collective_counts()
    out["pio_train_rc"] = pio(["train", "--engine-json", spec["engine_json"]])
    out["pio_train_all_reduce"] = counts()["all_reduce"]
    out["jax_loaded"] = any(m == "jax" or m.startswith(("jax.", "predictionio_tpu."))
                            for m in sys.modules)
    np.savez(out_path, **out)
    print("WORKER OK", out["rank"], flush=True)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
