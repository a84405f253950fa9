"""The port's checkpoint/resume, retry and fault injection against the JAX
package's.

The port's ``utils/checkpoint.py`` keeps the JAX layout (``step_<n>.npz``
+ ``MANIFEST.json``) and ``als_fingerprint`` gives the JAX run key, so a
snapshot written by either package resumes in the other.  Resumed
factors equal a straight run within the JAX bar of
tests/test_checkpoint.py:56-57 (rtol 2e-4, atol 2e-5); where a run crosses
packages the straight run is the JAX one from the same initial factors
(the port's ``_als_init`` monkeypatched to JAX's arrays).
"""

import numpy as np
import pytest
import torch

from predictionio_tpu.ops import als as jax_als
from predictionio_tpu.utils import checkpoint as jax_ck
from predictionio_tpu_torch.controller import EngineParams
from predictionio_tpu_torch.models import recommendation as reco
from predictionio_tpu_torch.ops import als
from predictionio_tpu_torch.storage import set_storage as port_set_storage
from predictionio_tpu_torch.utils.checkpoint import (
    CheckpointStore,
    InjectedFault,
    maybe_inject,
    prune_stale_runs,
)
from predictionio_tpu_torch.workflow import core_workflow

from _torch_event_cases import fill_both, port_memory_storage

RTOL, ATOL = 2e-4, 2e-5


def corpus(seed=0, n_u=60, n_i=40, n_e=1500):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n_u, n_e).astype(np.int32),
            rng.integers(0, n_i, n_e).astype(np.int32),
            rng.integers(1, 6, n_e).astype(np.float32), n_u, n_i)


@pytest.fixture()
def jax_init_in_port(monkeypatch):
    def init(data, k, seed):
        x0, y0 = jax_als._als_init(data, k, seed)
        return torch.as_tensor(np.array(x0)), torch.as_tensor(np.array(y0))

    monkeypatch.setattr(als, "_als_init", init)


def test_checkpoint_roundtrip_and_prune(tmp_path):
    store = CheckpointStore(tmp_path / "ck", keep=2)
    for step in (1, 2, 3):
        store.save(step, {"w": np.full((2, 2), step, np.float32), "step": step})
    assert store.steps() == [2, 3]  # pruned to keep=2
    step, state = store.latest()
    assert step == 3 and state["step"] == 3
    np.testing.assert_array_equal(state["w"], np.full((2, 2), 3, np.float32))
    assert not (tmp_path / "ck" / "step_1.npz").exists()
    # the JAX store reads what the port wrote, and the reverse
    jax_step, jax_state = jax_ck.CheckpointStore(tmp_path / "ck").latest()
    assert jax_step == 3 and jax_state["step"] == 3
    jax_ck.CheckpointStore(tmp_path / "ck").save(4, {"w": np.zeros(3), "tag": "jax"})
    assert store.steps() == [3, 4] and store.latest()[1]["tag"] == "jax"
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
        "MANIFEST.json", "step_3.npz", "step_4.npz"]
    store.clear()
    assert store.latest() is None
    store.clear(remove_dir=True)
    assert not (tmp_path / "ck").exists()


def test_prune_stale_runs_removes_only_old_dirs(tmp_path):
    import os
    import time

    old, new = tmp_path / "old", tmp_path / "new"
    for d in (old, new):
        CheckpointStore(d).save(1, {"w": np.zeros(1)})
    past = time.time() - 3600
    for f in old.iterdir():
        os.utime(f, (past, past))
    assert prune_stale_runs(tmp_path, ttl_seconds=60) == 1
    assert not old.exists() and new.exists()


def test_fault_injection(monkeypatch):
    monkeypatch.setenv("PIO_FAULT_INJECT", "my.site:2")
    maybe_inject("other.site")         # different site: no-op
    maybe_inject("my.site")            # hit 1 of 2: no-op
    with pytest.raises(InjectedFault):
        maybe_inject("my.site")        # hit 2: fires and disarms
    maybe_inject("my.site")            # disarmed


def test_fault_counter_keyed_by_config(monkeypatch):
    monkeypatch.setenv("PIO_FAULT_INJECT", "a:3")
    maybe_inject("a")
    maybe_inject("a")                  # 2 hits, no fire
    monkeypatch.setenv("PIO_FAULT_INJECT", "b:2")
    maybe_inject("b")                  # hit 1 of 2: must NOT fire
    with pytest.raises(InjectedFault):
        maybe_inject("b")


def test_resume_matches_straight_run(tmp_path):
    """5 sweeps + crash + resume to 10 == a straight 10-sweep run."""
    u, i, r, n_u, n_i = corpus()
    data = als.prepare_als_data(u, i, r, n_u, n_i, 1)
    X_ref, Y_ref = als.als_train(data, k=6, reg=0.05, iterations=10, device="cpu")
    store = CheckpointStore(tmp_path / "als")
    als.als_train(data, k=6, reg=0.05, iterations=5, checkpoint=store,
                  checkpoint_every=5, device="cpu")
    assert store.steps() == [5]
    X, Y = als.als_train(data, k=6, reg=0.05, iterations=10, checkpoint=store,
                         checkpoint_every=5, device="cpu")
    assert store.steps() == [5, 10]
    np.testing.assert_allclose(X, X_ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(Y, Y_ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("implicit", [False, True])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_snapshot_of_one_package_resumes_in_the_other(tmp_path, jax_init_in_port,
                                                      writer, implicit):
    u, i, r, n_u, n_i = corpus(seed=5)
    data = als.prepare_als_data(u, i, r, n_u, n_i, 1)
    jdata = jax_als.prepare_als_data(u, i, r, n_u, n_i, 1)
    kw = dict(k=6, reg=0.05, implicit=implicit, alpha=1.5)
    X_ref, Y_ref = jax_als.als_train(jdata, iterations=8, **kw)
    path = tmp_path / "ck"
    if writer == "jax":
        jax_als.als_train(jdata, iterations=4, checkpoint=jax_ck.CheckpointStore(path),
                          checkpoint_every=4, **kw)
        X, Y = als.als_train(data, iterations=8, checkpoint=CheckpointStore(path),
                             checkpoint_every=4, device="cpu", **kw)
    else:
        als.als_train(data, iterations=4, checkpoint=CheckpointStore(path),
                      checkpoint_every=4, device="cpu", **kw)
        X, Y = jax_als.als_train(jdata, iterations=8, checkpoint=jax_ck.CheckpointStore(path),
                                 checkpoint_every=4, **kw)
    assert CheckpointStore(path).steps() == [4, 8]
    np.testing.assert_allclose(X, X_ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(Y, Y_ref, rtol=RTOL, atol=ATOL)


def test_stale_snapshot_rejected(tmp_path):
    """A snapshot of other data (or one at >= iterations) is ignored:
    resume never returns foreign or over-trained factors."""
    rng = np.random.default_rng(2)
    u = rng.integers(0, 30, 500).astype(np.int32)
    i = rng.integers(0, 20, 500).astype(np.int32)
    r = rng.integers(1, 6, 500).astype(np.float32)
    data_a = als.prepare_als_data(u, i, r, 30, 20, 1)
    data_b = als.prepare_als_data(u, i, (6 - r), 30, 20, 1)
    store = CheckpointStore(tmp_path / "ck")
    als.als_train(data_a, k=4, reg=0.05, iterations=4, checkpoint=store,
                  checkpoint_every=2, device="cpu")
    X_b, _ = als.als_train(data_b, k=4, reg=0.05, iterations=4, checkpoint=store,
                           checkpoint_every=2, device="cpu")
    X_b_ref, _ = als.als_train(data_b, k=4, reg=0.05, iterations=4, device="cpu")
    np.testing.assert_allclose(X_b, X_b_ref, rtol=RTOL, atol=ATOL)
    X_2, _ = als.als_train(data_b, k=4, reg=0.05, iterations=2, checkpoint=store,
                           checkpoint_every=2, device="cpu")
    X_2_ref, _ = als.als_train(data_b, k=4, reg=0.05, iterations=2, device="cpu")
    np.testing.assert_allclose(X_2, X_2_ref, rtol=RTOL, atol=ATOL)


def _rating_specs():
    rng = np.random.default_rng(1)
    specs = []
    for u in range(16):
        for i in range(10):
            if rng.random() < 0.9:
                liked = (u < 8) == (i < 5)
                t = 1_780_000_000.0 + 10 * u + i
                specs.append(("rate", "user", f"u{u}", "item", f"i{i}",
                              {"rating": 5.0 if liked else 1.0}, t, t))
    return specs


def test_run_train_retries_through_injected_fault(mem_storage, tmp_path, monkeypatch):
    """PIO_TRAIN_RETRIES + checkpointEvery on the port's run_train: the
    fault on the 2nd sweep chunk is retried, the retry resumes from the
    snapshot (so the fault's hit count shows 3 chunks in all, not 4), and
    the factors equal a straight train; the run's snapshot dir is gone at
    the end.  Without retries the fault propagates and records FAILED."""
    port_store = port_memory_storage()
    fill_both(mem_storage, port_store, "ckapp", _rating_specs())
    port_set_storage(port_store)
    try:
        engine = reco.RecommendationEngine.apply()
        variant = {
            "datasource": {"params": {"appName": "ckapp"}},
            "algorithms": [{"name": "als", "params": {
                "rank": 4, "numIterations": 6, "lambda": 0.05, "meshDp": 1,
                "checkpointEvery": 2, "checkpointDir": str(tmp_path / "ck")}}],
        }
        ep = engine.engine_params_from_variant(variant)
        straight = EngineParams(ep.data_source_params, ep.preparator_params,
                                [("als", reco.ALSAlgorithmParams(
                                    rank=4, num_iterations=6, lambda_=0.05))],
                                ep.serving_params)
        want = engine.train(straight, device="cpu")[0]
        chunks = []
        real_save = CheckpointStore.save
        monkeypatch.setattr(CheckpointStore, "save",
                            lambda self, step, state: (chunks.append(step),
                                                       real_save(self, step, state))[1])
        monkeypatch.setenv("PIO_FAULT_INJECT", "als.sweep:2")
        instance = core_workflow.run_train(engine, ep, "ck-engine", storage=port_store,
                                           retries=1, device="cpu")
        assert instance.status == "COMPLETED"
        assert chunks == [2, 4, 6]       # step 2 saved once; the retry resumed there
        assert not any((tmp_path / "ck").iterdir())
        got = core_workflow.load_latest_models("ck-engine", storage=port_store,
                                               device="cpu")[1][0]
        np.testing.assert_allclose(got.user_factors, want.user_factors, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got.item_factors, want.item_factors, rtol=RTOL, atol=ATOL)

        monkeypatch.setenv("PIO_FAULT_INJECT", "als.sweep:1")
        with pytest.raises(InjectedFault):
            core_workflow.run_train(engine, ep, "ck-engine2", storage=port_store,
                                    retries=0, device="cpu")
        failed = [x for x in port_store.engine_instances.get_all()
                  if x.engine_id == "ck-engine2"]
        assert failed and failed[0].status == "FAILED"
    finally:
        port_set_storage(None)


def test_checkpoint_dir_defaults_to_pio_checkpoint_dir(tmp_path, monkeypatch):
    port_store = port_memory_storage()
    from predictionio_tpu_torch.storage import App

    app = port_store.apps.insert(App(0, "ckenv"))
    from _torch_event_cases import port_events

    port_store.l_events.insert_batch(port_events(_rating_specs()), app)
    port_set_storage(port_store)
    try:
        monkeypatch.setenv("PIO_CHECKPOINT_DIR", str(tmp_path / "base"))
        monkeypatch.setenv("PIO_FAULT_INJECT", "als.sweep:2")
        engine = reco.RecommendationEngine.apply()
        ep = engine.engine_params_from_variant({
            "datasource": {"params": {"appName": "ckenv"}},
            "algorithms": [{"name": "als", "params": {
                "rank": 3, "numIterations": 4, "checkpointEvery": 1}}]})
        with pytest.raises(InjectedFault):
            engine.train(ep, device="cpu")
        (run,) = (tmp_path / "base" / "als").iterdir()
        assert run.name.startswith("k3-dp1-u16x16-i10x10-")
        assert CheckpointStore(run).steps() == [1]
        engine.train(ep, device="cpu")
        assert not run.exists()
    finally:
        port_set_storage(None)
