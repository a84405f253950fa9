"""The port stands alone: it imports neither JAX nor the JAX package, and
it never continues on the CPU unless told to."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "predictionio_tpu_torch"

# the port's ALS serving and UR train + serving paths on the CPU, in a
# fresh interpreter
_DRIVE = r"""
import json, sys, urllib.request
import numpy as np
from predictionio_tpu_torch.controller import EngineParams
from predictionio_tpu_torch.models import recommendation as reco
from predictionio_tpu_torch.workflow.create_server import deploy_models

rng = np.random.default_rng(0)
state = {
    "X": rng.normal(size=(4, 3)).astype(np.float32),
    "Y": rng.normal(size=(9, 3)).astype(np.float32),
    "users": [f"u{i}" for i in range(4)], "items": [f"i{i}" for i in range(9)],
    "seen": {"indptr": np.array([0, 2, 2, 3, 3]), "values": np.array([1, 4, 0])},
}
model = reco.als_model_from_state(state, device="cpu")
engine = reco.RecommendationEngine.apply()
ep = EngineParams(algorithm_params_list=[("als", reco.ALSAlgorithmParams())])
engine.predictor(ep, [model])(reco.RecoQuery(user="u0", num=3, unseen_only=True))
engine.batch_predictor(ep, [model])([reco.RecoQuery(user="u1", num=2)] * 3)
server = deploy_models(engine, ep, [model], query_class=reco.RecoQuery)
url = f"http://127.0.0.1:{server.server_address[1]}/queries.json"
req = urllib.request.Request(url, data=json.dumps({"user": "u2"}).encode())
assert json.loads(urllib.request.urlopen(req, timeout=30).read())["itemScores"]
server.shutdown(); server.server_close()

from predictionio_tpu_torch.models import universal_recommender as ur
from predictionio_tpu_torch.storage import memory as mem
u = rng.integers(0, 30, 300)
i = rng.integers(0, 12, 300)
td = ur.ur_training_data_from_arrays(
    ["buy"], [f"u{j}" for j in range(30)],
    {"buy": (u, i, [f"i{j}" for j in range(12)], np.arange(300.0))})
params = ur.URAlgorithmParams(app_name="a", max_correlators_per_item=4)
ur_model = ur.URAlgorithm(params, device="cpu").train(td)
store = mem.MemStorage()
store.l_events.insert(mem.Event("buy", "user", "u1", target_entity_type="item",
                                target_entity_id="i3"), store.apps.insert("a"))
mem.set_storage(store)
ur_engine = ur.UniversalRecommenderEngine.apply()
ur_ep = EngineParams(algorithm_params_list=[("ur", params)])
assert ur_engine.predictor(ur_ep, [ur_model])(ur.URQuery(user="u1", num=3)).item_scores
server = deploy_models(ur_engine, ur_ep, [ur_model], query_class=ur.URQuery)
url = f"http://127.0.0.1:{server.server_address[1]}/queries.json"
req = urllib.request.Request(url, data=json.dumps({"item": "i2"}).encode())
assert json.loads(urllib.request.urlopen(req, timeout=30).read())["itemScores"]
server.shutdown(); server.server_close()
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "predictionio_tpu" or m.startswith("predictionio_tpu."))
print(json.dumps(bad))
"""


def _is_forbidden(module: str) -> bool:
    # the port's own name starts with "predictionio_tpu": match the JAX
    # package by its exact name or its dotted prefix only
    return module in ("jax", "predictionio_tpu") or module.startswith(
        ("jax.", "predictionio_tpu."))


def test_port_path_loads_no_jax_module():
    out = subprocess.run([sys.executable, "-c", _DRIVE], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_module_match_is_exact():
    assert _is_forbidden("jax") and _is_forbidden("jax.numpy")
    assert _is_forbidden("predictionio_tpu")
    assert _is_forbidden("predictionio_tpu.ops.als")
    assert not _is_forbidden("predictionio_tpu_torch")
    assert not _is_forbidden("predictionio_tpu_torch.ops.als")
    assert not _is_forbidden("jaxlib_free")


@pytest.mark.parametrize("path", sorted(
    [p.relative_to(REPO).as_posix() for p in PORT.rglob("*.py")]
    + ["chip_smoke.py", "profile_torch.py"]))
def test_no_file_of_the_port_imports_jax(path):
    tree = ast.parse((REPO / path).read_text(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _is_forbidden(n)]
        assert not bad, f"{path}:{node.lineno} imports {bad}"


def test_model_without_card_raises_unless_cpu_asked(monkeypatch):
    from predictionio_tpu_torch.device import resolve_device
    from predictionio_tpu_torch.models.recommendation import als_model_from_state

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    state = {"X": [[1.0]], "Y": [[1.0]], "users": ["u"], "items": ["i"],
             "seen": {"indptr": [0, 0], "values": []}}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        als_model_from_state(state)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    assert als_model_from_state(state, device="cpu").device == torch.device("cpu")
