"""`pio template` — built-in template gallery + scaffolding.

Counterpart of ``predictionio_tpu/cli/templates.py`` (reference: the
template gallery and `pio template get <repo> <dir>` in tools/console).
The reference clones a template repo; here the templates ship with the
port (predictionio_tpu_torch/models/), so `template new` scaffolds a
working directory with no fetch: an engine.json bound to the chosen
template's factory in the port's ``ENGINE_FACTORIES`` plus a README.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict

from predictionio_tpu_torch.models import ENGINE_FACTORIES

# Default engine.json variant per built-in template (algorithm names must
# match each EngineFactory.apply()'s algorithm_classes keys).
TEMPLATE_VARIANTS: Dict[str, Dict] = {
    "recommendation": {
        "id": "my-recommendation",
        "description": "ALS matrix-factorization recommender on rate events",
        "engineFactory": ENGINE_FACTORIES["recommendation"],
        "datasource": {"params": {"appName": "MyApp"}},
        "algorithms": [
            {"name": "als",
             "params": {"rank": 16, "numIterations": 10, "lambda": 0.05, "meshDp": 1}},
        ],
    },
    "classification": {
        "id": "my-classification",
        "description": "logistic-regression classifier over entity properties",
        "engineFactory": ENGINE_FACTORIES["classification"],
        "datasource": {"params": {"appName": "MyApp",
                                  "attributes": ["attr0", "attr1", "attr2"],
                                  "label": "label"}},
        "algorithms": [
            {"name": "logreg", "params": {"iterations": 200, "l2": 0.01}},
        ],
    },
    "similar_product": {
        "id": "my-similar-product",
        "description": "similar-product lookups from ALS item factors",
        "engineFactory": ENGINE_FACTORIES["similar_product"],
        "datasource": {"params": {"appName": "MyApp", "eventNames": ["view"]}},
        "algorithms": [
            {"name": "als",
             "params": {"rank": 16, "numIterations": 10, "lambda": 0.05}},
        ],
    },
    "universal_recommender": {
        "id": "my-ur",
        "description": "CCO cross-occurrence recommender (Universal Recommender)",
        "engineFactory": ENGINE_FACTORIES["universal_recommender"],
        "datasource": {"params": {"appName": "MyApp",
                                  "eventNames": ["purchase", "view"]}},
        "algorithms": [
            # appName here too: serving-time user-history lookup reads the
            # live event store (without it queries fall back to popularity)
            {"name": "ur",
             "params": {"appName": "MyApp",
                        "maxCorrelatorsPerItem": 50, "num": 20}},
        ],
    },
    "ecommerce": {
        "id": "my-ecommerce",
        "description": "e-commerce recommender (implicit ALS + live business rules)",
        "engineFactory": ENGINE_FACTORIES["ecommerce"],
        "datasource": {"params": {"appName": "MyApp",
                                  "eventNames": ["view", "buy"]}},
        "algorithms": [
            # appName again: seen/unavailable constraints are read live from
            # the event store at query time
            {"name": "ecomm",
             "params": {"appName": "MyApp", "rank": 10, "numIterations": 20,
                        "alpha": 1.0, "unseenOnly": True,
                        "eventWeights": {"buy": 4.0}}},
        ],
    },
    "complementary_purchase": {
        "id": "my-complementary-purchase",
        "description": "shopping-basket rules: cart -> complementary items",
        "engineFactory": ENGINE_FACTORIES["complementary_purchase"],
        "datasource": {"params": {"appName": "MyApp", "eventName": "buy",
                                  "basketWindow": "1 hour"}},
        "algorithms": [
            {"name": "rules",
             "params": {"minSupport": 0.001, "minConfidence": 0.1,
                        "maxRulesPerItem": 20}},
        ],
    },
    "product_ranking": {
        "id": "my-product-ranking",
        "description": "rank a provided item list for a user (ALS scores)",
        "engineFactory": ENGINE_FACTORIES["product_ranking"],
        "datasource": {"params": {"appName": "MyApp",
                                  "eventNames": ["view", "buy"]}},
        "algorithms": [
            {"name": "als",
             "params": {"rank": 10, "numIterations": 10, "alpha": 1.0}},
        ],
    },
    "lead_scoring": {
        "id": "my-lead-scoring",
        "description": "session conversion scoring from first-view attributes",
        "engineFactory": ENGINE_FACTORIES["lead_scoring"],
        "datasource": {"params": {"appName": "MyApp", "viewEvent": "view",
                                  "buyEvent": "buy",
                                  "sessionProperty": "sessionId"}},
        "algorithms": [
            {"name": "logreg", "params": {"iterations": 200, "l2": 0.001}},
        ],
    },
    "text": {
        "id": "my-text-classification",
        "description": "text classification (tf-idf logistic regression)",
        "engineFactory": ENGINE_FACTORIES["text"],
        "datasource": {"params": {"appName": "MyApp"}},
        "algorithms": [
            {"name": "logreg", "params": {"iterations": 200, "dim": 4096}},
        ],
    },
}

_README = """\
# {template} engine

Scaffolded by `pio template new`.  Workflow:

```bash
pio app new MyApp                 # create the app named in engine.json
pio build  --engine-json engine.json
pio train  --engine-json engine.json
pio deploy --engine-json engine.json --port 8000

(`pio` is `python -m predictionio_tpu_torch.cli.main`; it runs on the GPU
unless `PIO_TORCH_DEVICE=cpu`.)
```

Edit `engine.json` to point `datasource.params.appName` at your app and to
tune algorithm params.  To customize the algorithm itself, subclass the
engine factory (`{factory}`) in a local module and set `engineFactory` to
its dotted path — the directory containing engine.json is importable at
train time.
"""


def list_templates() -> Dict[str, str]:
    """name -> one-line description."""
    return {name: doc["description"] for name, doc in TEMPLATE_VARIANTS.items()}


def scaffold(template: str, directory: str) -> Path:
    """Create `directory` with an engine.json + README for `template`."""
    if template not in TEMPLATE_VARIANTS:
        raise ValueError(
            f"unknown template {template!r} (have: {sorted(TEMPLATE_VARIANTS)})"
        )
    dest = Path(directory)
    dest.mkdir(parents=True, exist_ok=True)
    engine_json = dest / "engine.json"
    if engine_json.exists():
        raise FileExistsError(f"{engine_json} already exists")
    engine_json.write_text(json.dumps(TEMPLATE_VARIANTS[template], indent=2) + "\n")
    (dest / "README.md").write_text(
        _README.format(template=template,
                       factory=TEMPLATE_VARIANTS[template]["engineFactory"])
    )
    return dest
