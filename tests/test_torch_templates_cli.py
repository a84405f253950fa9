"""``pio template list|new`` of the port against the JAX console's
gallery: the same nine templates and descriptions; each scaffold is the
JAX one's engine.json with the factory on the port's module path, and
``pio build`` of it registers the engine in the port's store."""

import json

import pytest

from predictionio_tpu.cli import templates as jax_templates
from predictionio_tpu_torch.cli import main as cli
from predictionio_tpu_torch.cli import templates
from predictionio_tpu_torch.models import ENGINE_FACTORIES
from predictionio_tpu_torch.storage import Storage, StorageConfig, set_storage

NAMES = sorted(jax_templates.TEMPLATE_VARIANTS)


@pytest.fixture()
def port_store():
    store = Storage(StorageConfig.memory())
    set_storage(store)
    yield store
    set_storage(None)


def test_list_names_all_nine(capsys):
    assert cli.main(["template", "list"]) == 0
    listed = [line.split()[0] for line in capsys.readouterr().out.splitlines()]
    assert sorted(listed) == NAMES and len(NAMES) == 9
    assert templates.list_templates() == jax_templates.list_templates()
    assert sorted(ENGINE_FACTORIES) == NAMES


@pytest.mark.parametrize("name", NAMES)
def test_new_scaffolds_what_build_accepts(port_store, tmp_path, capsys, name):
    dest = tmp_path / name
    assert cli.main(["template", "new", name, str(dest)]) == 0
    assert f"Created {name} engine in {dest}/" in capsys.readouterr().out
    doc = json.loads((dest / "engine.json").read_text())
    want = dict(jax_templates.TEMPLATE_VARIANTS[name])
    assert doc["engineFactory"] == want.pop("engineFactory").replace(
        "predictionio_tpu.", "predictionio_tpu_torch.")
    assert {k: v for k, v in doc.items() if k != "engineFactory"} == want
    assert "pio build" in (dest / "README.md").read_text()
    assert cli.main(["build", "--engine-json", str(dest / "engine.json")]) == 0
    assert "Build successful" in capsys.readouterr().out
    assert port_store.engine_manifests.get(doc["id"], "1") is not None


def test_new_refuses_unknown_and_existing(tmp_path, capsys):
    assert cli.main(["template", "new", "nope", str(tmp_path / "x")]) == 1
    assert "unknown template 'nope'" in capsys.readouterr().err
    assert cli.main(["template", "new", "text", str(tmp_path / "t")]) == 0
    assert cli.main(["template", "new", "text", str(tmp_path / "t")]) == 1
    assert "already exists" in capsys.readouterr().err
