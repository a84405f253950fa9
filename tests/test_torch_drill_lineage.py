"""The port's ``tools/check_lineage_roundtrip.py`` against the JAX
package's ``scripts/check_lineage_roundtrip.py``: on the CPU the JAX
drill's ``deploy --workers 2 --follow`` group and the card's topology (a
``--plane-publish`` publisher and a ``--plane-from`` subscriber) both pass;
the topology follows the device; the stage order and limits are the JAX
drill's; without a card the default device is refused."""

import pytest
import torch

from predictionio_tpu_torch import device as device_mod
from predictionio_tpu_torch.tools import check_lineage_roundtrip as port_drill

from _torch_drill_cases import assert_cuda_refused, assert_passes_on_cpu, jax_literal

NAME = "check_lineage_roundtrip"


@pytest.mark.parametrize("topology", ["prefork", "replicated"])
def test_port_drill_passes_on_cpu(topology):
    r = assert_passes_on_cpu(NAME, "--topology", topology)
    if topology == "replicated":
        assert "a publisher and a subscriber that did not produce it" in r.stdout
    else:
        assert "2 serving workers + publisher" in r.stdout


def test_topology_follows_the_device(monkeypatch, capsys):
    """CPU: the JAX drill's prefork group; CUDA: publisher and subscriber,
    and a prefork group on CUDA is a usage error (exit 2)."""
    monkeypatch.setattr(device_mod, "resolve_device", torch.device)
    assert port_drill.parse_args(["--device", "cpu"])[0].topology == "prefork"
    assert port_drill.parse_args(["--device", "cuda"])[0].topology == "replicated"
    with pytest.raises(SystemExit) as e:
        port_drill.parse_args(["--device", "cuda", "--topology", "prefork"])
    assert e.value.code == 2
    assert "--topology prefork needs --device cpu" in capsys.readouterr().err


def test_stages_and_limits_are_the_jax_drills():
    for name in ("ORDERED", "WORKERS", "READY_S", "CONVERGE_S"):
        assert getattr(port_drill, name) == jax_literal(NAME, name), name


def test_cuda_without_a_card_is_refused():
    assert_cuda_refused(NAME)
