"""The port's ``tools/check_freshness_roundtrip.py`` against the JAX
package's ``scripts/check_freshness_roundtrip.py``: the three modes the JAX
suite runs (the default, ``--large`` and ``--storage sharded --shards
2``) pass on the CPU, the seed events of both shapes and the drill's
constants equal the JAX drill's, and without a card the default device is
refused."""

import pytest

from predictionio_tpu_torch.tools import check_freshness_roundtrip as port_drill

from _torch_drill_cases import (assert_cuda_refused, assert_passes_on_cpu,
                                event_rows, jax_value)

NAME = "check_freshness_roundtrip"


@pytest.mark.parametrize("mode", [(), ("--large",), ("--storage", "sharded", "--shards", "2")],
                         ids=["default", "large", "sharded"])
def test_port_drill_passes_on_cpu(mode):
    r = assert_passes_on_cpu(NAME, *mode)
    rounds = 2 if mode == ("--large",) else 3
    assert f"ok: {rounds} append→fold→reflected rounds" in r.stdout, r.stdout
    if mode == ("--large",):
        assert "4000-item catalog held fold mode sparse under a 32 MiB budget" in r.stdout


@pytest.mark.parametrize("large", [False, True], ids=["default", "large"])
def test_seed_events_are_the_jax_drills(large):
    want = jax_value(NAME, "event_rows(drill.seed_events())",
                     argv=["--large"] if large else [])
    assert event_rows(port_drill.seed_events(large)) == want


def test_constants_are_the_jax_drills():
    names = ("ROUNDS", "WAIT_S", "LARGE_ITEMS", "LARGE_BUDGET")
    want = jax_value(NAME, "[" + ", ".join(f"drill.{n}" for n in names) + "]")
    assert [getattr(port_drill, n) for n in names] == want
    # --large runs 2 rounds in both
    assert jax_value(NAME, "drill.ROUNDS", argv=["--large"]) == 2


def test_cuda_without_a_card_is_refused():
    assert_cuda_refused(NAME)
