"""The port's ``tools/check_serve_parity.py`` against the JAX package's
``scripts/check_serve_parity.py``: every serving path equal to the float
on the CPU, the commerce fixture's events and the query corpus equal to
the JAX drill's, and without a card the default device is refused."""

from predictionio_tpu_torch.storage.locator import set_storage
from predictionio_tpu_torch.tools import check_serve_parity as port_drill

from _torch_drill_cases import (assert_cuda_refused, assert_passes_on_cpu,
                                event_rows, jax_value)

NAME = "check_serve_parity"


def test_port_drill_passes_on_cpu():
    r = assert_passes_on_cpu(NAME)
    for phase in ("hotswap phase:", "plane phase:", "cache phase:"):
        assert phase in r.stdout, r.stdout


def test_fixture_is_the_jax_drills():
    """The events ``build_app`` writes (read back in the store's order)
    and the corpus's wire bodies, line for line."""
    storage = port_drill.build_app()
    try:
        app = storage.apps.get_by_name("parityapp")
        port_rows = event_rows(storage.l_events.find(app.id))
    finally:
        set_storage(None)
    jax_rows = jax_value(
        NAME, "(lambda st: event_rows(st.l_events.find("
              "st.apps.get_by_name('parityapp').id)))(drill.build_app())")
    assert len(port_rows) > 500
    assert port_rows == jax_rows
    assert port_drill.corpus_bodies() == jax_value(NAME, "drill.corpus_bodies()")


def test_cuda_without_a_card_is_refused():
    assert_cuda_refused(NAME)
