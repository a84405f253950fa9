"""The port's ``tools/check_plane_replication.py`` against the JAX
package's ``scripts/check_plane_replication.py``: a publisher and two
subscribers (the port's ``pio deploy`` as OS processes) converge, answer
byte-equal, stitch lineage and resume a killed subscriber on the CPU; the
probes and limits are the JAX drill's; without a card the default device
is refused."""

from predictionio_tpu_torch.tools import check_plane_replication as port_drill

from _torch_drill_cases import assert_cuda_refused, assert_passes_on_cpu, jax_literal

NAME = "check_plane_replication"


def test_port_drill_passes_on_cpu():
    assert_passes_on_cpu(NAME)


def test_probes_and_limits_are_the_jax_drills():
    for name in ("PROBES", "READY_S", "CONVERGE_S"):
        assert getattr(port_drill, name) == jax_literal(NAME, name), name


def test_cuda_without_a_card_is_refused():
    assert_cuda_refused(NAME)
