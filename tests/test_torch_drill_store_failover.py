"""The port's ``tools/check_store_failover.py`` against the JAX package's
``scripts/check_store_failover.py``: SIGKILL of a primary mid group commit,
torn replica tails and a partition mid scan on the port's sharded store,
with the JAX drill's verdict lines; the port's writer is the JAX writer
on the port's store."""

import subprocess
import sys

from predictionio_tpu_torch.tools import check_store_failover as port_drill

from _torch_drill_cases import REPO, TIMEOUT_S, jax_drill

JAX_DRILL = jax_drill("check_store_failover")


def _ok_lines(out: str):
    return [ln for ln in out.splitlines() if ln.startswith("ok: ")]


def test_port_drill_passes_with_the_jax_drills_verdicts(tmp_path):
    """Run from a directory outside the checkout: the writer child finds
    the port through the drill's own path."""
    port = subprocess.run(
        [sys.executable, str(REPO / "predictionio_tpu_torch" / "tools"
                             / "check_store_failover.py")],
        capture_output=True, text=True, timeout=TIMEOUT_S, cwd=tmp_path)
    assert port.returncode == 0, port.stdout + port.stderr
    jax = subprocess.run(
        [sys.executable, str(REPO / "scripts" / "check_store_failover.py")],
        capture_output=True, text=True, timeout=TIMEOUT_S, cwd=REPO)
    assert jax.returncode == 0, jax.stdout + jax.stderr
    # the acked count is the same 80: the writer is read until then
    assert _ok_lines(port.stdout) == _ok_lines(jax.stdout)
    assert len(_ok_lines(port.stdout)) == 4


def test_writer_is_the_jax_writer_on_the_port():
    args = ("/srv/store", "wK", 100_000)
    port = port_drill.writer_script(*args)
    assert "predictionio_tpu_torch.storage" in port
    assert port == JAX_DRILL.writer_script(*args).replace(
        "from predictionio_tpu.", "from predictionio_tpu_torch.")
    assert (port_drill.SHARDS, port_drill.APP_ID) == (JAX_DRILL.SHARDS, JAX_DRILL.APP_ID)


def test_port_drill_takes_no_device():
    r = subprocess.run(
        [sys.executable, "-m", "predictionio_tpu_torch.tools.check_store_failover",
         "--device", "cpu"],
        capture_output=True, text=True, timeout=TIMEOUT_S, cwd=REPO)
    assert r.returncode == 2 and "unrecognized arguments" in r.stderr, r.stderr
