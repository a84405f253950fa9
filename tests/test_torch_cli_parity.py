"""The port's ``pio`` console against the JAX one, command by command.

The same 24 invocations (version, status, app, accesskey, channel,
template list, export, a train without an engine, an undeploy of a port
nobody serves) run in order through each package's ``cli.main``, each
package on a fresh localfs home of its own.  Every invocation exits with
the same code in both, and prints the same stdout and the same stderr
once the random access keys and the homes are masked.  ``status`` names
its package in its title and reports the package's own device (JAX's
devices, torch's CUDA): those lines are left out of its comparison.
"""

import contextlib
import io
import os
import re
import socket

import pytest

from predictionio_tpu.cli import main as jax_cli
from predictionio_tpu.storage import set_storage as jax_set_storage
from predictionio_tpu_torch.cli import main as cli
from predictionio_tpu_torch.storage import set_storage

# "{key}" is the access key the package printed last, "{home}" its home,
# "{dead}" a local port nothing listens on
INVOCATIONS = [
    ["version"],
    ["status"],
    ["app", "list"],
    ["app", "new", "a"],
    ["app", "new", "a"],
    ["app", "new", "b", "--id", "7", "--description", "second"],
    ["app", "list"],
    ["app", "show", "a"],
    ["app", "show", "nosuch"],
    ["accesskey", "new", "a", "rate", "buy"],
    ["accesskey", "list", "a"],
    ["accesskey", "delete", "{key}"],
    ["channel", "new", "a", "ch1"],
    ["channel", "new", "a", "ch1"],
    ["app", "show", "a"],
    ["channel", "delete", "a", "ch1"],
    ["channel", "delete", "a", "ch1"],
    ["template", "list"],
    ["export", "--app-name", "a", "--output", "{home}/a.jsonl"],
    ["export", "--app-name", "nosuch", "--output", "{home}/nosuch.jsonl"],
    ["train"],
    ["undeploy", "--port", "{dead}", "--timeout", "1"],
    ["app", "data-delete", "a"],
    ["app", "delete", "a"],
]
_KEY = re.compile(r"(?<![\w-])[\w-]{43}(?![\w-])")   # secrets.token_urlsafe(32)
_DEVICE_LINES = ("  jax devices:", "  jax unavailable:", "  torch ", "  cuda devices:",
                 "  PIO_TORCH_DEVICE=")


def _dead_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_all(main, reset, home, dead):
    """Every invocation through ``main`` on a fresh default store at
    ``home``: (exit code, stdout, stderr) each, keys and home masked."""
    reset(None)
    key, results = "", []
    try:
        for argv in INVOCATIONS:
            argv = [a.format(key=key, home=home, dead=dead) for a in argv]
            out, err = io.StringIO(), io.StringIO()
            with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
                rc = main(argv)
            out, err = out.getvalue(), err.getvalue()
            key = (_KEY.findall(out) or [key])[-1]
            results.append((rc, _KEY.sub("<key>", out.replace(str(home), "<home>")),
                            err.replace(str(home), "<home>")))
    finally:
        reset(None)
    return results


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """(JAX results, port results) of the whole sequence."""
    work = tmp_path_factory.mktemp("cli_parity")
    dead = _dead_port()
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        for name in [n for n in os.environ if n.startswith("PIO_STORAGE_")]:
            mp.delenv(name)
        mp.setenv("PIO_TORCH_DEVICE", "cpu")
        mp.setenv("PIO_JAX_CACHE", "off")
        mp.chdir(work)
        for package, main, reset in (("jax", jax_cli.main, jax_set_storage),
                                     ("port", cli.main, set_storage)):
            home = work / package
            home.mkdir()
            mp.setenv("PIO_FS_BASEDIR", str(home))
            runs[package] = _run_all(main, reset, home, dead)
    return runs["jax"], runs["port"]


def _status_lines(out: str):
    return [line for line in out.splitlines()[1:] if not line.startswith(_DEVICE_LINES)]


@pytest.mark.parametrize("i", range(len(INVOCATIONS)),
                         ids=[" ".join(argv) for argv in INVOCATIONS])
def test_same_exit_code_and_output(both, i):
    (want_rc, want_out, want_err), (rc, out, err) = (run[i] for run in both)
    assert rc == want_rc
    if INVOCATIONS[i] == ["status"]:
        assert _status_lines(out) == _status_lines(want_out)
        assert len(_status_lines(out)) == 6
    else:
        assert out == want_out
    assert err == want_err
