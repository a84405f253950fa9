"""Prefork / SO_REUSEPORT worker machinery shared by the REST servers
(counterpart of ``predictionio_tpu/api/prefork.py``; children run
``python -m predictionio_tpu_torch.cli.main``).

CPython's GIL caps one process at roughly single-core throughput, so both
the query server (``pio deploy --workers N``) and the event server
(``pio eventserver --workers N``) scale across cores the same way: the
parent binds the port with SO_REUSEPORT, then spawns N−1 extra OS
processes that bind the SAME port — the kernel load-balances accepted
connections across all listeners (the analogue of the reference running
several spray nodes behind a balancer).

Each worker runs http_util's event-loop front end: one loop thread
owning every socket plus a small handler pool (PIO_HTTP_POOL, default ≈
cores).  Worker count × per-worker handler parallelism is the node's
concurrency budget — size ``--workers`` toward cores and leave the
per-worker pool at its default rather than multiplying both.

This module holds the machinery both servers share:

- ``watch_parent_process`` / ``maybe_watch_parent``: a child exits when
  its spawning parent dies, so a killed/crashed parent never strands
  orphan workers on the port;
- ``spawn_workers``: fork the extra workers (marked via ``PIO_PREFORK_CHILD``
  so they self-arm the parent watch), with a reaper thread per child that
  logs non-clean exits and ``wait()``s them (no zombies);
- ``stop_workers`` / ``wire_shutdown``: tear the children down with the
  parent's HTTP server, however it is shut down (``shutdown()`` /
  ``server_close()``, ``/stop``, or ``pio undeploy``);
- ``plane_child_env``: the environment that makes a query worker a pure
  reader of the group's model plane (``streaming/plane.py``).

Workers resolve storage from the ``PIO_STORAGE_*`` environment — a
programmatic storage object cannot cross the process boundary.
"""

from __future__ import annotations

import logging
import os
import subprocess
import threading
from typing import Callable, Dict, List, Optional

_log = logging.getLogger("pio.prefork")

CHILD_ENV = "PIO_PREFORK_CHILD"


def is_prefork_child() -> bool:
    """True in a worker process spawned by ``spawn_workers``."""
    return os.environ.get(CHILD_ENV) == "1"


def plane_child_env(plane_dir: Optional[str]) -> Dict[str, str]:
    """A query worker's environment in a plane group: the plane forced on
    at the parent's directory (the worker watches and maps it, never
    publishes); empty without a plane."""
    if plane_dir is None:
        return {}
    return {"PIO_MODEL_PLANE": "on", "PIO_MODEL_PLANE_DIR": plane_dir}


def watch_parent_process(log: Optional[logging.Logger] = None) -> None:
    """Prefork child: exit when the spawning parent is gone (reparented),
    so a killed/crashed parent never strands orphan workers on the port."""
    log = log or _log
    parent = os.getppid()

    def watch():
        import time as _time

        while True:
            _time.sleep(2.0)
            if os.getppid() != parent:
                log.info("prefork worker: parent gone; exiting")
                os._exit(0)

    threading.Thread(target=watch, daemon=True,
                     name="pio-parent-watch").start()


def maybe_watch_parent(log: Optional[logging.Logger] = None) -> None:
    """Arm the parent-death watch iff this process is a prefork child we
    spawned — a programmatic caller binding with reuse_port behind their
    own balancer must not get a server that self-terminates when its
    launcher exits."""
    if is_prefork_child():
        watch_parent_process(log)


def spawn_workers(
    count: int,
    build_cmd: Callable[[int], List[str]],
    build_env: Optional[Callable[[int], Dict[str, str]]] = None,
    log: Optional[logging.Logger] = None,
) -> List[subprocess.Popen]:
    """Spawn ``count`` extra worker processes.

    ``build_cmd(i)`` returns worker *i*'s argv (typically re-invoking the
    CLI with the parent's BOUND port and an internal ``--reuse-port``
    flag); ``build_env(i)`` returns extra environment entries for worker
    *i* (e.g. a per-writer storage tag).  Every child inherits the
    parent's environment plus ``PIO_PREFORK_CHILD=1``, which arms its
    parent-death watch via ``maybe_watch_parent``.

    A reaper thread per child surfaces startup deaths (a worker that dies
    at bind time would otherwise silently leave the port at 1/N capacity)
    and ``wait()``s so no zombies accumulate."""
    log = log or _log
    cores = os.cpu_count() or 1
    if count + 1 > cores:
        log.warning(
            "--workers %d exceeds %d CPU core(s): extra workers contend "
            "instead of scaling", count + 1, cores)
    procs: List[subprocess.Popen] = []
    for w in range(count):
        env = {**os.environ, CHILD_ENV: "1"}
        if build_env is not None:
            env.update(build_env(w))
        procs.append(subprocess.Popen(build_cmd(w), env=env))

    def _reap(p: subprocess.Popen, idx: int) -> None:
        rc = p.wait()
        if rc not in (0, -15):   # -15: our own terminate()
            log.warning("prefork worker %d exited with code %s", idx, rc)

    for idx, p in enumerate(procs):
        threading.Thread(target=_reap, args=(p, idx), daemon=True).start()
    if count:
        log.info("prefork: %d extra worker process(es)", count)
    return procs


def stop_workers(procs: List[subprocess.Popen]) -> None:
    """Terminate the children, escalating to kill after a grace period."""
    for p in procs:
        if p.poll() is None:
            p.terminate()
    for p in procs:
        try:
            p.wait(timeout=10)
        except Exception:
            p.kill()


def wire_metrics_cleanup(httpd, metrics_dir: str) -> None:
    """Parent side of cross-worker metrics teardown: once the server
    closes (children already stopped by the wire_shutdown wrapper
    installed BEFORE this one), stop the snapshot flusher and remove the
    per-worker snapshot directory."""
    import shutil

    from predictionio_tpu_torch.obs import metrics as obs_metrics

    orig_close = httpd.server_close

    def _close_then_cleanup():
        orig_close()
        obs_metrics.stop_worker_flusher()
        shutil.rmtree(metrics_dir, ignore_errors=True)

    httpd.server_close = _close_then_cleanup


def wire_shutdown(httpd, procs: List[subprocess.Popen],
                  before: Optional[Callable[[], None]] = None) -> None:
    """Make ``httpd.server_close()`` also run ``before()`` and stop the
    prefork workers — so the children die with the parent however it is
    shut down (``shutdown()``/``server_close()``, ``/stop``, or
    ``pio undeploy``)."""
    orig_close = httpd.server_close

    def _close_and_stop_workers():
        if before is not None:
            before()
        stop_workers(procs)
        orig_close()

    httpd.server_close = _close_and_stop_workers
