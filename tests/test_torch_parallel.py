"""The port's ``parallel`` package in one process, against the JAX
package's ``predictionio_tpu/parallel`` on the same inputs (JAX on its
8-device CPU mesh from tests/conftest.py).

``MeshSpec.resolve`` (every branch, the same results and messages),
``default_mesh``'s reading of ``PIO_MESH``, ``DistributedConfig.from_env``,
the single-process ``init_distributed`` no-op, ``shard_segments``,
``pad_to_multiple``, ``pad_rows_for_mesh``, ``process_local_rows`` and the
staging helpers.  A port mesh of several ranks is built here as a bare
``Mesh`` of rank ids (no process group): the helpers that only read its
shape and this rank's position run on it.  tests/test_torch_distributed.py
runs two ranks.
"""

import jax
import numpy as np
import pytest
import torch

import predictionio_tpu.parallel.distributed as jax_dist
import predictionio_tpu.parallel.mesh as jax_mesh
import predictionio_tpu.parallel.sharding as jax_sharding
import predictionio_tpu_torch.parallel as port_parallel
import predictionio_tpu_torch.parallel.distributed as port_dist
import predictionio_tpu_torch.parallel.mesh as port_mesh
import predictionio_tpu_torch.parallel.sharding as port_sharding

CPU = torch.device("cpu")


def _outcome(fn):
    try:
        return ("ok", fn())
    except ValueError as e:
        return ("ValueError", str(e))


def _ranks_mesh(dp, mp=1):
    """A port mesh of dp x mp ranks, this process rank 0, no group."""
    return port_mesh.Mesh(np.arange(dp * mp).reshape(dp, mp), ("dp", "mp"), device=CPU)


def test_exports_are_the_jax_packages():
    import predictionio_tpu.parallel as jax_parallel

    want = {n for n in dir(jax_parallel) if not n.startswith("_")}
    got = {n for n in dir(port_parallel) if not n.startswith("_")}
    assert want - {"distributed", "mesh", "sharding"} <= got


@pytest.mark.parametrize("dp,mp,n", [
    (-1, 1, 8), (-1, 2, 8), (4, 2, 8), (8, 1, 8), (2, 1, 2), (-1, 1, 1), (1, 1, 1),
    (0, 0, 4), (-1, 3, 8), (3, 1, 8), (2, 2, 8), (4, 1, 2), (2, 1, 1), (5, -1, 5)])
def test_mesh_spec_resolve_as_jax(dp, mp, n):
    got = _outcome(lambda: port_mesh.MeshSpec(dp=dp, mp=mp).resolve(n))
    want = _outcome(lambda: jax_mesh.MeshSpec(dp=dp, mp=mp).resolve(n))
    assert got == want


@pytest.mark.parametrize("conf", ["", "dp=4,mp=2", "mp=2", "dp=8", "junk,dp=2,mp=4"])
def test_default_mesh_reads_pio_mesh_as_jax(conf, monkeypatch):
    """The spec each package builds from ``PIO_MESH``; then the port's
    default mesh over its one rank."""
    seen = {}
    monkeypatch.setenv("PIO_MESH", conf)
    for name, mod in (("port", port_mesh), ("jax", jax_mesh)):
        monkeypatch.setattr(mod, "create_mesh", lambda spec, _n=name: seen.setdefault(_n, spec))
        mod.default_mesh()
    assert (seen["port"].dp, seen["port"].mp) == (seen["jax"].dp, seen["jax"].mp)
    monkeypatch.undo()
    monkeypatch.setenv("PIO_MESH", conf)
    spec = seen["port"]
    got = _outcome(lambda: port_mesh.default_mesh().shape)
    want = _outcome(lambda: dict(zip(("dp", "mp"), jax_mesh.MeshSpec(spec.dp, spec.mp)
                                     .resolve(1))))
    assert got == want


@pytest.mark.parametrize("env", [
    {}, {"PIO_NUM_PROCESSES": "1"},
    {"PIO_COORDINATOR_ADDRESS": "10.0.0.1:8476", "PIO_NUM_PROCESSES": "4",
     "PIO_PROCESS_ID": "2"},
    {"PIO_COORDINATOR_ADDRESS": "", "PIO_NUM_PROCESSES": "3"},
    {"PIO_COORDINATOR_ADDRESS": "h:1"}])
def test_config_from_env_as_jax(env, monkeypatch):
    for k in ("PIO_COORDINATOR_ADDRESS", "PIO_NUM_PROCESSES", "PIO_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got, want = port_dist.DistributedConfig.from_env(), jax_dist.DistributedConfig.from_env()
    assert (got.coordinator_address, got.num_processes, got.process_id,
            got.is_multi_process) == (want.coordinator_address, want.num_processes,
                                      want.process_id, want.is_multi_process)


def test_init_single_process_is_a_noop():
    cfg = port_dist.init_distributed(port_dist.DistributedConfig(None, 1, 0), device="cpu")
    want = jax_dist.init_distributed(jax_dist.DistributedConfig(None, 1, 0))
    assert cfg == port_dist.DistributedConfig(None, 1, 0)
    assert cfg.is_multi_process == want.is_multi_process is False
    assert not torch.distributed.is_initialized()
    assert (port_dist.process_count(), port_dist.process_index()) == (1, 0)
    assert port_dist.backend() is None and port_dist.local_device() is None
    mesh = port_mesh.create_mesh()
    assert mesh.shape == {"dp": 1, "mp": 1} and mesh.group("dp") is None
    t = torch.arange(4)
    assert port_dist.all_reduce_sum(t, mesh) is t
    assert port_dist.all_gather_rows(t, mesh) is t


def test_init_refuses_what_it_cannot_join(monkeypatch):
    """Several processes without a coordinator raise naming the variable (no
    TPU-pod autodetection); a CUDA rank without a card raises before any
    group is made; a process id out of range raises."""
    with pytest.raises(ValueError, match="PIO_COORDINATOR_ADDRESS"):
        port_dist.init_distributed(port_dist.DistributedConfig(None, 2, 0), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_dist.init_distributed(port_dist.DistributedConfig("127.0.0.1:1", 2, 0))
    with pytest.raises(ValueError, match="out of range"):
        port_dist.init_distributed(port_dist.DistributedConfig("127.0.0.1:1", 2, 2),
                                   device="cpu")
    assert not torch.distributed.is_initialized()


def test_backend_follows_the_topology(monkeypatch):
    cfg = port_dist.DistributedConfig("127.0.0.1:1", 2, 1)
    assert port_dist.choose_backend(CPU, cfg) == ("gloo", CPU)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert port_dist.choose_backend(torch.device("cuda"), cfg) == (
        "nccl", torch.device("cuda", 1))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)   # ranks share a card
    assert port_dist.choose_backend(torch.device("cuda"), cfg) == (
        "gloo", torch.device("cuda", 0))
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "1")                  # one rank on this host
    monkeypatch.setenv("LOCAL_RANK", "0")
    assert port_dist.choose_backend(torch.device("cuda"), cfg) == (
        "nccl", torch.device("cuda", 0))


@pytest.mark.parametrize("n_seg,n,i", [(23, 4, 0), (23, 4, 3), (2, 2, 1), (5, 1, 0),
                                       (0, 3, 2), (3, 5, 4), (2, 2, 2), (2, 2, -1)])
def test_shard_segments_as_jax(n_seg, n, i):
    segs = [f"seg-{k:05d}" for k in range(n_seg)]
    got = _outcome(lambda: port_dist.shard_segments(segs, n_processes=n, process_id=i))
    want = _outcome(lambda: jax_dist.shard_segments(segs, n_processes=n, process_id=i))
    assert got == want
    if got[0] == "ok":
        shares = [port_dist.shard_segments(segs, n, p) for p in range(n)]
        assert sorted(s for sh in shares for s in sh) == segs


@pytest.mark.parametrize("shape,multiple,axis,fill", [
    ((10, 3), 4, 0, 0), ((8, 3), 4, 0, 0), ((10, 3), 4, 1, -1.5), ((0,), 3, 0, 7),
    ((5,), 1, 0, 0), ((3, 2, 2), 2, 2, 9)])
def test_pad_to_multiple_as_jax(shape, multiple, axis, fill):
    arr = np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape)
    got = port_sharding.pad_to_multiple(arr, multiple, axis, fill)
    want = jax_sharding.pad_to_multiple(arr, multiple, axis, fill)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_rows,dp,mp,multiple", [
    (100, 8, 1, 8), (100, 4, 2, 8), (1, 2, 4, 8), (64, 8, 1, 8), (77, 2, 4, 1), (0, 4, 2, 8)])
def test_pad_rows_for_mesh_as_jax(n_rows, dp, mp, multiple):
    jmesh = jax_mesh.create_mesh(jax_mesh.MeshSpec(dp=dp, mp=mp))
    for axis in ("dp", "mp"):
        assert port_mesh.pad_rows_for_mesh(n_rows, _ranks_mesh(dp, mp), axis, multiple) \
            == jax_mesh.pad_rows_for_mesh(n_rows, jmesh, axis, multiple)


@pytest.mark.parametrize("dp,mp,me", [(8, 1, 0), (8, 1, 5), (4, 2, 3), (1, 1, 0), (2, 4, 6)])
def test_process_local_rows_as_jax(dp, mp, me, monkeypatch):
    """One rank a device here, one process per device position in JAX's
    simulated hosts (tests/test_distributed.py:86-111)."""
    class FakeDev:
        def __init__(self, pidx):
            self.process_index = pidx

    class FakeMesh:
        shape = {"dp": dp}
        devices = np.array([FakeDev(r) for r in range(dp * mp)]).reshape(dp, mp)

    monkeypatch.setattr(jax_dist, "process_index", lambda: me)
    monkeypatch.setattr(port_dist, "process_index", lambda: me)
    for n_rows in (8 * dp, 8 * dp + 1):
        got = _outcome(lambda: port_dist.process_local_rows(n_rows, _ranks_mesh(dp, mp)))
        assert got == _outcome(lambda: jax_dist.process_local_rows(n_rows, FakeMesh()))


def test_sharding_descriptors_and_staging(monkeypatch):
    """named_sharding/replicated/shard_rows name the JAX specs; stage_global,
    device_put_sharded_rows and host_staging_iterator hand each rank its
    contiguous rows (on one process, all of them, as JAX's device_put)."""
    mesh = _ranks_mesh(4, 1)
    jm = jax_mesh.create_mesh(jax_mesh.MeshSpec(dp=4, mp=2))
    for got, want in ((port_sharding.shard_rows(mesh, "dp", 3), jax_sharding.shard_rows(jm, "dp", 3)),
                      (port_sharding.replicated(mesh), jax_sharding.replicated(jm)),
                      (port_sharding.named_sharding(mesh, "dp", None),
                       jax_sharding.named_sharding(jm, "dp", None))):
        assert got.spec == tuple(want.spec)
    arr = np.arange(30, dtype=np.float32).reshape(10, 3)
    padded = port_sharding.pad_to_multiple(arr, 4)
    for me in range(4):
        monkeypatch.setattr(port_dist, "process_index", lambda: me)
        got = port_sharding.device_put_sharded_rows(arr, mesh, device="cpu")
        np.testing.assert_array_equal(got.numpy(), padded[3 * me:3 * me + 3])
        staged = list(port_mesh.host_staging_iterator([padded, padded[:8]], mesh,
                                                      device="cpu"))
        np.testing.assert_array_equal(staged[0].numpy(), padded[3 * me:3 * me + 3])
        np.testing.assert_array_equal(staged[1].numpy(), padded[2 * me:2 * me + 2])
        whole = port_sharding.stage_global(arr, port_sharding.replicated(mesh), "cpu")
        np.testing.assert_array_equal(whole.numpy(), arr)
    monkeypatch.undo()
    one = port_mesh.create_mesh()
    arr16 = np.arange(48, dtype=np.float32).reshape(16, 3)
    got = list(port_mesh.host_staging_iterator([arr16, arr16 * 2], one, device="cpu"))
    want = list(jax_mesh.host_staging_iterator([arr16, arr16 * 2], jax_mesh.create_mesh()))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    with pytest.raises(ValueError, match="do not divide"):
        port_sharding.stage_global(arr, port_sharding.shard_rows(mesh), "cpu")
    assert len(jax.devices()) == 8
