"""The port's CCO training op on the edge cases of its counts: indicators
against the JAX package on duplicated events, per-type thresholds and
counts past bf16's exact range; the dense and P-resident strategies bit
for bit; the exact int32 count product and marginals; and the mesh
variants on a one-process mesh (tests/test_torch_distributed.py runs them
over two ranks).

Inputs, tolerances and the indicator check are those of
tests/test_torch_cco.py (tests/_torch_cco_cases.py); counts and marginals
are exact.
"""

import numpy as np
import pytest
import torch

from predictionio_tpu_torch.ops import cco as port_cco

from _torch_cco_cases import (CORPORA, EDGE_CORPORA, JAX_ENVS, _kwargs,
                              check_cco_matches_jax, corpus, others, port_result)


@pytest.mark.parametrize("ref", sorted(JAX_ENVS))
@pytest.mark.parametrize("strategy", ["dense", "resident"])
@pytest.mark.parametrize("corpus", EDGE_CORPORA)
def test_cco_train_indicators_matches_jax(corpus, strategy, ref):
    check_cco_matches_jax(corpus, strategy, ref)


@pytest.mark.parametrize("name", CORPORA)
def test_dense_and_resident_strategies_are_bit_identical(name):
    dense, resident = port_result(name, "dense"), port_result(name, "resident")
    for event in dense:
        np.testing.assert_array_equal(dense[event][0].view(np.int32),
                                      resident[event][0].view(np.int32))
        np.testing.assert_array_equal(dense[event][1], resident[event][1])


@pytest.mark.parametrize("name", ["naive", "duplicates", "planted301", "planted4097"])
def test_dense_counts_and_marginals_are_exact(name):
    c = corpus(name)
    runner = port_cco._DenseRunner(c["pu"], c["pi"], c["n_users"], c["n_ip"],
                                   max(c["n_ip"], 128), torch.device("cpu"))
    P = np.zeros((c["n_users"], c["n_ip"]), np.int64)
    P[c["pu"], c["pi"]] = 1
    A = np.zeros((c["n_users"], c["n_it"]), np.int64)
    A[c["vu"], c["vi"]] = 1
    for self_pair, M in ((True, P), (False, A)):
        C, rc, cc = runner.counts(c["vu"], c["vi"], c["n_it"], self_pair=self_pair)
        want = P.T @ M
        np.testing.assert_array_equal(C.numpy()[:, :want.shape[1]], want)
        assert not C.numpy()[:, want.shape[1]:].any()
        np.testing.assert_array_equal(rc.numpy(), P.sum(0))
        np.testing.assert_array_equal(cc.numpy()[:want.shape[1]], M.sum(0))
    if name.startswith("planted"):
        n_big = int(name[len("planted"):])
        C, _, _ = runner.counts(None, None, c["n_ip"], self_pair=True)
        assert int(C[0, 1]) >= n_big and int(C[0, 2]) >= 301


def test_resident_count_product_is_exact_past_bf16():
    """One tile's product at planted counts of 4,097 and 301: exact int32."""
    c = corpus("planted4097")
    prim = port_cco._ResidentPrimary(c["pu"], c["pi"], c["n_users"], c["n_ip"],
                                     torch.device("cpu"))
    counts = port_cco._count_product(prim.pt, prim.pt[:8])[:c["n_ip"], :8]
    P = np.zeros((c["n_users"], c["n_ip"]), np.int64)
    P[c["pu"], c["pi"]] = 1
    np.testing.assert_array_equal(counts.numpy(), (P.T @ P)[:, :8])
    assert counts.dtype == torch.int32 and int(counts[0, 1]) >= 4097


def test_unported_strategies_raise_naming_the_roadmap():
    """Every strategy is ported: with both device budgets at 0 the chunked
    strategy trains (equal to the dense one), and every entry takes a mesh
    (a one-process mesh: the mesh's dense and chunked strategies, bit-equal
    to the dense tables)."""
    from predictionio_tpu_torch.parallel.mesh import MeshSpec, create_mesh

    c = corpus("train")
    mesh = create_mesh(MeshSpec(dp=1))
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv("PIO_CCO_SPARSE", "0")
        mp.setattr(port_cco, "_DENSE_C_BYTES", 0)
        mp.setattr(port_cco, "_TILED_P_BYTES", 0)
        got = port_cco.cco_train_indicators(c["pu"], c["pi"], others(c), c["n_users"],
                                            c["n_ip"], device="cpu", **_kwargs(c))
        chunked_mesh = port_cco.cco_train_indicators(
            c["pu"], c["pi"], others(c), c["n_users"], c["n_ip"], device="cpu", mesh=mesh,
            **_kwargs(c))
    finally:
        mp.undo()
    dense = port_result("train", "dense")
    dense_mesh = port_cco.cco_train_indicators(c["pu"], c["pi"], others(c), c["n_users"],
                                               c["n_ip"], device="cpu", mesh=mesh,
                                               **_kwargs(c))
    for tables in (got, chunked_mesh, dense_mesh):
        for event in dense:
            np.testing.assert_array_equal(tables[event][0], dense[event][0])
            np.testing.assert_array_equal(tables[event][1], dense[event][1])
    blocked = port_cco.block_interactions(c["pu"], c["pi"], c["n_users"], c["n_ip"])
    coo = [port_cco.cco_indicators_coo(c["pu"], c["pi"], c["pu"], c["pi"], c["n_users"],
                                       c["n_ip"], c["n_ip"], device="cpu", mesh=m)
           for m in (None, mesh)]
    blk = [port_cco.cco_indicators(blocked, blocked, n_total_users=c["n_users"],
                                   device="cpu", mesh=m) for m in (None, mesh)]
    for plain, meshed in (coo, blk):
        np.testing.assert_array_equal(meshed[0], plain[0])
        np.testing.assert_array_equal(meshed[1], plain[1])


@pytest.mark.parametrize("n", [1, 2, 7, 4097])
def test_counts_two_a_word_sum_exactly(n):
    """The mesh's all-reduce of counts two a word: packed buffers summed as
    int32 words, as the ranks' all-reduce sums them, unpack to the sum of
    the counts, up to the largest (2**15 - 1 users split over the ranks)."""
    g = torch.Generator().manual_seed(n)
    parts = [torch.randint(0, 1 << 14, (n,), generator=g, dtype=torch.int32)
             for _ in range(2)]
    parts[1][:1] = (1 << 15) - 1 - parts[0][:1]     # the largest sum
    words = port_cco._pack_pairs(parts[0]) + port_cco._pack_pairs(parts[1])
    assert words.numel() == (n + 1) // 2
    got = torch.empty(n, dtype=torch.int32)
    port_cco._unpack_pairs(words, got)
    assert torch.equal(got, parts[0] + parts[1])
