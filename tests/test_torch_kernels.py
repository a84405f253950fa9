"""The port's kernel module and serving ops against the JAX package.

The same seeded numpy inputs go through the JAX function (the Pallas
kernel in interpret mode, as tests/test_pallas_kernels.py runs it) and its
counterpart in ``predictionio_tpu_torch`` on CPU tensors, which take the
kernels' plain PyTorch versions.  Scores agree within rtol 1e-5 (CPU
matmuls of XLA and torch sum in different orders); -inf positions and item
ids agree exactly.  The CUDA kernel itself is held against its plain
version in tests/test_torch_cuda.py, which runs only on a card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.ops import als as jax_als
from predictionio_tpu.ops import pallas_kernels as jax_pk
from predictionio_tpu_torch.ops import als as torch_als
from predictionio_tpu_torch.ops import hopper_kernels as hk
from predictionio_tpu_torch.ops.topk import topk_desc

RTOL, ATOL = 1e-5, 1e-5


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv("PIO_PALLAS", "interpret")


def _inputs(seed, b, k, n_items, mask_rate=0.1):
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(b, k)).astype(np.float32)
    v = rng.normal(size=(n_items, k)).astype(np.float32)
    seen = (rng.random((b, n_items)) < mask_rate).astype(np.float32)
    bias = rng.normal(size=n_items).astype(np.float32)
    return u, v, seen, bias


def _assert_scores(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("shape", [(5, 12, 300), (4, 16, 257)])
def test_masked_score_plain_matches_pallas(shape, with_bias):
    u, v, seen, bias = _inputs(0, *shape)
    want = jax_pk.masked_score_matmul(
        jnp.asarray(u), jnp.asarray(v), jnp.asarray(seen),
        jnp.asarray(bias) if with_bias else None)
    t_bias = torch.from_numpy(bias) if with_bias else None
    got = hk.masked_score_matmul_plain(
        torch.from_numpy(u), torch.from_numpy(v), torch.from_numpy(seen), t_bias)
    _assert_scores(got, want)


@pytest.mark.parametrize("mask_dtype", [torch.bool, torch.uint8, torch.float32])
def test_masked_score_cpu_tensors_take_plain_version(mask_dtype):
    u, v, seen, bias = _inputs(1, 5, 12, 300)
    args = (torch.from_numpy(u), torch.from_numpy(v),
            torch.from_numpy(seen).to(mask_dtype), torch.from_numpy(bias))
    before = hk.masked_score_matmul.launches
    got = hk.masked_score_matmul(*args)
    assert hk.masked_score_matmul.launches == before   # no kernel launched
    torch.testing.assert_close(got, hk.masked_score_matmul_plain(*args),
                               rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["dtype", "shape", "mask_dtype", "layout", "bias"])
def test_masked_score_rejects_bad_arguments(bad):
    u, v, seen, bias = (torch.from_numpy(a) for a in _inputs(2, 4, 8, 40))
    bias_arg = None
    if bad == "dtype":
        u = u.double()
    elif bad == "shape":
        v = v[:, :7].contiguous()
    elif bad == "mask_dtype":
        seen = seen.to(torch.int64)
    elif bad == "layout":
        v = v.T.contiguous().T
    elif bad == "bias":
        bias_arg = bias[:39]
    with pytest.raises((TypeError, ValueError)):
        hk.masked_score_matmul(u, v, seen, bias_arg)


# (B, K, I, mask dtype, row-strided mask, bias): either side of K1's
# streaming / tiled cut (B <= 8 / B > 8) and of its 32- and 64-row units,
# K and I no multiple of 4, one-item and one-k edges.  "Row-strided" is the
# layout ALS serving hands K1: ops.als.exclusion_mask's view of stride I + 1.
K1_CASES = [
    (1, 32, 4099, torch.uint8, True, False), (1, 1, 1, torch.bool, False, True),
    (1, 12, 3, torch.float32, False, False), (8, 32, 257, torch.uint8, True, True),
    (8, 33, 4099, torch.bool, True, False), (9, 32, 4099, torch.uint8, True, False),
    (9, 12, 257, torch.float32, True, True), (17, 33, 257, torch.uint8, True, True),
    (17, 1, 4099, torch.bool, True, False), (64, 32, 4099, torch.uint8, True, True),
    (64, 12, 3, torch.float32, False, False), (65, 33, 257, torch.uint8, True, False),
    (65, 32, 1, torch.bool, True, True),
]


def _k1_mask(seen, dtype, strided):
    """``seen`` (numpy, >0 = excluded) as a torch mask of ``dtype``; strided:
    in exclusion_mask's layout, built from id lists as serving builds it."""
    b, n = seen.shape
    if not strided:
        return torch.from_numpy(seen > 0).to(dtype)
    ids = np.where(seen > 0, np.arange(n), -1)
    mask = torch_als.exclusion_mask(ids, n, torch.device("cpu"))
    if dtype == torch.bool:
        mask = mask.view(torch.bool)
    elif dtype != torch.uint8:
        wide = torch.zeros((b, n + 1), dtype=dtype)
        wide[:, :n] = mask
        mask = wide[:, :n]
    assert b == 1 or mask.stride() == (n + 1, 1)
    return mask


_k1_pallas_cache = {}


def _k1_pallas(case):
    """The JAX interpret-mode Pallas K1 on the case's seeded inputs (once per
    case: both of the port's functions are held against it)."""
    if case not in _k1_pallas_cache:
        b, k, n, _, _, with_bias = case
        u, v, seen, bias = _inputs(sum((b, k, n)), b, k, n)
        want = jax_pk.masked_score_matmul(
            jnp.asarray(u), jnp.asarray(v), jnp.asarray(seen),
            jnp.asarray(bias) if with_bias else None)
        _k1_pallas_cache[case] = (u, v, seen, bias, np.asarray(want))
    return _k1_pallas_cache[case]


@pytest.mark.parametrize("fn", ["plain", "wrapper"])
@pytest.mark.parametrize("case", K1_CASES, ids=lambda c: "B{}-K{}-I{}-{}-{}-{}".format(
    c[0], c[1], c[2], str(c[3]).split(".")[-1], "strided" if c[4] else "packed",
    "bias" if c[5] else "nobias"))
def test_masked_score_contract_matches_pallas(case, fn):
    """K1's contract at the shapes where the CUDA kernel's paths split or go
    ragged, on every mask dtype and layout it takes: -inf exactly where the
    mask is set, finite scores within rtol/atol 1e-5 of the Pallas kernel."""
    b, k, n, dtype, strided, with_bias = case
    u, v, seen, bias, want = _k1_pallas(case)
    mask = _k1_mask(seen, dtype, strided)
    args = (torch.from_numpy(u), torch.from_numpy(v), mask,
            torch.from_numpy(bias) if with_bias else None)
    before = hk.masked_score_matmul.launches
    got = (hk.masked_score_matmul_plain if fn == "plain" else hk.masked_score_matmul)(*args)
    assert hk.masked_score_matmul.launches == before   # CPU tensors launch nothing
    assert got.shape == (b, n) and got.dtype == torch.float32
    np.testing.assert_array_equal(np.isneginf(got.numpy()), seen > 0)
    _assert_scores(got, want)


def test_recommend_batch_matches_pallas_and_xla():
    b, k, n_items, top_k = 4, 16, 257, 10
    u, v, seen, _ = _inputs(3, b, k, n_items, mask_rate=0.2)
    ju, jv, js = jnp.asarray(u), jnp.asarray(v), jnp.asarray(seen)
    s_pallas, i_pallas = jax_pk.recommend_batch_fused(ju, jv, js, top_k)
    s_xla, i_xla = jax_als._recommend_batch_xla(ju, jv, js, top_k)
    s, i = torch_als.recommend_batch(torch.from_numpy(u), torch.from_numpy(v),
                                     torch.from_numpy(seen), top_k)
    for want_s, want_i in ((s_pallas, i_pallas), (s_xla, i_xla)):
        np.testing.assert_array_equal(i.numpy(), np.asarray(want_i))
        np.testing.assert_allclose(s.numpy(), np.asarray(want_s),
                                   rtol=RTOL, atol=ATOL)


def test_recommend_batch_fused_with_bias_matches_pallas():
    u, v, seen, bias = _inputs(4, 5, 12, 300)
    s_want, i_want = jax_pk.recommend_batch_fused(
        jnp.asarray(u), jnp.asarray(v), jnp.asarray(seen), 20, jnp.asarray(bias))
    s, i = hk.recommend_batch_fused(torch.from_numpy(u), torch.from_numpy(v),
                                    torch.from_numpy(seen), 20,
                                    torch.from_numpy(bias))
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_want))
    np.testing.assert_allclose(s.numpy(), np.asarray(s_want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("k", [1, 7, 16, 64, 200])
def test_topk_desc_matches_lax_top_k_on_ties(k):
    rng = np.random.default_rng(5)
    s = rng.integers(-4, 4, size=(6, 200)).astype(np.float32) / 2
    s[0, 20:90] = -np.inf                  # a run of -inf
    s[1, :] = 0.0                          # one value everywhere
    s[2, 150:] = -np.inf
    s[3, ::3] = s[3, 1]                    # planted exact ties
    s[4, :] = np.repeat(rng.normal(size=40).astype(np.float32), 5)  # duplicated items
    want_v, want_i = jax.lax.top_k(jnp.asarray(s), k)
    got_v, got_i = topk_desc(torch.from_numpy(s), k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def test_recommend_with_duplicated_item_rows_keeps_tie_order():
    """Items with identical factor rows score exactly equal in both
    packages; the lower item id must come first, as in lax.top_k."""
    rng = np.random.default_rng(6)
    v = np.repeat(rng.normal(size=(30, 8)).astype(np.float32), 4, axis=0)
    u = rng.normal(size=(3, 8)).astype(np.float32)
    excl = np.full((3, 16), -1, np.int32)
    excl[1, :2] = [0, 5]
    want = jax_als.recommend_batch_excl(jnp.asarray(u), jnp.asarray(v),
                                        jnp.asarray(excl), 32)
    got = torch_als.recommend_batch_excl(torch.from_numpy(u),
                                         torch.from_numpy(v), excl, 32)
    np.testing.assert_array_equal(got[:, 1].numpy(), np.asarray(want)[:, 1])
    np.testing.assert_allclose(got[:, 0].numpy(), np.asarray(want)[:, 0],
                               rtol=RTOL, atol=ATOL)


def test_recommend_scores_excl_matches_jax_and_keeps_item_zero():
    rng = np.random.default_rng(7)
    n_items, k = 120, 10
    v = rng.normal(size=(n_items, k)).astype(np.float32)
    # a long item 0 and a user vector along it: item 0 ranks first unless
    # it is excluded
    v[0] *= 5
    u = v[0].copy()
    for ids in ([], [3, 17], [0, 3]):
        excl = jax_als.pad_ids(ids)
        np.testing.assert_array_equal(excl, torch_als.pad_ids(ids))
        want = np.asarray(jax_als.recommend_scores_excl(
            jnp.asarray(u), jnp.asarray(v), jnp.asarray(excl), 16))
        got = torch_als.recommend_scores_excl(
            torch.from_numpy(u), torch.from_numpy(v), excl, 16).numpy()
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_allclose(got[0], want[0], rtol=RTOL, atol=ATOL)
        assert (got[1, 0] == 0) == (0 not in ids)   # -1 padding spares item 0


def test_recommend_batch_excl_matches_jax():
    rng = np.random.default_rng(8)
    b, k, n_items = 6, 12, 300
    u = rng.normal(size=(b, k)).astype(np.float32)
    v = rng.normal(size=(n_items, k)).astype(np.float32)
    excl = np.full((b, 32), -1, np.int32)
    for r in range(b):
        ids = rng.choice(n_items, size=r * 5, replace=False)
        excl[r, :len(ids)] = ids
    excl[2, :3] = [0, 0, 7]                # duplicates, item 0 listed
    want = np.asarray(jax_als.recommend_batch_excl(
        jnp.asarray(u), jnp.asarray(v), jnp.asarray(excl), 64))
    got = torch_als.recommend_batch_excl(torch.from_numpy(u), torch.from_numpy(v),
                                         excl, 64).numpy()
    np.testing.assert_array_equal(got[:, 1], want[:, 1])
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=RTOL, atol=ATOL)


def test_exclusion_mask_padding_and_out_of_range_ids():
    excl = np.array([[-1, -1, -1], [0, -1, 2], [5, 99, -1]], np.int32)
    mask = torch_als.exclusion_mask(excl, 6, torch.device("cpu"))
    want = np.zeros((3, 6), np.uint8)
    want[1, [0, 2]] = 1
    want[2, 5] = 1
    np.testing.assert_array_equal(mask.numpy(), want)


def test_recommend_scores_dense_mask_matches_jax():
    u, v, seen, _ = _inputs(9, 1, 12, 300)
    ws, wi = jax_als.recommend_scores(jnp.asarray(u[0]), jnp.asarray(v),
                                      jnp.asarray(seen[0]), 25)
    s, i = torch_als.recommend_scores(torch.from_numpy(u[0]), torch.from_numpy(v),
                                      torch.from_numpy(seen[0]), 25)
    np.testing.assert_array_equal(i.numpy(), np.asarray(wi))
    np.testing.assert_allclose(s.numpy(), np.asarray(ws), rtol=RTOL, atol=ATOL)


def test_build_is_content_keyed_and_raises_on_a_failed_build(tmp_path, monkeypatch):
    """The build plumbing with a stand-in nvcc (the real one compiles only
    where a card is): one artifact per source content, no rebuild when it
    exists, the compiler's report kept, and an error on a failed build."""
    import os
    import sys

    from predictionio_tpu_torch.ops import build

    fake = tmp_path / "bin" / "nvcc"
    fake.parent.mkdir()
    fake.write_text(
        f"#!{sys.executable}\n"
        "import sys\n"
        "args = sys.argv[1:]\n"
        "if 'BROKEN' in open(args[-1]).read():\n"
        "    print('error: broken source'); sys.exit(1)\n"
        "open(args[args.index('-o') + 1], 'w').write('lib')\n"
        "print('ptxas info    : Used 8 registers')\n")
    fake.chmod(0o755)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in build.SIGNATURES:            # one stand-in source per kernel
        (csrc / f"{name}.cu").write_text(f"// {name} v1\n")
    monkeypatch.setenv("PATH", f"{fake.parent}:{os.environ['PATH']}")
    monkeypatch.setattr(build, "CSRC_DIR", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "build_logs", {})

    build.build_all()
    first = build.artifact("masked_score")
    assert first.exists() and "Used 8 registers" in build.build_logs["masked_score"]
    assert sorted(build.build_logs) == sorted(build.SIGNATURES)   # all, at once
    build.build_logs.clear()
    build.build_all()                       # artifact exists: no nvcc run
    assert build.build_logs == {}
    (csrc / "masked_score.cu").write_text("// v2 BROKEN\n")
    assert build.artifact("masked_score") != first
    with pytest.raises(RuntimeError, match="broken source"):
        build.build_all()
    assert not build.artifact("masked_score").exists()
    assert list((tmp_path / "_build").glob("*.tmp")) == []
