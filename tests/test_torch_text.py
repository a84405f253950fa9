"""The port's text featurization, embedding-bag MLP and text-classification
template against the JAX package.

- Tokens, FNV-1a hashes, hashed counts, token ids and masks: equal.
- tf-idf (fitted, and applied with a given idf): bit-equal.
- ``_mlp_run`` from one shared numpy init: parameters and the loss before
  each step within 1e-4 (absolute) of the JAX run.  ``mlp_train`` draws its
  own init from ``torch.Generator(seed)`` (not JAX's threefry), so it is
  held to its own seed: the same seed gives the same weights.
- The template from each package's memory store: ``read_training`` and
  ``read_eval``'s folds identical; NB and logistic regression answer every
  query with the JAX label and a confidence within 1e-4; the MLP, trained
  from its own init, is held to the JAX labels on the training texts it
  fits and its batch path to its single-query path.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.controller.engine import EngineParams as JaxEngineParams
from predictionio_tpu.models.text import engine as jax_text
from predictionio_tpu.ops import text as jax_ops
from predictionio_tpu_torch.controller import EngineParams
from predictionio_tpu_torch.models.text import engine as port_text
from predictionio_tpu_torch.ops import text as ops
from predictionio_tpu_torch.storage import set_storage as port_set_storage

from _torch_event_cases import T0, fill_both, port_memory_storage

MLP_ATOL = 1e-4
CONF_ATOL = 1e-4
APP = "textapp"
TEXTS = ["Free pills NOW!!! call 0800-555", "hello, how are you doing today?",
         "WIN a prize: it's free, reply YES", "meeting moved to 3pm, don't be late",
         "", "naïve café — résumé", "lol ok", "URGENT: your account won $1000 cash"]


@pytest.mark.parametrize("dim", [64, 4096])
def test_tokens_hashes_and_counts(dim):
    for t in TEXTS:
        assert ops.tokenize(t) == jax_ops.tokenize(t)
        for tok in ops.tokenize(t):
            assert ops.hash_token(tok, dim) == jax_ops.hash_token(tok, dim)
    np.testing.assert_array_equal(ops.hashing_vectorize(TEXTS, dim),
                                  jax_ops.hashing_vectorize(TEXTS, dim))
    for got, want in zip(ops.tokens_to_ids(TEXTS, dim, 5), jax_ops.tokens_to_ids(TEXTS, dim, 5)):
        np.testing.assert_array_equal(got, want)


def test_tfidf_bit_equal():
    counts = jax_ops.hashing_vectorize(TEXTS * 3, 128)
    x, idf = ops.tfidf_transform(counts, device="cpu")
    jx, jidf = jax_ops.tfidf_transform(counts)
    np.testing.assert_array_equal(idf, jidf)
    np.testing.assert_array_equal(x, jx)
    q = jax_ops.hashing_vectorize(["free cash now", "how are you"], 128)
    np.testing.assert_array_equal(ops.tfidf_transform(q, idf, device="cpu")[0],
                                  jax_ops.tfidf_transform(q, jidf)[0])


@pytest.mark.parametrize("iterations", [1, 10, 40])
def test_mlp_run_from_a_shared_init(iterations):
    rng = np.random.default_rng(iterations)
    vocab, emb, hid, c = 97, 8, 12, 3
    ids, mask = jax_ops.tokens_to_ids(TEXTS * 4, vocab, 6)
    y = rng.integers(0, c, len(ids)).astype(np.int32)
    p0 = (rng.normal(size=(vocab, emb)).astype(np.float32) * 0.05,
          (rng.normal(size=(emb, hid)) / np.sqrt(emb)).astype(np.float32),
          np.zeros(hid, np.float32),
          (rng.normal(size=(hid, c)) / np.sqrt(hid)).astype(np.float32),
          np.zeros(c, np.float32))
    jp, jl = jax_ops._mlp_run(tuple(jnp.asarray(p) for p in p0), jnp.asarray(ids),
                              jnp.asarray(mask), jnp.asarray(y), jnp.float32(1e-5),
                              iterations=iterations, learning_rate=0.02)
    tp, tl = ops._mlp_run(tuple(torch.tensor(p) for p in p0), torch.tensor(ids),
                          torch.tensor(mask), torch.tensor(y), np.float32(1e-5),
                          iterations=iterations, learning_rate=0.02)
    for g, w in zip(tp, jp):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=MLP_ATOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=MLP_ATOL)
    np.testing.assert_allclose(
        ops.mlp_predict_logits(tp, torch.tensor(ids), torch.tensor(mask)).numpy(),
        np.asarray(jax_ops.mlp_predict_logits(jp, ids, mask)), rtol=0, atol=MLP_ATOL)


def test_mlp_train_init_is_its_own_seed():
    ids, mask = jax_ops.tokens_to_ids(TEXTS, 50, 4)
    y = np.arange(len(TEXTS)) % 2
    a = ops.mlp_train(ids, mask, y, 2, 50, 4, 6, iterations=3, seed=5, device="cpu")
    b = ops.mlp_train(ids, mask, y, 2, 50, 4, 6, iterations=3, seed=5, device="cpu")
    c = ops.mlp_train(ids, mask, y, 2, 50, 4, 6, iterations=3, seed=6, device="cpu")
    assert all(np.array_equal(x, z) for x, z in zip(a, b))
    assert not np.array_equal(a[0], c[0])


# -- the template ---------------------------------------------------------------------


SPAM = ["win", "free", "cash", "prize", "urgent", "claim", "offer", "winner"]
HAM = ["meeting", "lunch", "tomorrow", "thanks", "see", "you", "later", "home"]


def _corpus(n=160, seed=9):
    rng = np.random.default_rng(seed)
    specs = []
    for k in range(n):
        spam = k % 3 == 0
        words = rng.choice(SPAM if spam else HAM, 5).tolist() + rng.choice(HAM + SPAM, 2).tolist()
        t = T0 + k
        specs.append(("train", "content", f"d{k}", None, None,
                      {"text": " ".join(words), "label": "spam" if spam else "ham"}, t, t))
    specs.append(("train", "content", "nolabel", None, None, {"text": "x"}, T0, T0))
    return specs


QUERIES = ["win free cash now", "see you at lunch tomorrow", "claim your prize",
           "thanks, home later", "", "winner meeting"]


@pytest.fixture()
def stores(mem_storage):
    port_store = port_memory_storage()
    port_set_storage(port_store)
    fill_both(mem_storage, port_store, APP, _corpus())
    yield mem_storage, port_store
    port_set_storage(None)


def _ep(mod, ep_cls, name, **params):
    cls = {"nb": mod.TextNBParams, "logreg": mod.TextLogRegParams, "mlp": mod.TextMLPParams}
    return ep_cls(data_source_params=mod.TextDSParams(app_name=APP),
                  algorithm_params_list=[(name, cls[name](**params))])


def test_read_training_and_folds(stores):
    g = port_text.TextDataSource(port_text.TextDSParams(app_name=APP, eval_k=3))
    w = jax_text.TextDataSource(jax_text.TextDSParams(app_name=APP, eval_k=3))
    gt, wt = g.read_training(), w.read_training()
    assert gt.texts == wt.texts and gt.labels == wt.labels and len(gt.texts) == 160
    np.testing.assert_array_equal(gt.y, wt.y)
    for (gtd, gi, gqa), (wtd, wi, wqa) in zip(g.read_eval(), w.read_eval(), strict=True):
        assert gi == wi and gtd.texts == wtd.texts
        assert [(q.text, a) for q, a in gqa] == [(q.text, a) for q, a in wqa]


@pytest.mark.parametrize("name, params", [("nb", {"dim": 256}),
                                          ("logreg", {"dim": 256, "iterations": 30})])
def test_nb_and_logreg_answer_as_the_jax_ones(stores, name, params):
    engine, ep = port_text.TextClassificationEngine.apply(), _ep(port_text, EngineParams, name,
                                                                 **params)
    jax_engine = jax_text.TextClassificationEngine.apply()
    jax_ep = _ep(jax_text, JaxEngineParams, name, **params)
    models, jax_models = engine.train(ep, device="cpu"), jax_engine.train(jax_ep)
    predict, predict_batch = engine.serving_bundle(ep, models)
    jax_predict = jax_engine.predictor(jax_ep, jax_models)
    batch = (predict_batch or (lambda qs: [predict(q) for q in qs]))(
        [port_text.TextQuery(q) for q in QUERIES])
    for q, via_batch in zip(QUERIES, batch):
        want = jax_predict(jax_text.TextQuery(q)).to_json()
        for got in (predict(port_text.TextQuery(q)).to_json(), via_batch.to_json()):
            assert got["label"] == want["label"]
            assert abs(got["confidence"] - want["confidence"]) <= CONF_ATOL


def test_mlp_learns_the_training_texts(stores):
    params = dict(vocab_size=512, max_len=8, embed_dim=8, hidden_dim=16, iterations=80,
                  learning_rate=0.05)
    engine, ep = port_text.TextClassificationEngine.apply(), _ep(port_text, EngineParams, "mlp",
                                                                 **params)
    (model,) = engine.train(ep, device="cpu")
    predict, predict_batch = engine.serving_bundle(ep, [model])
    td = port_text.TextDataSource(port_text.TextDSParams(app_name=APP)).read_training()
    queries = [port_text.TextQuery(t) for t in td.texts[:40]]
    got = [r.label for r in predict_batch(queries)]
    assert got == [predict(q).label for q in queries]
    assert np.mean([g == td.labels[y] for g, y in zip(got, td.y[:40])]) >= 0.95
