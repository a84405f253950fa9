"""Text featurization and the embedding-bag MLP classifier.

Counterpart of ``predictionio_tpu/ops/text.py`` (reference: the
text-classification template, tf-idf into MLlib NaiveBayes /
LogisticRegression, and BASELINE.json config #5, an embedding + MLP):

- the hashing vectorizer (FNV-1a 32-bit, fixed dim, no vocabulary) and the
  token-id encoder are host code, the JAX package's character for
  character;
- ``tfidf_transform`` runs on the device in float32;
- the embedding-bag MLP (token embeddings mean-pooled over the masked
  sequence, one ReLU layer, logits) trains with ``ops.logreg.Adam``, which
  is ``optax.adam``, one full-batch step after another as the JAX
  ``lax.scan`` runs them.

One deliberate difference: ``mlp_train`` draws its initial weights from a
``torch.Generator`` seeded with ``seed``, so the same seed does not give the
JAX package's threefry weights; ``_mlp_run`` takes its initial parameters,
as the JAX one does, so both packages train from one given start alike.
"""

from __future__ import annotations

import math
import re
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from predictionio_tpu_torch.device import resolve_device
from predictionio_tpu_torch.ops.logreg import adam_run

_TOKEN_RE = re.compile(r"[a-z0-9']+")


def tokenize(text: str) -> List[str]:
    return _TOKEN_RE.findall(text.lower())


def hash_token(token: str, dim: int) -> int:
    # FNV-1a 32-bit: stable across processes (unlike Python's hash())
    h = 2166136261
    for b in token.encode():
        h = ((h ^ b) * 16777619) & 0xFFFFFFFF
    return h % dim


def hashing_vectorize(texts: Sequence[str], dim: int = 4096) -> np.ndarray:
    """Token-count matrix [n, dim] via the hashing trick."""
    out = np.zeros((len(texts), dim), np.float32)
    for r, t in enumerate(texts):
        for tok in tokenize(t):
            out[r, hash_token(tok, dim)] += 1.0
    return out


def tfidf_transform_tensor(counts: torch.Tensor,
                           idf: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """L2-normalised tf-idf rows of a float32 count matrix on its device:
    (tfidf, idf); the idf is fitted here when not given."""
    if idf is None:
        n = counts.shape[0]
        df = torch.sum(counts > 0, dim=0).to(torch.float32)
        # a tensor numerator: a scalar one divides by a reciprocal multiply
        num = torch.tensor(1.0 + n, dtype=torch.float32, device=counts.device)
        idf = torch.log(num / (1.0 + df)) + 1.0
    tf = counts / torch.clamp_min(counts.sum(dim=1, keepdim=True), 1.0)
    x = tf * idf
    norms = torch.linalg.vector_norm(x, dim=1, keepdim=True)
    return x / torch.clamp_min(norms, 1e-8), idf


def tfidf_transform(counts: np.ndarray, idf: Optional[np.ndarray] = None,
                    device=None) -> Tuple[np.ndarray, np.ndarray]:
    """(tfidf, idf) as host arrays, computed on ``device`` (default
    ``"cuda"``).  Pass the training idf back in at serving time."""
    dev = resolve_device(device)
    c = torch.as_tensor(np.asarray(counts, np.float32)).to(dev)
    i = None if idf is None else torch.as_tensor(np.asarray(idf, np.float32)).to(dev)
    x, i = tfidf_transform_tensor(c, i)
    return x.cpu().numpy(), i.cpu().numpy()


def tokens_to_ids(texts: Sequence[str], vocab_size: int, max_len: int) -> Tuple[np.ndarray, np.ndarray]:
    """Hash tokens to ids, pad/truncate to max_len. Returns (ids, mask)."""
    ids = np.zeros((len(texts), max_len), np.int32)
    mask = np.zeros((len(texts), max_len), np.float32)
    for r, t in enumerate(texts):
        toks = tokenize(t)[:max_len]
        for c, tok in enumerate(toks):
            ids[r, c] = hash_token(tok, vocab_size)
            mask[r, c] = 1.0
    return ids, mask


# -- embedding-bag MLP -------------------------------------------------------


def mlp_forward(params, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Logits [n, C] of the embedding-bag MLP on the parameters' device."""
    emb, w1, b1, w2, b2 = params
    # [n, L, E] gather; F.embedding's backward sums the rows' gradients
    # without the sort an indexing backward takes
    e = torch.nn.functional.embedding(ids.to(torch.int64), emb)
    pooled = (e * mask[..., None]).sum(1) / torch.clamp_min(mask.sum(1, keepdim=True), 1.0)
    h = torch.relu(pooled @ w1 + b1)
    return h @ w2 + b2


def _mlp_run(params, ids: torch.Tensor, mask: torch.Tensor, y: torch.Tensor, l2, *,
             iterations: int, learning_rate: float):
    """``iterations`` full-batch Adam steps from ``params`` (five tensors:
    embeddings, w1, b1, w2, b2): (final params, the loss before each step)."""
    params = tuple(params)
    labels = y.to(torch.int64)

    def loss_fn(p):
        logits = mlp_forward(p, ids, mask)
        shifted = logits - logits.max(dim=-1, keepdim=True).values.detach()
        ce = (torch.logsumexp(shifted, dim=-1)
              - shifted.gather(-1, labels[:, None])[:, 0]).mean()
        reg = sum(torch.sum(w * w) for w in p[1::2])
        return ce + l2 * reg

    return adam_run(loss_fn, params, learning_rate, iterations)


def mlp_init(n_classes: int, vocab_size: int, embed_dim: int, hidden_dim: int,
             seed: int, device) -> Tuple[torch.Tensor, ...]:
    """Initial parameters from ``torch.Generator().manual_seed(seed)`` on the
    CPU (so a seed gives the same start on any device): normal embeddings
    x 0.05, normal layers x 1/sqrt(fan-in), zero biases."""
    gen = torch.Generator().manual_seed(int(seed))

    def normal(shape, scale):
        return (torch.randn(shape, generator=gen, dtype=torch.float32)
                * np.float32(scale)).to(device)

    return (normal((vocab_size, embed_dim), 0.05),
            normal((embed_dim, hidden_dim), 1.0 / math.sqrt(embed_dim)),
            torch.zeros(hidden_dim, dtype=torch.float32, device=device),
            normal((hidden_dim, n_classes), 1.0 / math.sqrt(hidden_dim)),
            torch.zeros(n_classes, dtype=torch.float32, device=device))


def mlp_train(
    ids: np.ndarray,
    mask: np.ndarray,
    y: np.ndarray,
    n_classes: int,
    vocab_size: int,
    embed_dim: int = 64,
    hidden_dim: int = 128,
    iterations: int = 200,
    learning_rate: float = 1e-2,
    l2: float = 1e-5,
    seed: int = 0,
    device=None,
):
    """Train the MLP on ``device`` (default ``"cuda"``); returns its five
    parameter arrays on the host."""
    dev = resolve_device(device)
    params = mlp_init(n_classes, vocab_size, embed_dim, hidden_dim, seed, dev)
    params, _ = _mlp_run(
        params, torch.as_tensor(np.asarray(ids, np.int64)).to(dev),
        torch.as_tensor(np.asarray(mask, np.float32)).to(dev),
        torch.as_tensor(np.asarray(y, np.int64)).to(dev), np.float32(l2),
        iterations=int(iterations), learning_rate=float(learning_rate))
    return tuple(p.cpu().numpy() for p in params)


def mlp_predict_logits(params, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return mlp_forward(params, ids, mask)


def mlp_predict(params, ids: torch.Tensor, mask: torch.Tensor) -> np.ndarray:
    return torch.argmax(mlp_predict_logits(params, ids, mask), dim=-1).cpu().numpy()
