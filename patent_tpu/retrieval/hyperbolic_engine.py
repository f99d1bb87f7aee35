"""Hyperbolic retrieval: trained Poincaré encoder + geodesic top-k index.

Bridges the training side (train_hyp on precomputed CLIP features —
reference src/train.py:1047-1757) to the serving side: encode gallery
feature rows into the ball with the trained encoder, index them, and answer
queries by geodesic distance with the same blockwise/sharded exact top-k
used for cosine retrieval.  This is BASELINE.json config 3 ("Hyperbolic
head: Poincaré projection + Möbius-distance retrieval") as a first-class
engine — the reference only ever ranks label embeddings (train.py:3228),
never gallery figures, so image-to-image hyperbolic retrieval is a
capability extension.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Mapping, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..metrics import RetrievalMetrics, evaluate_rankings
from .index import EmbeddingIndex

if TYPE_CHECKING:
    from ..models.hyperbolic import HyperbolicEmbeddingModel


class HyperbolicRetrievalEngine:
    """Exact geodesic-distance retrieval over hyperbolically-encoded figures.

    Args:
        model/params: a trained HyperbolicEmbeddingModel (train_hyp output).
        features: [N, D] Euclidean figure features (the reference's
            precomputed CLIP features, training_data.npz X_figures).
        names: per-row figure names (image-index order).
    """

    def __init__(self, model: "HyperbolicEmbeddingModel", params: dict,
                 features: np.ndarray, names: Sequence[str],
                 batch_size: int = 512, mesh=None, quantized: bool = False):
        """``quantized=True``: the gallery lives on device as per-row int8
        + f32 affine rows and searches run the int8 Poincaré candidate
        stage with an exact f64 re-rank (retrieval/index.
        topk_search_poincare_fast) at a quarter of the f32 device memory."""
        self.model = model
        self.params = params
        self.c = model.c
        self.batch_size = batch_size
        self._encode = jax.jit(
            lambda p, x: model.apply({"params": p}, x, deterministic=True))
        gallery = self.encode_features(features)
        self.index = EmbeddingIndex(gallery, list(names),
                                    similarity="poincare", c=self.c,
                                    mesh=mesh, quantized=quantized)

    def encode_features(self, features: np.ndarray) -> np.ndarray:
        xs = np.asarray(features, np.float32)
        out = []
        for s in range(0, len(xs), self.batch_size):
            chunk = xs[s:s + self.batch_size]
            pad = self.batch_size - len(chunk)
            if pad:
                chunk = np.pad(chunk, ((0, pad), (0, 0)))
            enc = np.asarray(self._encode(self.params, jnp.asarray(chunk)))
            out.append(enc[:self.batch_size - pad])
        return np.concatenate(out, axis=0) if out else np.zeros((0, 0))

    def retrieve(self, query_features: np.ndarray, k: int = 20
                 ) -> list[list[tuple[str, float]]]:
        """Per query: [(gallery name, −geodesic distance), ...] best-first."""
        q = self.encode_features(np.atleast_2d(query_features))
        return self.index.search_names(q, k=k)

    def rank_all(self, query_features: np.ndarray,
                 query_names: Sequence[str]) -> dict[str, list[str]]:
        q = self.encode_features(np.atleast_2d(query_features))
        _vals, idx = self.index.search(q, k=len(self.index))
        return {qn: [self.index.names[j] for j in row]
                for qn, row in zip(query_names, idx)}

    def evaluate(self, query_features: np.ndarray,
                 query_names: Sequence[str],
                 ground_truth: Mapping[str, Mapping],
                 positives_key: str = "patent_positives") -> RetrievalMetrics:
        """The reference metric battery (retrieval.ipynb cell 3) over
        geodesic rankings."""
        rankings = self.rank_all(query_features, query_names)
        return evaluate_rankings(rankings, ground_truth,
                                 positives_key=positives_key)
