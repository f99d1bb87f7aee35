"""Hyperbolic image-to-image retrieval: train_hyp output → Poincaré index →
reference metric battery; training must improve retrieval quality."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from patent_tpu.data import (build_feature_matrix, build_hetero_graph,
                             prepare_training_data, synthetic)
from patent_tpu.models.hyperbolic import HyperbolicEmbeddingModel
from patent_tpu.retrieval.hyperbolic_engine import HyperbolicRetrievalEngine
from patent_tpu.train.train_hyp import train_hyperbolic_retrieval
from patent_tpu.utils.config import HypTrainConfig
from patent_tpu.utils.logging import MetricsLogger


@pytest.fixture(scope="module")
def trained():
    records = synthetic.synthetic_records(num_patents=20, figures_per_patent=4,
                                          seed=3)
    graph = build_hetero_graph(records)
    feats = synthetic.synthetic_features(records, dim=32, seed=3, noise=0.3)
    x = build_feature_matrix(graph, feats, feature_dim=32)
    td = prepare_training_data(graph, x, neg_ratio=4, fig_pair_ratio=2, seed=3)
    cfg = HypTrainConfig(embed_dim=16, hidden_dims=(32,), curvature=1.0,
                         epochs=15, batch_size=32, learning_rate=1e-2,
                         patience=15, figure_pair_weight=0.5,
                         constraint_penalty=1.0, retrieval_penalty=4.0,
                         use_dropout=False)
    model = HyperbolicEmbeddingModel(
        feature_dim=32, embed_dim=16, label_num=td.num_labels,
        hidden_dims=(32,), c=1.0)
    init_params = model.init(jax.random.key(0), jnp.zeros((1, 32)))["params"]
    best_params, _ = train_hyperbolic_retrieval(td, cfg,
                                                logger=MetricsLogger(print_every=0))
    names = [r.figure_id for r in records]
    return records, graph, td, model, init_params, best_params, names


def _split_eval(records, td, names):
    """Queries: first figure of each patent; gallery: the rest."""
    by_patent = {}
    for i, r in enumerate(records):
        by_patent.setdefault(r.patent_id, []).append(i)
    q_rows, g_rows = [], []
    for rows in by_patent.values():
        q_rows.append(rows[0])
        g_rows.extend(rows[1:])
    gt = {}
    for q in q_rows:
        patent = records[q].patent_id
        gt[names[q]] = {"patent_positives": [
            names[g] for g in g_rows if records[g].patent_id == patent],
            "cpc_positives": []}
    return q_rows, g_rows, gt


def test_hyperbolic_retrieval_improves_with_training(trained):
    records, graph, td, model, init_params, best_params, names = trained
    q_rows, g_rows, gt = _split_eval(records, td, names)
    feats = td.x_figures

    def run(params):
        eng = HyperbolicRetrievalEngine(
            model, params, feats[g_rows], [names[g] for g in g_rows],
            batch_size=64)
        return eng.evaluate(feats[q_rows], [names[q] for q in q_rows], gt)

    m_init = run(init_params)
    m_best = run(best_params)
    assert m_best.num_queries == len(q_rows)
    assert m_best.mrr >= m_init.mrr
    assert m_best.mrr > 0.5, f"trained hyperbolic retrieval too weak: {m_best}"


def test_retrieve_api(trained):
    records, graph, td, model, _init, best_params, names = trained
    q_rows, g_rows, _gt = _split_eval(records, td, names)
    eng = HyperbolicRetrievalEngine(
        model, best_params, td.x_figures[g_rows],
        [names[g] for g in g_rows], batch_size=64)
    res = eng.retrieve(td.x_figures[q_rows[0]], k=5)
    assert len(res) == 1 and len(res[0]) == 5
    # scores are negative geodesic distances: sorted descending
    scores = [s for _n, s in res[0]]
    assert scores == sorted(scores, reverse=True)
    assert all(s <= 0 for s in scores)


def test_quantized_engine_matches_exact(trained):
    """quantized=True (int8 Poincaré candidates + exact re-rank) returns
    the exact engine's rankings on TRAINED ball embeddings — the serving
    activation statistics, not synthetic noise."""
    records, graph, td, model, _init, best_params, names = trained
    q_rows, g_rows, _gt = _split_eval(records, td, names)
    fast = HyperbolicRetrievalEngine(
        model, best_params, td.x_figures[g_rows],
        [names[g] for g in g_rows], batch_size=64, quantized=True)
    exact = HyperbolicRetrievalEngine(
        model, best_params, td.x_figures[g_rows],
        [names[g] for g in g_rows], batch_size=64)
    fv, fi = fast.index.search(fast.encode_features(td.x_figures[q_rows]), k=8)
    ev, ei = exact.index.search(exact.encode_features(td.x_figures[q_rows]), k=8)
    np.testing.assert_array_equal(fi, ei)
    np.testing.assert_allclose(fv, ev, rtol=2e-4, atol=2e-4)
