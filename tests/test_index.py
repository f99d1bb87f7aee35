"""Sharded exact top-k index tests vs numpy brute force (reference protocol:
full cosine matrix + argsort, retrieval.ipynb cell 3)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import Mesh

from patent_tpu.retrieval.index import EmbeddingIndex, sharded_topk_search, topk_search


def brute_force_cosine(q, g, k):
    qn = q / np.linalg.norm(q, axis=-1, keepdims=True)
    gn = g / np.linalg.norm(g, axis=-1, keepdims=True)
    sims = qn @ gn.T
    idx = np.argsort(-sims, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(sims, idx, axis=1), idx


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    gallery = rng.standard_normal((1000, 64)).astype(np.float32)
    queries = rng.standard_normal((17, 64)).astype(np.float32)
    return queries, gallery


def test_topk_small_gallery(data):
    queries, gallery = data
    vals, idx = topk_search(jnp.asarray(queries), jnp.asarray(gallery[:50]), k=10)
    bv, bi = brute_force_cosine(queries, gallery[:50], 10)
    np.testing.assert_array_equal(np.asarray(idx), bi)
    np.testing.assert_allclose(np.asarray(vals), bv, atol=1e-5)


def test_topk_blockwise_matches_brute_force(data):
    queries, gallery = data
    # block_size smaller than gallery → exercises the scan merge path
    vals, idx = topk_search(jnp.asarray(queries), jnp.asarray(gallery),
                            k=10, block_size=128)
    bv, bi = brute_force_cosine(queries, gallery, 10)
    np.testing.assert_array_equal(np.asarray(idx), bi)
    np.testing.assert_allclose(np.asarray(vals), bv, atol=1e-5)


def test_quantized_index_matches_brute_force(data):
    """int8 candidates + f32 re-rank: exact top-10 on random vectors (the
    hardest case — near-tie scores everywhere) at pool depth 8k."""
    queries, gallery = data
    ix = EmbeddingIndex(gallery, [f"g{i}" for i in range(len(gallery))],
                        quantized=True)
    vals, idx = ix.search(queries, k=10, block_size=256)
    bv, bi = brute_force_cosine(queries, gallery, 10)
    overlap = np.mean([len(set(idx[i]) & set(bi[i])) / 10
                       for i in range(len(queries))])
    assert overlap >= 0.99, f"quantized recall@10 vs brute force: {overlap}"
    # returned scores are exact f32 cosines, best-first
    np.testing.assert_allclose(
        vals, np.sort(vals, axis=1)[:, ::-1], atol=0)
    rows_exact = (idx == bi).all(axis=1)
    assert rows_exact.mean() >= 0.9


def test_quantized_index_exact_on_clustered(data):
    """On clustered (retrieval-regime) data the quantized index is exactly
    the f32 index: margins dwarf the int8 candidate noise."""
    rng = np.random.default_rng(3)
    centers = rng.standard_normal((20, 64)).astype(np.float32)
    gallery = np.concatenate([c + 0.05 * rng.standard_normal((50, 64))
                              for c in centers]).astype(np.float32)
    queries = (centers + 0.05 * rng.standard_normal((20, 64))).astype(np.float32)
    f32 = EmbeddingIndex(gallery, [f"g{i}" for i in range(len(gallery))])
    q8 = EmbeddingIndex(gallery, [f"g{i}" for i in range(len(gallery))],
                        quantized=True)
    _v1, i1 = f32.search(queries, k=10)
    _v2, i2 = q8.search(queries, k=10)
    np.testing.assert_array_equal(i1, i2)


def test_quantized_index_full_ranking(data):
    """k = full gallery (the evaluate path) returns the exact f32 ranking
    without the candidate stage (no [Q, N, D] re-rank blowup)."""
    queries, gallery = data
    ix = EmbeddingIndex(gallery, [f"g{i}" for i in range(len(gallery))],
                        quantized=True)
    vals, idx = ix.search(queries[:5], k=len(gallery))
    bv, bi = brute_force_cosine(queries[:5], gallery, len(gallery))
    np.testing.assert_array_equal(idx, bi)
    np.testing.assert_allclose(vals, bv, atol=1e-5)


def test_quantized_index_sharded_matches_single_device(data, eight_devices):
    """int8 candidates sharded over an 8-device mesh + host re-rank equal
    the single-device quantized search."""
    queries, gallery = data
    names = [f"g{i}" for i in range(len(gallery))]
    single = EmbeddingIndex(gallery, names, quantized=True)
    mesh = Mesh(np.array(eight_devices), ("data",))
    sharded = EmbeddingIndex(gallery, names, quantized=True, mesh=mesh)
    v1, i1 = single.search(queries, k=10, block_size=256)
    v2, i2 = sharded.search(queries, k=10, block_size=256)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(v1, v2, atol=1e-6)


def test_quantized_index_guards():
    g = np.eye(8, 16, dtype=np.float32)
    with pytest.raises(ValueError, match="cosine and poincare only"):
        EmbeddingIndex(g, [f"g{i}" for i in range(8)], similarity="dot",
                       quantized=True)


def test_topk_k_larger_than_gallery(data):
    queries, _ = data
    gal = np.random.default_rng(0).standard_normal((6, 64)).astype(np.float32)
    vals, idx = topk_search(jnp.asarray(queries), jnp.asarray(gal), k=10)
    assert vals.shape == (17, 10)
    assert np.all(np.asarray(vals[:, 6:]) == -np.inf)


def test_poincare_topk(data):
    rng = np.random.default_rng(3)
    g = rng.standard_normal((300, 16)).astype(np.float32)
    g = g / np.linalg.norm(g, axis=-1, keepdims=True) * rng.uniform(0.1, 0.8, (300, 1)).astype(np.float32)
    q = g[:5] * 0.99  # queries near specific gallery points
    vals, idx = topk_search(jnp.asarray(q), jnp.asarray(g), k=3,
                            similarity="poincare", block_size=64)
    # nearest neighbor of a slightly-scaled point is the point itself
    np.testing.assert_array_equal(np.asarray(idx[:, 0]), np.arange(5))


def test_poincare_topk_matches_f64_brute_force():
    """The MXU surrogate score (monotone transform of the distance,
    index._scores_block) must reproduce the exact acosh-distance ordering,
    and the returned values must be the TRUE −distances of the winners."""
    rng = np.random.default_rng(7)
    c = 2.0
    g = rng.standard_normal((500, 32))
    g = g / np.linalg.norm(g, axis=-1, keepdims=True) \
        * rng.uniform(0.05, 0.65, (500, 1))
    q = rng.standard_normal((9, 32))
    q = q / np.linalg.norm(q, axis=-1, keepdims=True) \
        * rng.uniform(0.05, 0.65, (9, 1))
    vals, idx = topk_search(jnp.asarray(q, jnp.float32),
                            jnp.asarray(g, jnp.float32), k=7,
                            similarity="poincare", block_size=128, c=c)
    # f64 oracle: d = (1/√c)·arcosh(1 + 2c|u−v|²/((1−c|u|²)(1−c|v|²)))
    diff = q[:, None, :] - g[None, :, :]
    num = 2 * c * np.sum(diff**2, -1)
    den = (1 - c * np.sum(q**2, -1))[:, None] * (1 - c * np.sum(g**2, -1))
    d = np.arccosh(1 + num / den) / np.sqrt(c)
    brute_idx = np.argsort(d, axis=1)[:, :7]
    np.testing.assert_array_equal(np.asarray(idx), brute_idx)
    np.testing.assert_allclose(
        np.asarray(vals), -np.take_along_axis(d, brute_idx, axis=1),
        rtol=2e-4, atol=2e-4)


def test_sharded_matches_single_device(data, eight_devices):
    queries, gallery = data
    mesh = Mesh(np.array(eight_devices), ("data",))
    vals, idx = sharded_topk_search(mesh, jnp.asarray(queries), jnp.asarray(gallery),
                                    k=10, block_size=64)
    bv, bi = brute_force_cosine(queries, gallery, 10)
    np.testing.assert_array_equal(np.asarray(idx), bi)
    np.testing.assert_allclose(np.asarray(vals), bv, atol=1e-5)


def test_sharded_uneven_gallery(eight_devices):
    """Gallery size not divisible by shard count → padding masked correctly."""
    rng = np.random.default_rng(11)
    gallery = rng.standard_normal((1003, 32)).astype(np.float32)
    queries = rng.standard_normal((5, 32)).astype(np.float32)
    mesh = Mesh(np.array(eight_devices), ("data",))
    vals, idx = sharded_topk_search(mesh, jnp.asarray(queries), jnp.asarray(gallery), k=7)
    bv, bi = brute_force_cosine(queries, gallery, 7)
    np.testing.assert_array_equal(np.asarray(idx), bi)


def test_embedding_index_roundtrip(tmp_path, data):
    queries, gallery = data
    names = [f"img_{i:04d}.png" for i in range(len(gallery))]
    index = EmbeddingIndex(gallery, names)
    res = index.search_names(queries[:2], k=5)
    assert len(res) == 2 and len(res[0]) == 5
    bv, bi = brute_force_cosine(queries[:2], gallery, 5)
    assert [n for n, _ in res[0]] == [names[j] for j in bi[0]]
    # persistence in the reference's .npy + .json layout
    prefix = str(tmp_path / "emb")
    index.save(prefix)
    loaded = EmbeddingIndex.load(prefix)
    assert loaded.names == names
    res2 = loaded.search_names(queries[:2], k=5)
    assert [n for n, _ in res2[0]] == [n for n, _ in res[0]]


def test_index_name_mismatch_raises(data):
    _, gallery = data
    with pytest.raises(ValueError):
        EmbeddingIndex(gallery, ["just_one.png"])


def test_feature_dict_export(tmp_path, data):
    import pickle

    queries, gallery = data
    names = [f"/abs/path/img_{i:03d}.png" for i in range(len(gallery))]
    index = EmbeddingIndex(gallery, names)
    d = index.to_feature_dict()
    assert set(d) == {f"img_{i:03d}.png" for i in range(len(gallery))}
    np.testing.assert_array_equal(d["img_000.png"], gallery[0])
    p = str(tmp_path / "feats.pkl")
    index.save_feature_pickle(p)
    with open(p, "rb") as f:
        loaded = pickle.load(f)
    np.testing.assert_array_equal(loaded["img_001.png"], gallery[1])


def test_index_with_mesh(eight_devices, data):
    """EmbeddingIndex(mesh=...) routes through the sharded search path."""
    queries, gallery = data
    mesh = Mesh(np.array(eight_devices), ("data",))
    names = [f"img_{i:04d}.png" for i in range(len(gallery))]
    index = EmbeddingIndex(gallery, names, mesh=mesh)
    vals, idx = index.search(queries, k=5)
    bv, bi = brute_force_cosine(queries, gallery, 5)
    np.testing.assert_array_equal(idx, bi)


# ------------------------------------------------- candidate stages

def _quantize_queries(queries):
    qn = queries / np.maximum(
        np.linalg.norm(queries, axis=-1, keepdims=True), 1e-12)
    qs = np.maximum(np.abs(qn).max(axis=-1, keepdims=True), 1e-8) / 127.0
    qi = np.clip(np.round(qn / qs), -127, 127).astype(np.int8)
    return jnp.asarray(qi), jnp.asarray(qs.astype(np.float32))


def test_bucket_topk_pool_contains_exact_topk(data):
    """int8 candidate stage (blockwise scan over several blocks): every
    exact-top-10 member survives into the 80-deep pool, and pool values
    are the int8 dequant scores of their rows."""
    from patent_tpu.retrieval.index import _topk_scores_int8, quantize_gallery

    rng = np.random.default_rng(11)
    gallery = rng.standard_normal((5000, 64)).astype(np.float32)
    queries, _ = data
    gi8, gsc = quantize_gallery(gallery)
    vals, idx = _topk_scores_int8(jnp.asarray(queries), jnp.asarray(gi8),
                                  jnp.asarray(gsc), 80, 512)
    vals, idx = np.asarray(vals), np.asarray(idx)
    _bv, bi = brute_force_cosine(queries, gallery, 10)
    for qrow, pool_row in zip(bi, idx):
        missing = set(qrow) - set(pool_row)
        assert not missing, f"exact top-10 member(s) lost: {missing}"
    qi, qs = _quantize_queries(queries)
    s8 = (np.asarray(qi, np.int32) @ gi8.astype(np.int32).T).astype(
        np.float32) * np.asarray(qs) * gsc[None, :]
    np.testing.assert_allclose(vals, np.take_along_axis(s8, idx, axis=1),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n", [100, 300])
def test_bucket_topk_small_and_ragged_galleries(data, n):
    """Galleries below / not a multiple of the block size: padded rows are
    never selected, and the pool is EXACTLY the int8 top-pool."""
    from patent_tpu.retrieval.index import _topk_scores_int8, quantize_gallery

    rng = np.random.default_rng(n)
    gallery = rng.standard_normal((n, 64)).astype(np.float32)
    queries = rng.standard_normal((5, 64)).astype(np.float32)
    gi8, gsc = quantize_gallery(gallery)
    qi, qs = _quantize_queries(queries)
    pool = min(80, n)
    vals, idx = _topk_scores_int8(jnp.asarray(queries), jnp.asarray(gi8),
                                  jnp.asarray(gsc), pool, 128)
    vals, idx = np.asarray(vals), np.asarray(idx)
    assert np.isfinite(vals).all()        # padded rows never selected
    s = (np.asarray(qi, np.int32) @ np.asarray(gi8, np.int32).T).astype(
        np.float32) * np.asarray(qs) * gsc[None, :]
    want = np.argsort(-s, axis=1, kind="stable")[:, :pool]
    for q in range(len(queries)):
        assert set(idx[q]) == set(want[q])


@pytest.mark.parametrize("n,k,narrows", [(1000, 10, True), (80, 10, False),
                                         (81, 10, True), (5, 10, False)])
def test_candidate_pool_narrows_by_shape(n, k, narrows):
    """The candidate-stage dispatch is decided by shape alone: the
    ``8·k`` pool must be smaller than the gallery."""
    from patent_tpu.retrieval.index import candidate_pool_narrows

    assert candidate_pool_narrows(n, k) is narrows


@pytest.mark.parametrize("block_size", [64, 256, 4096])
def test_quantized_index_block_size_invariant(data, block_size):
    """The quantized search's exact-reranked results do not depend on the
    candidate scan's block size."""
    queries, gallery = data
    from patent_tpu.retrieval.index import (quantize_gallery,
                                            topk_search_quantized)

    gi8, gsc = quantize_gallery(gallery)
    gi8, gsc = jnp.asarray(gi8), jnp.asarray(gsc)
    v_ref, i_ref = topk_search_quantized(queries, gi8, gsc, gallery, k=10,
                                         block_size=8192)
    v_blk, i_blk = topk_search_quantized(queries, gi8, gsc, gallery, k=10,
                                         block_size=block_size)
    np.testing.assert_array_equal(i_ref, i_blk)
    np.testing.assert_allclose(v_ref, v_blk, atol=1e-6)


# -------------------------------------------- Poincaré candidate path

def _random_ball(rng, n, d, c, r_frac_max=0.95):
    """Random Poincaré-ball points: uniform directions, radii up to
    ``r_frac_max`` of the ball radius 1/√c."""
    x = rng.standard_normal((n, d))
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    radii = rng.uniform(0.05, r_frac_max, (n, 1)) / np.sqrt(c)
    return (x * radii).astype(np.float32)


def _poincare_brute_f64(q, g, c, k):
    q64, g64 = q.astype(np.float64), g.astype(np.float64)
    diff_sq = np.sum((q64[:, None, :] - g64[None, :, :]) ** 2, axis=-1)
    den = ((1.0 - c * np.sum(q64 * q64, -1))[:, None]
           * (1.0 - c * np.sum(g64 * g64, -1))[None, :])
    d = np.arccosh(np.maximum(1.0 + 2.0 * c * diff_sq / den, 1.0)) / np.sqrt(c)
    idx = np.argsort(d, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(d, idx, axis=1), idx


@pytest.mark.parametrize("c", [1.0, 2.0])
def test_bucket_topk_poincare_pool_contains_exact(c):
    """Poincaré surrogate candidate stage (int8 gallery, several blocks):
    every exact (f64) top-10 member survives into the pool — per-row int8
    quantization noise must not evict true neighbors at pool depth 80."""
    from patent_tpu.retrieval.index import (_poincare_pool,
                                            prepare_poincare_gallery)

    rng = np.random.default_rng(23)
    gallery = _random_ball(rng, 3000, 64, c)
    queries = _random_ball(rng, 9, 64, c)
    gal = prepare_poincare_gallery(gallery, c)
    vals, idx = _poincare_pool(jnp.asarray(queries), gal, 80, 512)
    idx = np.asarray(idx)
    assert np.isfinite(np.asarray(vals)).all()
    _bd, bi = _poincare_brute_f64(queries, gallery, c, 10)
    for qrow, pool_row in zip(bi, idx):
        missing = set(qrow) - set(pool_row)
        assert not missing, f"exact top-10 member(s) lost: {missing}"


def test_poincare_fast_matches_f64_brute_force():
    """Full fast path (int8 candidates + exact host f64 re-rank): indices
    equal the f64 brute force; values are the −distance convention of
    topk_search."""
    from patent_tpu.retrieval.index import (prepare_poincare_gallery,
                                            topk_search_poincare_fast)

    c = 2.0
    rng = np.random.default_rng(5)
    gallery = _random_ball(rng, 1500, 32, c)
    queries = _random_ball(rng, 7, 32, c)
    gal = prepare_poincare_gallery(gallery, c)
    vals, idx = topk_search_poincare_fast(queries, gal, gallery, k=10, c=c)
    bd, bi = _poincare_brute_f64(queries, gallery, c, 10)
    np.testing.assert_array_equal(idx, bi)
    np.testing.assert_allclose(vals, -bd, rtol=2e-5, atol=1e-5)


def test_poincare_fast_near_boundary():
    """Near-boundary stress (radii up to 0.9995/√c — w into the 1e3 range,
    the regime where the expanded surrogate loses precision): the fast
    path's exact re-rank still returns the f64 top-k."""
    from patent_tpu.retrieval.index import (prepare_poincare_gallery,
                                            topk_search_poincare_fast)

    c = 2.0
    rng = np.random.default_rng(31)
    # clustered near-boundary gallery: many points in a narrow cone so the
    # candidate stage must separate genuinely close neighbors
    base = rng.standard_normal(16)
    base /= np.linalg.norm(base)
    dirs = base[None, :] + 0.05 * rng.standard_normal((800, 16))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    radii = rng.uniform(0.99, 0.9995, (800, 1)) / np.sqrt(c)
    gallery = (dirs * radii).astype(np.float32)
    queries = gallery[:5] * 0.999            # queries just inside neighbors
    gal = prepare_poincare_gallery(gallery, c)
    vals, idx = topk_search_poincare_fast(queries, gal, gallery,
                                          k=5, c=c, rerank_mult=16)
    _bd, bi = _poincare_brute_f64(queries, gallery, c, 5)
    # membership (not order) for the full k, exact order for the top-1:
    # among near-identical neighbors f64 ties can reorder legitimately
    assert np.array_equal(idx[:, 0], bi[:, 0])
    for got, want in zip(idx, bi):
        assert set(got) == set(want)


def test_embedding_index_quantized_poincare():
    """EmbeddingIndex(quantized=True, similarity='poincare') returns the
    same results as the exact unquantized poincaré index."""
    c = 1.0
    rng = np.random.default_rng(13)
    gallery = _random_ball(rng, 400, 16, c, r_frac_max=0.8)
    queries = _random_ball(rng, 6, 16, c, r_frac_max=0.8)
    names = [f"g{i}" for i in range(len(gallery))]
    fast = EmbeddingIndex(gallery, names, similarity="poincare", c=c,
                          quantized=True)
    exact = EmbeddingIndex(gallery, names, similarity="poincare", c=c)
    fv, fi = fast.search(queries, k=8)
    ev, ei = exact.search(queries, k=8)
    np.testing.assert_array_equal(fi, ei)
    np.testing.assert_allclose(fv, ev, rtol=2e-4, atol=2e-4)


def test_poincare_fast_matches_exact_scan():
    """The fast path (int8 candidates + exact re-rank) returns the exact
    blockwise search's results."""
    from patent_tpu.retrieval.index import (prepare_poincare_gallery,
                                            topk_search,
                                            topk_search_poincare_fast)

    c = 1.0
    rng = np.random.default_rng(3)
    gallery = _random_ball(rng, 300, 16, c, r_frac_max=0.7)
    queries = _random_ball(rng, 4, 16, c, r_frac_max=0.7)
    gal = prepare_poincare_gallery(gallery, c)
    fv, fi = topk_search_poincare_fast(queries, gal, gallery,
                                       k=6, c=c, block_size=64)
    ev, ei = topk_search(jnp.asarray(queries), jnp.asarray(gallery), k=6,
                         similarity="poincare", block_size=64, c=c)
    np.testing.assert_array_equal(fi, np.asarray(ei))
    np.testing.assert_allclose(fv, np.asarray(ev), atol=1e-5)


def test_sharded_poincare_fast_matches_single(eight_devices):
    """Sharded fast Poincaré search (per-shard surrogate pools + all_gather
    merge + f64 re-rank) over a ragged gallery equals the single-device fast
    path AND the f64 brute force."""
    from patent_tpu.retrieval.index import (
        prepare_poincare_gallery, sharded_topk_search_poincare_fast,
        topk_search_poincare_fast)

    c = 1.5
    rng = np.random.default_rng(17)
    gallery = _random_ball(rng, 301, 16, c, r_frac_max=0.85)  # 301 % 8 != 0
    queries = _random_ball(rng, 6, 16, c, r_frac_max=0.85)
    gal = prepare_poincare_gallery(gallery, c)
    mesh = Mesh(np.array(eight_devices), ("data",))
    sv, si = sharded_topk_search_poincare_fast(mesh, queries, gal, gallery,
                                               k=5, c=c, block_size=64)
    fv, fi = topk_search_poincare_fast(queries, gal, gallery,
                                       k=5, c=c, block_size=64)
    np.testing.assert_array_equal(si, fi)
    np.testing.assert_allclose(sv, fv, atol=1e-6)
    _bd, bi = _poincare_brute_f64(queries, gallery, c, 5)
    np.testing.assert_array_equal(si, bi)


def test_index_mesh_quantized_poincare(eight_devices):
    """EmbeddingIndex(quantized=True, similarity='poincare', mesh=...)
    routes through the sharded fast path and matches the exact index."""
    c = 1.0
    rng = np.random.default_rng(29)
    gallery = _random_ball(rng, 300, 16, c, r_frac_max=0.8)
    queries = _random_ball(rng, 5, 16, c, r_frac_max=0.8)
    names = [f"g{i}" for i in range(len(gallery))]
    mesh = Mesh(np.array(eight_devices), ("data",))
    fast = EmbeddingIndex(gallery, names, similarity="poincare", c=c,
                          quantized=True, mesh=mesh)
    exact = EmbeddingIndex(gallery, names, similarity="poincare", c=c)
    fv, fi = fast.search(queries, k=6)
    ev, ei = exact.search(queries, k=6)
    np.testing.assert_array_equal(fi, ei)
    np.testing.assert_allclose(fv, ev, rtol=2e-4, atol=2e-4)


# ----------------------------------------- bf16 exact-cosine path

def test_bucket_topk_bf16_pool_contains_exact_topk(data):
    """The bf16 candidate pool must contain the exact f32 top-10 (bf16
    score noise is strictly below the int8 path's)."""
    from patent_tpu.retrieval.index import (_cosine_pool_scan_bf16,
                                            prepare_cosine_gallery_bf16)

    queries, gallery = data
    gal16, valid = prepare_cosine_gallery_bf16(gallery)
    _pv, pidx = _cosine_pool_scan_bf16(jnp.asarray(queries), gal16, valid,
                                       80, 256)
    pidx = np.asarray(pidx)
    _bv, bi = brute_force_cosine(queries, gallery, 10)
    for r in range(queries.shape[0]):
        missing = set(bi[r]) - set(pidx[r])
        assert not missing, f"query {r}: exact top-10 lost {missing}"


def test_cosine_fast_matches_scan_exactly(data):
    """The bf16 candidate + exact f32 re-rank path returns IDENTICAL
    ordering and values to the scan oracle (topk_search) — the
    non-quantized serving path stays exact."""
    from patent_tpu.retrieval.index import (prepare_cosine_gallery_bf16,
                                            topk_search_cosine_fast)

    queries, gallery = data
    gal16, valid = prepare_cosine_gallery_bf16(gallery)
    sv, si = topk_search(jnp.asarray(queries), jnp.asarray(gallery), k=10,
                         block_size=256)
    sv, si = np.asarray(sv), np.asarray(si)
    fv, fi = topk_search_cosine_fast(queries, gal16, valid,
                                     jnp.asarray(gallery), k=10,
                                     block_size=256)
    np.testing.assert_array_equal(si, fi)
    np.testing.assert_allclose(sv, fv, atol=1e-6)
    # host-resident f32 gallery re-ranks on host: same answers
    hv, hi = topk_search_cosine_fast(queries, gal16, valid, gallery, k=10,
                                     block_size=256)
    np.testing.assert_array_equal(si, hi)
    np.testing.assert_allclose(sv, hv, atol=1e-5)


def test_cosine_fast_tie_break_matches_scan():
    """Duplicate gallery rows produce EXACTLY equal cosines; the scan
    oracle (lax.top_k over the gallery) breaks those ties by lower gallery
    index, and the candidate path must too — the pool arrives in bf16
    score order, so the re-rank pre-sorts it by index."""
    from patent_tpu.retrieval.index import (prepare_cosine_gallery_bf16,
                                            topk_search_cosine_fast)

    rng = np.random.default_rng(3)
    base = rng.standard_normal((64, 32)).astype(np.float32)
    # 8 exact duplicates of one row scattered through a 512-row gallery,
    # plus a duplicated pair elsewhere — ties both at and below rank 1
    gallery = np.concatenate([base] * 8, axis=0)
    queries = gallery[[5, 37, 100]] + 0.0   # query equals a duplicated row
    sv, si = topk_search(jnp.asarray(queries), jnp.asarray(gallery), k=10,
                         block_size=128)
    gal16, valid = prepare_cosine_gallery_bf16(jnp.asarray(gallery))
    fv, fi = topk_search_cosine_fast(queries, gal16, valid,
                                     jnp.asarray(gallery), k=10,
                                     block_size=128)
    np.testing.assert_array_equal(np.asarray(si), fi)
    np.testing.assert_allclose(np.asarray(sv), fv, atol=1e-6)
    # host re-rank branch: same tie behavior
    hv, hi = topk_search_cosine_fast(queries, gal16, valid, gallery, k=10,
                                     block_size=128)
    np.testing.assert_array_equal(np.asarray(si), hi)


def test_embedding_index_cosine_fast_dispatch(data):
    """EmbeddingIndex (non-quantized cosine) routes small-k searches
    through the bf16 candidate path; results equal the scan's and the bf16
    gallery copy is built lazily."""
    queries, gallery = data
    v_scan, i_scan = topk_search(jnp.asarray(queries), jnp.asarray(gallery),
                                 k=10)
    idx1 = EmbeddingIndex(gallery, [f"g{i}" for i in range(len(gallery))])
    assert idx1._gal16 is None
    v_fast, i_fast = idx1.search(queries, k=10)
    assert idx1._gal16 is not None          # lazily built on first search
    np.testing.assert_array_equal(np.asarray(i_scan), i_fast)
    np.testing.assert_allclose(np.asarray(v_scan), v_fast, atol=1e-6)
    # full-gallery ranking keeps the scan path (pool >= N)
    vf, _ = idx1.search(queries[:3], k=len(gallery))
    bv, _ = brute_force_cosine(queries[:3], gallery, len(gallery))
    np.testing.assert_allclose(vf, bv, atol=1e-5)


def test_sharded_cosine_fast_matches_single(data, eight_devices):
    """Sharded bf16 exact-cosine search (per-shard candidate pools +
    all_gather merge + exact re-rank) over a RAGGED gallery equals the
    single-device fast path AND the scan oracle."""
    from patent_tpu.retrieval.index import (prepare_cosine_gallery_bf16,
                                            sharded_topk_search_cosine_fast,
                                            topk_search_cosine_fast)

    queries, gallery = data
    gallery = gallery[:901]                  # 901 % 8 != 0 → real padding
    gal16, valid = prepare_cosine_gallery_bf16(gallery)
    mesh = Mesh(np.array(eight_devices), ("data",))
    sv, si = topk_search(jnp.asarray(queries), jnp.asarray(gallery), k=10,
                         block_size=64)
    sv, si = np.asarray(sv), np.asarray(si)
    mv, mi = sharded_topk_search_cosine_fast(mesh, queries, gal16, valid,
                                             jnp.asarray(gallery), k=10,
                                             block_size=64)
    np.testing.assert_array_equal(si, mi)
    np.testing.assert_allclose(sv, mv, atol=1e-6)
    fv, fi = topk_search_cosine_fast(queries, gal16, valid,
                                     jnp.asarray(gallery), k=10,
                                     block_size=64)
    np.testing.assert_array_equal(fi, mi)
    np.testing.assert_allclose(fv, mv, atol=1e-6)
    # host-resident f32 re-rank branch: same answers
    hv, hi = sharded_topk_search_cosine_fast(mesh, queries, gal16, valid,
                                             gallery, k=10, block_size=64)
    np.testing.assert_array_equal(si, hi)
    np.testing.assert_allclose(sv, hv, atol=1e-5)


def test_sharded_cosine_fast_scan_twin(data, eight_devices):
    """Each shard's candidate stage is the bf16 scan — same exact final
    ordering as the single-device scan oracle."""
    from patent_tpu.retrieval.index import (prepare_cosine_gallery_bf16,
                                            sharded_topk_search_cosine_fast)

    queries, gallery = data
    gal16, valid = prepare_cosine_gallery_bf16(gallery)
    mesh = Mesh(np.array(eight_devices), ("data",))
    mv, mi = sharded_topk_search_cosine_fast(mesh, queries, gal16, valid,
                                             jnp.asarray(gallery), k=10,
                                             block_size=64)
    sv, si = topk_search(jnp.asarray(queries), jnp.asarray(gallery), k=10,
                         block_size=64)
    np.testing.assert_array_equal(np.asarray(si), mi)
    np.testing.assert_allclose(np.asarray(sv), mv, atol=1e-6)


def test_index_mesh_cosine_fast_dispatch(data, eight_devices):
    """EmbeddingIndex (non-quantized cosine, mesh attached) builds its bf16
    copy row-sharded at build time, routes small-k searches through the
    sharded candidate path and matches the meshless index exactly;
    full-gallery ranking takes the sharded scan (pool >= N)."""
    queries, gallery = data
    names = [f"g{i}" for i in range(len(gallery))]
    mesh = Mesh(np.array(eight_devices), ("data",))
    meshed = EmbeddingIndex(gallery, names, mesh=mesh)
    single = EmbeddingIndex(gallery, names)
    n_dev = len(eight_devices)
    rows = {s.data.shape[0] for s in meshed._gal16.addressable_shards}
    assert rows == {-(-len(gallery) // n_dev)}   # no device holds it all
    mv, mi = meshed.search(queries, k=10, block_size=64)
    fv, fi = single.search(queries, k=10, block_size=64)
    np.testing.assert_array_equal(mi, fi)
    np.testing.assert_allclose(mv, fv, atol=1e-6)
    # full-gallery ranking (pool >= N): sharded scan path, exact values
    vf, _ = meshed.search(queries[:3], k=len(gallery))
    bv, _ = brute_force_cosine(queries[:3], gallery, len(gallery))
    np.testing.assert_allclose(vf, bv, atol=1e-5)


def test_sharded_cosine_fast_edge_shapes(eight_devices):
    """Edge shapes for the sharded bf16 cosine path: galleries smaller
    than the mesh, k at the pool boundary, duplicate rows — all must
    match the scan oracle exactly."""
    from patent_tpu.retrieval.index import (prepare_cosine_gallery_bf16,
                                            sharded_topk_search_cosine_fast)

    mesh = Mesh(np.array(eight_devices), ("data",))
    rng = np.random.default_rng(11)
    cases = [
        (5, 3),      # fewer rows than shards (per-shard 1 after padding)
        (9, 9),      # k == n (full ranking through the pool)
        (64, 8),     # pool == n boundary (8*8 == 64)
        (130, 16),   # pool (128) just under n
    ]
    for n, k in cases:
        gallery = rng.standard_normal((n, 16)).astype(np.float32)
        queries = rng.standard_normal((4, 16)).astype(np.float32)
        gal16, valid = prepare_cosine_gallery_bf16(gallery)
        sv, si = topk_search(jnp.asarray(queries), jnp.asarray(gallery),
                             k=k, block_size=32)
        mv, mi = sharded_topk_search_cosine_fast(mesh, queries, gal16,
                                                 valid,
                                                 jnp.asarray(gallery),
                                                 k=k, block_size=32)
        np.testing.assert_array_equal(np.asarray(si), mi,
                                      err_msg=f"case n={n} k={k}")
        np.testing.assert_allclose(np.asarray(sv), mv, atol=1e-6)
    # duplicate rows across shard boundaries: tie-break must still match
    base = rng.standard_normal((20, 16)).astype(np.float32)
    gallery = np.concatenate([base, base], axis=0)      # every row twice
    queries = base[[0, 7, 13]] + 0.0
    gal16, valid = prepare_cosine_gallery_bf16(gallery)
    sv, si = topk_search(jnp.asarray(queries), jnp.asarray(gallery),
                         k=6, block_size=16)
    mv, mi = sharded_topk_search_cosine_fast(mesh, queries, gal16, valid,
                                             jnp.asarray(gallery), k=6,
                                             block_size=16)
    np.testing.assert_array_equal(np.asarray(si), mi)
    np.testing.assert_allclose(np.asarray(sv), mv, atol=1e-6)
