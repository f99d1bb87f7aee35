"""Sharded exact top-k embedding index over a device mesh.

Replacement for the reference's brute-force retrieval
(notebooks/retrieval.ipynb cells 2-3): there, the full Q×G cosine matrix is
materialized on CPU with sklearn and each query argsorted over the whole
gallery.  Here the gallery is sharded across a 1-D device mesh; each device
computes blockwise similarities, reduces to a local top-k, and the
per-shard candidates are merged with one all-gather — the Q×G matrix never
exists, so the gallery scales past a single device's memory.

Design:
  * ``similarity ∈ {"cosine", "dot", "poincare"}`` — cosine matches the
    reference eval; poincaré serves the hyperbolic head (train_hyp models).
  * blockwise over the gallery axis with a running (scores, indices) top-k
    merge via ``jax.lax.top_k`` — O(G/B · (B+k) log) per query row, all
    static shapes.
  * sharded path uses ``shard_map`` over the mesh's ``"data"`` axis with the
    gallery row-sharded; query blocks are replicated; the merge is a single
    ``all_gather`` of [Q, k] candidates per shard (tiny), then a final top-k.
"""

from __future__ import annotations

import functools
from typing import Literal, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..ops import poincare

Similarity = Literal["cosine", "dot", "poincare"]

# candidate-pool over-fetch factor for the quantized (int8 stage + exact
# re-rank) searches; EmbeddingIndex.search's sharded-vs-host dispatch uses
# the SAME constant so changing it can't desynchronize the dispatch
# condition from the actual pool size
DEFAULT_RERANK_MULT = 8


def _scores_block(queries: jax.Array, gallery: jax.Array, similarity: Similarity,
                  c: float) -> jax.Array:
    """[q, g] similarity scores (higher = better) for one gallery block.

    For ``poincare`` the score is a MONOTONE SURROGATE of −distance, not the
    distance itself: for a fixed query u,

        d(u, v) = (1/√c)·arcosh(1 + 2c·|u−v|² / ((1−c|u|²)(1−c|v|²)))

    is strictly increasing in D(v) = |u−v|²/(1−c|v|²) (the u-terms are
    per-query constants and arcosh is monotone), so ranking by

        s(v) = −D(v) = 2·u·(v·w) − |u|²·w − |v|²·w,   w = 1/(1−c|v|²)

    gives EXACTLY the distance ordering as one matmul plus rank-1 affine
    terms — no arcosh/rsqrt per (q, g) pair.
    ``topk_search`` re-computes true −dist for the k winners afterwards so
    callers still receive distances as values.
    """
    if similarity == "cosine":
        qn = queries / jnp.maximum(jnp.linalg.norm(queries, axis=-1, keepdims=True), 1e-12)
        gn = gallery / jnp.maximum(jnp.linalg.norm(gallery, axis=-1, keepdims=True), 1e-12)
        return jnp.dot(qn, gn.T, precision=jax.lax.Precision.HIGHEST)
    if similarity == "dot":
        return jnp.dot(queries, gallery.T, precision=jax.lax.Precision.HIGHEST)
    if similarity == "poincare":
        g_sq = jnp.sum(jnp.square(gallery), axis=-1)              # [g]
        w = 1.0 / jnp.maximum(1.0 - c * g_sq, 1e-12)              # [g]
        q_sq = jnp.sum(jnp.square(queries), axis=-1, keepdims=True)  # [q, 1]
        dots = jnp.dot(queries, (gallery * w[:, None]).T,
                       precision=jax.lax.Precision.HIGHEST)       # [q, g]
        return 2.0 * dots - q_sq * w[None, :] - (g_sq * w)[None, :]
    raise ValueError(f"unknown similarity {similarity!r}")


@functools.partial(jax.jit, static_argnames=("k", "similarity", "block_size", "c"))
def topk_search(queries: jax.Array, gallery: jax.Array, k: int = 10,
                similarity: Similarity = "cosine", block_size: int = 8192,
                c: float = 1.0) -> tuple[jax.Array, jax.Array]:
    """Exact top-k over the gallery, blockwise (single device).

    Returns (scores [Q, k], indices [Q, k]) sorted best-first.
    """
    def finalize(vals, idx):
        # poincare scores are a monotone surrogate (see _scores_block):
        # same ordering, different scale — recompute the true −distance for
        # just the k winners so callers receive real distances
        if similarity != "poincare":
            return vals, idx
        cand = gallery[idx]                                   # [Q, k, D]
        d = poincare.dist(queries[:, None, :], cand, c)
        return jnp.where(jnp.isfinite(vals), -d, vals), idx

    n_gallery = gallery.shape[0]
    n_queries = queries.shape[0]
    if n_gallery <= max(block_size, k):
        scores = _scores_block(queries, gallery, similarity, c)
        vals, idx = jax.lax.top_k(scores, min(k, n_gallery))
        if n_gallery < k:  # pad to static k
            pad = k - n_gallery
            vals = jnp.pad(vals, ((0, 0), (0, pad)), constant_values=-jnp.inf)
            idx = jnp.pad(idx, ((0, 0), (0, pad)), constant_values=0)
        return finalize(vals, idx)

    # pad gallery to a multiple of block_size with -inf scores
    n_blocks = -(-n_gallery // block_size)
    padded = n_blocks * block_size
    gal = jnp.pad(gallery, ((0, padded - n_gallery), (0, 0)))
    gal = gal.reshape(n_blocks, block_size, -1)

    def body(carry, inp):
        best_vals, best_idx = carry
        block, block_i = inp
        s = _scores_block(queries, block, similarity, c)          # [Q, B]
        col = jax.lax.broadcasted_iota(jnp.int32, s.shape, 1) + block_i * block_size
        valid = col < n_gallery
        s = jnp.where(valid, s, -jnp.inf)
        cat_vals = jnp.concatenate([best_vals, s], axis=1)        # [Q, k+B]
        cat_idx = jnp.concatenate([best_idx, col], axis=1)
        vals, pos = jax.lax.top_k(cat_vals, k)
        idx = jnp.take_along_axis(cat_idx, pos, axis=1)
        return (vals, idx), None

    init = (jnp.full((n_queries, k), -jnp.inf, queries.dtype),
            jnp.zeros((n_queries, k), jnp.int32))
    (vals, idx), _ = jax.lax.scan(body, init, (gal, jnp.arange(n_blocks)))
    return finalize(vals, idx)


def quantize_gallery(embeddings: np.ndarray
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Per-row symmetric int8 quantization of L2-NORMALIZED gallery rows →
    (int8 [N, D], f32 [N] scales).  4× less device memory per vector, and
    the blockwise score scan reads 4× fewer bytes."""
    emb = np.asarray(embeddings, np.float32)
    emb = emb / np.maximum(np.linalg.norm(emb, axis=-1, keepdims=True), 1e-12)
    scale = np.maximum(np.abs(emb).max(axis=-1), 1e-8) / 127.0
    q = np.clip(np.round(emb / scale[:, None]), -127, 127).astype(np.int8)
    return q, scale.astype(np.float32)


def _quantize_queries(queries: jax.Array) -> tuple[jax.Array, jax.Array]:
    """L2-normalize queries and quantize each row to int8 →
    (int8 [Q, D], f32 [Q, 1] scale)."""
    qn = queries / jnp.maximum(
        jnp.linalg.norm(queries, axis=-1, keepdims=True), 1e-12)
    q_scale = jnp.maximum(jnp.max(jnp.abs(qn), axis=-1, keepdims=True),
                          1e-8) / 127.0
    q_i8 = jnp.clip(jnp.round(qn / q_scale), -127, 127).astype(jnp.int8)
    return q_i8, q_scale


def _block_candidates(s: jax.Array, k: int) -> tuple[jax.Array, jax.Array]:
    """Per-block candidate selection of the pool scans: exact ``top_k``."""
    return jax.lax.top_k(s, k)


def _merge_pool(carry, s: jax.Array, col: jax.Array, pool: int):
    """Fold one block's [Q, B] scores (global column ids ``col``) into the
    running [Q, pool] candidates."""
    best_vals, best_idx = carry
    bvals, bpos = _block_candidates(s, pool)
    bidx = jnp.take_along_axis(col, bpos, axis=1)
    cat_vals = jnp.concatenate([best_vals, bvals], axis=1)   # [Q, 2·pool]
    cat_idx = jnp.concatenate([best_idx, bidx], axis=1)
    vals, pos = jax.lax.top_k(cat_vals, pool)
    return vals, jnp.take_along_axis(cat_idx, pos, axis=1)


def _pool_init(n_queries: int, pool: int):
    return (jnp.full((n_queries, pool), -jnp.inf, jnp.float32),
            jnp.zeros((n_queries, pool), jnp.int32))


@functools.partial(jax.jit, static_argnames=("k", "block_size"))
def _topk_scores_int8(queries: jax.Array, gal_i8: jax.Array,
                      gal_scale: jax.Array, k: int,
                      block_size: int) -> tuple[jax.Array, jax.Array]:
    """Candidate-stage cosine top-k over an int8 gallery, as a blockwise
    scan: queries are normalized + per-row quantized on the fly, scores are
    int8 × int8 → int32 products, and each block's candidates are folded
    into a running [Q, k] pool.  Int8 score error (~1%) is absorbed by the
    caller's over-fetched pool + exact f32 re-rank (topk_search_quantized).
    """
    q_i8, q_scale = _quantize_queries(queries)
    n_gallery = gal_i8.shape[0]
    n_queries = queries.shape[0]
    block_size = max(block_size, k)
    n_blocks = -(-n_gallery // block_size)
    padded = n_blocks * block_size
    gal = jnp.pad(gal_i8, ((0, padded - n_gallery), (0, 0)))
    gal = gal.reshape(n_blocks, block_size, -1)
    scales = jnp.pad(gal_scale, (0, padded - n_gallery))
    scales = scales.reshape(n_blocks, block_size)

    def body(carry, inp):
        block, bscale, block_i = inp
        acc = jax.lax.dot_general(
            q_i8, block, dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.int32)                # [Q, B] int32
        s = acc.astype(jnp.float32) * q_scale * bscale
        col = jax.lax.broadcasted_iota(jnp.int32, s.shape, 1) \
            + block_i * block_size
        s = jnp.where(col < n_gallery, s, -jnp.inf)
        return _merge_pool(carry, s, col, k), None

    (vals, idx), _ = jax.lax.scan(body, _pool_init(n_queries, k),
                                  (gal, scales, jnp.arange(n_blocks)))
    return vals, idx


def topk_search_quantized(queries, gal_i8: jax.Array, gal_scale: jax.Array,
                          gallery_f32: np.ndarray, k: int = 10,
                          block_size: int = 8192,
                          rerank_mult: int = DEFAULT_RERANK_MULT
                          ) -> tuple[np.ndarray, np.ndarray]:
    """Exact cosine top-k with int8 candidate generation + f32 re-rank.

    Device stage over-fetches ``rerank_mult·k`` int8-scored candidates;
    just those rows (Q·mult·k dots) are re-scored in f32 (``_cosine_rerank``,
    the same math as every cosine path) for the exact-ordering top-k.  The true top-k survives as long as no true
    member's int8 score falls below the pool boundary — pool depth 8k gives
    headroom ≫ the ~1% int8 score noise for clustered (real-embedding)
    galleries; measured parity is pinned in tests/test_index.py.
    """
    q = jnp.asarray(queries)
    n = gal_i8.shape[0]
    pool = min(max(k * rerank_mult, k), n)
    if pool >= n:
        # full-gallery ranking (the offline evaluate path): the candidate
        # stage can't narrow anything — score everything exactly on host
        # instead of gathering a [Q, N, D] re-rank tensor
        qn = np.asarray(q, np.float32)
        qn = qn / np.maximum(np.linalg.norm(qn, axis=-1, keepdims=True),
                             1e-12)
        gn = gallery_f32 / np.maximum(
            np.linalg.norm(gallery_f32, axis=-1, keepdims=True), 1e-12)
        exact = qn @ gn.T
        idx = np.argsort(-exact, axis=1, kind="stable")[:, :k]
        return np.take_along_axis(exact, idx, axis=1), idx
    _pv, pidx = _topk_scores_int8(q, gal_i8, gal_scale, pool, block_size)
    return _cosine_rerank(pidx, q, gallery_f32, k)


@functools.partial(jax.jit, static_argnames=("k",))
def _cosine_rerank_rows(pidx: jax.Array, queries: jax.Array,
                        cand: jax.Array, k: int
                        ) -> tuple[jax.Array, jax.Array]:
    """Exact f32 cosine re-rank of a candidate pool (``cand`` [Q, P, D]
    holds gallery rows ``pidx`` [Q, P]) — the SAME normalization and
    HIGHEST-precision dot math as ``_scores_block('cosine')``.

    Ties (exactly equal cosines, e.g. duplicate gallery rows) must ALSO
    break like the scan oracle — ``lax.top_k`` over the full gallery
    favors the LOWER gallery index, while the pool arrives in score order
    — so the pool is pre-sorted by gallery index: ``top_k`` ties then
    resolve to the lower pool position = lower gallery index."""
    order0 = jnp.argsort(pidx, axis=1)
    pidx = jnp.take_along_axis(pidx, order0, axis=1)
    cand = jnp.take_along_axis(cand, order0[:, :, None], axis=1)
    qn = queries / jnp.maximum(
        jnp.linalg.norm(queries, axis=-1, keepdims=True), 1e-12)
    cand = cand / jnp.maximum(
        jnp.linalg.norm(cand, axis=-1, keepdims=True), 1e-12)
    exact = jnp.einsum("qd,qpd->qp", qn, cand,
                       precision=jax.lax.Precision.HIGHEST)
    vals, pos = jax.lax.top_k(exact, k)
    return vals, jnp.take_along_axis(pidx, pos, axis=1)


def _cosine_rerank(pidx, queries, gallery_f32, k: int
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Re-rank a candidate pool against the f32 gallery, on the device
    whether the gallery lives there (``jax.Array``) or on the host (only
    the [Q, P, D] candidate rows move) — ONE copy of the tie-break-sensitive
    math for every cosine candidate path, so they all order alike."""
    if isinstance(gallery_f32, jax.Array):
        cand = gallery_f32[jnp.asarray(pidx)]
    else:
        cand = np.asarray(gallery_f32, np.float32)[np.asarray(pidx)]
    vals, idx = _cosine_rerank_rows(jnp.asarray(pidx),
                                    jnp.asarray(queries, jnp.float32),
                                    jnp.asarray(cand), k)
    return np.asarray(vals), np.asarray(idx)


def prepare_cosine_gallery_bf16(embeddings) -> tuple[jax.Array, jax.Array]:
    """One-time index-build transform: gallery [N, D] → (L2-normalized
    bf16 rows [N, D], valid-row mask [N] f32 — all ones here; zero padding
    added by the sharded wrapper doubles as the invalid-row mask)."""
    g = jnp.asarray(embeddings, jnp.float32)
    gn = g / jnp.maximum(jnp.linalg.norm(g, axis=-1, keepdims=True), 1e-12)
    return gn.astype(jnp.bfloat16), jnp.ones((g.shape[0],), jnp.float32)


def candidate_pool_narrows(n: int, k: int,
                           rerank_mult: int = DEFAULT_RERANK_MULT) -> bool:
    """True iff the ``rerank_mult·k`` candidate pool is smaller than the
    gallery, i.e. a candidate stage + exact re-rank does less work than
    the exact scan.  ``EmbeddingIndex.search`` builds the bf16 gallery
    copy only then."""
    return min(max(k * rerank_mult, k), n) < n


def topk_search_cosine_fast(queries, gal_bf16: jax.Array, valid: jax.Array,
                            gallery_f32, k: int = 10,
                            block_size: int = 8192,
                            rerank_mult: int = DEFAULT_RERANK_MULT
                            ) -> tuple[np.ndarray, np.ndarray]:
    """Exact cosine top-k for the NON-quantized index: bf16 candidate
    stage + exact f32 re-rank.

    The candidate stage streams the bf16 gallery (HALF the f32 bytes, bf16
    products with f32 accumulation) through a blockwise scan that keeps the
    best ``rerank_mult·k`` rows per query; the pool is then re-scored
    against the f32 gallery with ``topk_search``'s exact math, so the final
    ordering is IDENTICAL to the scan's (pinned in tests/test_index.py),
    including on tied scores: the pool is re-ranked with the oracle's
    lower-gallery-index tie-break.  When the pool would not narrow the
    gallery this is the exact scan itself.  Replaces the serving hot loop
    of /root/reference/notebooks/retrieval.ipynb cell 3 (full Q×G cosine on
    CPU + argsort) at index scale."""
    q = jnp.asarray(queries, jnp.float32)
    n = gal_bf16.shape[0]
    pool = min(max(k * rerank_mult, k), n)
    if not candidate_pool_narrows(n, k, rerank_mult):
        vals, idx = topk_search(q, jnp.asarray(gallery_f32), k=k,
                                similarity="cosine", block_size=block_size)
        return np.asarray(vals), np.asarray(idx)
    _pv, pidx = _cosine_pool_scan_bf16(q, gal_bf16, valid, pool, block_size)
    return _cosine_rerank(pidx, q, gallery_f32, k)


@functools.partial(jax.jit, static_argnames=("pool", "block_size"))
def _cosine_pool_scan_bf16(queries: jax.Array, gal_bf16: jax.Array,
                           valid: jax.Array, pool: int,
                           block_size: int = 8192
                           ) -> tuple[jax.Array, jax.Array]:
    """bf16 cosine candidate stage: pre-normalized bf16 gallery rows,
    f32-normalized queries cast to bf16, f32 accumulation; bf16-cosine
    score scale on every shard, so per-shard pools merge consistently
    across a mesh."""
    qf = jnp.asarray(queries, jnp.float32)
    qn = qf / jnp.maximum(jnp.linalg.norm(qf, axis=-1, keepdims=True),
                          1e-12)
    q16 = qn.astype(jnp.bfloat16)
    n = gal_bf16.shape[0]
    n_queries = q16.shape[0]
    block_size = max(block_size, pool)
    n_blocks = -(-n // block_size)
    padded = n_blocks * block_size
    gal = jnp.pad(gal_bf16, ((0, padded - n), (0, 0)))
    gal = gal.reshape(n_blocks, block_size, -1)
    vmask = jnp.pad(valid, (0, padded - n)).reshape(n_blocks, block_size)

    def body(carry, inp):
        block, v_, block_i = inp
        s = jax.lax.dot_general(
            q16, block, dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32)              # [Q, B]
        s = jnp.where(v_[None, :] > 0.0, s, -jnp.inf)
        col = jax.lax.broadcasted_iota(jnp.int32, s.shape, 1) \
            + block_i * block_size
        return _merge_pool(carry, s, col, pool), None

    (vals, idx), _ = jax.lax.scan(body, _pool_init(n_queries, pool),
                                  (gal, vmask, jnp.arange(n_blocks)))
    return vals, idx


def sharded_topk_search_cosine_fast(mesh: Mesh, queries,
                                    gal_bf16: jax.Array, valid: jax.Array,
                                    gallery_f32, k: int = 10,
                                    block_size: int = 8192,
                                    rerank_mult: int = DEFAULT_RERANK_MULT,
                                    axis: str = "data"
                                    ) -> tuple[np.ndarray, np.ndarray]:
    """bf16 candidate stage + exact re-rank with the gallery row-sharded
    over ``mesh[axis]`` — ``topk_search_cosine_fast`` composed with the
    mesh path.

    Each shard scans its bf16 gallery rows (bf16-cosine values are
    cross-shard comparable: rows are pre-normalized, queries normalized
    identically per shard); one all_gather merges per-shard pools; the
    final ordering comes from the exact f32 re-rank (device if
    ``gallery_f32`` is a ``jax.Array``, host otherwise) with the scan
    oracle's lower-gallery-index tie-break.  Ordering matches the oracle
    as long as the true top-k survives the per-shard candidate stage.
    Parity is pinned in tests/test_index.py.  Replaces
    /root/reference/notebooks/retrieval.ipynb cell 3 at multi-device
    scale."""
    from jax import shard_map

    q = jnp.asarray(queries, jnp.float32)
    n = gal_bf16.shape[0]
    pool = min(max(k * rerank_mult, k), n)
    n_shards = mesh.shape[axis]
    per_shard = -(-n // n_shards)
    padded = per_shard * n_shards
    gal_p = jnp.pad(gal_bf16, ((0, padded - n), (0, 0)))
    valid_p = jnp.pad(valid, (0, padded - n))     # zeros mask padded rows

    def shard_fn(qs, g, v):
        shard_i = jax.lax.axis_index(axis)
        vals, idx = _cosine_pool_scan_bf16(qs, g, v, min(pool, per_shard),
                                           block_size)
        idx = idx + shard_i * per_shard
        vals = jnp.where(idx < n, vals, -jnp.inf)
        all_vals = jax.lax.all_gather(vals, axis, axis=1, tiled=True)
        all_idx = jax.lax.all_gather(idx, axis, axis=1, tiled=True)
        mvals, pos = jax.lax.top_k(all_vals, pool)
        return mvals, jnp.take_along_axis(all_idx, pos, axis=1)

    fn = shard_map(shard_fn, mesh=mesh,
                   in_specs=(P(), P(axis), P(axis)),
                   out_specs=(P(), P()), check_vma=False)
    _pv, pidx = fn(q, gal_p, valid_p)
    return _cosine_rerank(pidx, q, gallery_f32, k)


def _poincare_dist_np(u: np.ndarray, v: np.ndarray, c: float) -> np.ndarray:
    """f64 host Poincaré distance, cancellation-free direct form:
    d = arcosh(1 + 2c|u−v|² / ((1−c|u|²)(1−c|v|²))) / √c.
    u [Q, D], v [Q, P, D] → [Q, P]."""
    u = np.asarray(u, np.float64)
    v = np.asarray(v, np.float64)
    diff_sq = np.sum(np.square(u[:, None, :] - v), axis=-1)
    den = ((1.0 - c * np.sum(u * u, axis=-1))[:, None]
           * (1.0 - c * np.sum(v * v, axis=-1)))
    arg = 1.0 + 2.0 * c * diff_sq / np.maximum(den, 1e-15)
    return np.arccosh(np.maximum(arg, 1.0)) / np.sqrt(c)


class PoincareGallery(NamedTuple):
    """Prepared int8 candidate-stage operands for one ball gallery (see
    ``prepare_poincare_gallery``).  A NamedTuple so it flows through jit
    and shard_map as a pytree."""
    gal_i8: jax.Array      # [N, D] int8, row-scaled ball points
    gw2: jax.Array         # [N] f32, 2 · row_scale · w
    w: jax.Array           # [N] f32, 1/(1−c·|v|²); 0 marks padded rows
    b: jax.Array           # [N] f32, |v|²·w


def prepare_poincare_gallery(gallery, c: float) -> PoincareGallery:
    """One-time index-build transform: ball points [N, D] →
    ``PoincareGallery`` (int8 rows + f32 affine terms), where row i is
    quantized symmetrically to its own max (scaleᵢ = max|vᵢ|/127) and

        gw2ᵢ = 2 · scaleᵢ · wᵢ,   wᵢ = 1/(1−c·|vᵢ|²),   bᵢ = |vᵢ|²·wᵢ,

    so the surrogate score of ``_scores_block`` becomes
    ``q_scale·(q_i8·v_i8)·gw2 − |u|²·w − b``.  All affine terms come from
    the ORIGINAL f32 rows; int8 error enters only through the dot product
    (≤0.4% of the row max per element — the mandatory exact re-rank stage
    absorbs the ordering noise).  The int8 gallery is a QUARTER of the f32
    scan path's bytes."""
    g = jnp.asarray(gallery, jnp.float32)
    g_sq = jnp.sum(jnp.square(g), axis=-1)
    w = 1.0 / jnp.maximum(1.0 - c * g_sq, 1e-12)
    scale = jnp.max(jnp.abs(g), axis=-1) / 127.0
    safe = jnp.maximum(scale, 1e-30)
    gal_i8 = jnp.round(g / safe[:, None]).astype(jnp.int8)
    return PoincareGallery(gal_i8, 2.0 * scale * w, w, g_sq * w)


def quantize_poincare_queries(queries: jax.Array
                              ) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Per-row symmetric int8 quantization of query ball points →
    (q_i8 [Q, D], q_scale [Q, 1] f32, q_sq [Q, 1] f32).  q_sq comes from
    the ORIGINAL f32 rows (it feeds the affine term, not the dot)."""
    qf = jnp.asarray(queries, jnp.float32)
    q_sq = jnp.sum(jnp.square(qf), axis=-1, keepdims=True)
    qscale = jnp.max(jnp.abs(qf), axis=-1, keepdims=True) / 127.0
    q_i8 = jnp.round(qf / jnp.maximum(qscale, 1e-30)).astype(jnp.int8)
    return q_i8, qscale, q_sq


@functools.partial(jax.jit, static_argnames=("pool", "block_size"))
def _poincare_pool(queries: jax.Array, gal: PoincareGallery, pool: int,
                   block_size: int = 8192) -> tuple[jax.Array, jax.Array]:
    """Poincaré candidate stage: int8 operands, dequant folded into the
    surrogate's affine terms, blockwise scan — surrogate-scale values on
    every shard, so per-shard pools merge consistently."""
    q_i8, qs, q_sq = quantize_poincare_queries(queries)
    n = gal.gal_i8.shape[0]
    n_queries = q_i8.shape[0]
    block_size = max(block_size, pool)
    n_blocks = -(-n // block_size)
    padded = n_blocks * block_size
    gal_b = jnp.pad(gal.gal_i8, ((0, padded - n), (0, 0)))
    gal_b = gal_b.reshape(n_blocks, block_size, -1)
    gw2s = jnp.pad(gal.gw2, (0, padded - n)).reshape(n_blocks, block_size)
    ws = jnp.pad(gal.w, (0, padded - n)).reshape(n_blocks, block_size)
    bs = jnp.pad(gal.b, (0, padded - n)).reshape(n_blocks, block_size)

    def body(carry, inp):
        block, gw2_, w_, b_, block_i = inp
        acc = jax.lax.dot_general(
            q_i8, block, dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.int32)                # [Q, B]
        s = (qs * (acc.astype(jnp.float32) * gw2_[None, :])
             - q_sq * w_[None, :] - b_[None, :])
        s = jnp.where(w_[None, :] > 0.0, s, -jnp.inf)
        col = jax.lax.broadcasted_iota(jnp.int32, s.shape, 1) \
            + block_i * block_size
        return _merge_pool(carry, s, col, pool), None

    (vals, idx), _ = jax.lax.scan(body, _pool_init(n_queries, pool),
                                  (gal_b, gw2s, ws, bs,
                                   jnp.arange(n_blocks)))
    return vals, idx


@functools.partial(jax.jit, static_argnames=("k", "c"))
def _poincare_rerank_device(pidx: jax.Array, queries: jax.Array,
                            gallery: jax.Array, k: int, c: float
                            ) -> tuple[jax.Array, jax.Array]:
    cand = gallery[pidx]                                      # [Q, P, D]
    d = poincare.dist(queries[:, None, :], cand, c)
    vals, pos = jax.lax.top_k(-d, k)
    return vals, jnp.take_along_axis(pidx, pos, axis=1)


# Poincaré candidate-stage pool depth; on trained embeddings agreement with
# the exact scan is exact (tests/test_hyperbolic_engine.py).
POINCARE_RERANK_MULT = DEFAULT_RERANK_MULT


def topk_search_poincare_fast(queries, gal: PoincareGallery, gallery_f32,
                              k: int = 10, c: float = 1.0,
                              block_size: int = 8192,
                              rerank_mult: int = POINCARE_RERANK_MULT
                              ) -> tuple[np.ndarray, np.ndarray]:
    """Poincaré top-k: int8 candidate stage + EXACT distance re-rank.

    ``gal`` comes from ``prepare_poincare_gallery``;
    ``gallery_f32`` is the full-precision gallery used only for the
    ``rerank_mult·k``-row re-rank — pass a device ``jax.Array`` to re-rank
    on-chip (serving: the gallery is resident anyway) or a host ``ndarray``
    to re-rank in f64 on host (the memory-lean index: device holds only the
    int8 copy — a QUARTER of the f32 bytes).  Values returned are −distance
    (the ``topk_search`` poincaré convention).

    Unlike the scan surrogate path, the re-rank here uses the
    cancellation-free direct distance on the pool, so near-boundary
    orderings are MORE accurate than ``topk_search``'s surrogate
    ordering."""
    q = jnp.asarray(queries, jnp.float32)
    n = gal.gal_i8.shape[0]
    pool = min(max(k * rerank_mult, k), n)
    if pool >= n:
        # full-gallery ranking (the offline evaluate path): nothing to
        # narrow — run the exact blockwise search on the device instead of
        # re-ranking every row in f64 on host
        vals, idx = topk_search(q, jnp.asarray(gallery_f32), k=k,
                                similarity="poincare",
                                block_size=block_size, c=c)
        return np.asarray(vals), np.asarray(idx)
    _pv, pidx = _poincare_pool(q, gal, pool, block_size)
    if isinstance(gallery_f32, jax.Array):
        vals, idx = _poincare_rerank_device(pidx, q, gallery_f32, k, c)
        return np.asarray(vals), np.asarray(idx)
    pidx = np.asarray(pidx)
    d = _poincare_dist_np(np.asarray(q), gallery_f32[pidx], c)  # [Q, pool]
    order = np.argsort(d, axis=1, kind="stable")[:, :k]
    return (-np.take_along_axis(d, order, axis=1).astype(np.float32),
            np.take_along_axis(pidx, order, axis=1))


def sharded_topk_search_quantized(mesh: Mesh, queries,
                                  gal_i8: jax.Array, gal_scale: jax.Array,
                                  gallery_f32: np.ndarray, k: int = 10,
                                  block_size: int = 8192,
                                  rerank_mult: int = DEFAULT_RERANK_MULT,
                                  axis: str = "data",
                                  n_valid: int | None = None
                                  ) -> tuple[np.ndarray, np.ndarray]:
    """Quantized candidate search with the int8 gallery row-sharded over
    ``mesh[axis]`` (4× the vectors per device), f32 re-rank on host.  Each
    shard runs the int8 pool pass over its rows;
    one all_gather merges per-shard pools; the final exact ordering comes
    from the host re-rank, exactly as in ``topk_search_quantized``.
    ``n_valid``: real rows of a gallery passed pre-padded (see
    ``shard_rows``); rows from there on are never returned."""
    from jax import shard_map

    q = jnp.asarray(queries)
    n = gal_i8.shape[0] if n_valid is None else n_valid
    pool = min(max(k * rerank_mult, k), n)
    n_shards = mesh.shape[axis]
    per_shard = -(-gal_i8.shape[0] // n_shards)
    padded = per_shard * n_shards
    gal_p = jnp.pad(gal_i8, ((0, padded - gal_i8.shape[0]), (0, 0)))
    scale_p = jnp.pad(gal_scale, (0, padded - gal_i8.shape[0]))

    def shard_fn(qs, g, sc):
        shard_i = jax.lax.axis_index(axis)
        vals, idx = _topk_scores_int8(qs, g, sc, min(pool, per_shard),
                                      block_size)
        idx = idx + shard_i * per_shard
        vals = jnp.where(idx < n, vals, -jnp.inf)
        all_vals = jax.lax.all_gather(vals, axis, axis=1, tiled=True)
        all_idx = jax.lax.all_gather(idx, axis, axis=1, tiled=True)
        mvals, pos = jax.lax.top_k(all_vals, pool)
        return mvals, jnp.take_along_axis(all_idx, pos, axis=1)

    fn = shard_map(shard_fn, mesh=mesh,
                   in_specs=(P(), P(axis), P(axis)),
                   out_specs=(P(), P()), check_vma=False)
    _pv, pidx = fn(q, gal_p, scale_p)
    return _cosine_rerank(pidx, q, gallery_f32, k)


def sharded_topk_search_poincare_fast(mesh: Mesh, queries,
                                      gal: PoincareGallery,
                                      gallery_f32: np.ndarray,
                                      k: int = 10, c: float = 1.0,
                                      block_size: int = 8192,
                                      rerank_mult: int = POINCARE_RERANK_MULT,
                                      axis: str = "data",
                                      n_valid: int | None = None
                                      ) -> tuple[np.ndarray, np.ndarray]:
    """Fast Poincaré search with the int8 gallery row-sharded over
    ``mesh[axis]`` (4× the ball vectors per device).  Each shard runs the
    surrogate candidate stage over its rows (surrogate values are
    cross-shard comparable: the per-row dequant folds into gw2, so scores
    land on the same absolute scale everywhere); one all_gather merges per-shard pools; the final
    exact ordering comes from the f64 host re-rank, exactly as in
    ``topk_search_poincare_fast``.  ``n_valid``: real rows of a gallery
    passed pre-padded (see ``shard_rows``)."""
    from jax import shard_map

    q = jnp.asarray(queries, jnp.float32)
    rows = gal.gal_i8.shape[0]
    n = rows if n_valid is None else n_valid
    pool = min(max(k * rerank_mult, k), n)
    n_shards = mesh.shape[axis]
    per_shard = -(-rows // n_shards)
    padded = per_shard * n_shards
    gal_p = PoincareGallery(
        jnp.pad(gal.gal_i8, ((0, padded - rows), (0, 0))),
        jnp.pad(gal.gw2, (0, padded - rows)),
        jnp.pad(gal.w, (0, padded - rows)),   # zeros mask padded rows
        jnp.pad(gal.b, (0, padded - rows)))

    def shard_fn(qs, g):
        shard_i = jax.lax.axis_index(axis)
        vals, idx = _poincare_pool(qs, g, min(pool, per_shard), block_size)
        idx = idx + shard_i * per_shard
        vals = jnp.where(idx < n, vals, -jnp.inf)
        all_vals = jax.lax.all_gather(vals, axis, axis=1, tiled=True)
        all_idx = jax.lax.all_gather(idx, axis, axis=1, tiled=True)
        mvals, pos = jax.lax.top_k(all_vals, pool)
        return mvals, jnp.take_along_axis(all_idx, pos, axis=1)

    fn = shard_map(shard_fn, mesh=mesh,
                   in_specs=(P(), P(axis)),
                   out_specs=(P(), P()), check_vma=False)
    _pv, pidx = fn(q, gal_p)
    pidx = np.asarray(pidx)
    d = _poincare_dist_np(np.asarray(q), np.asarray(gallery_f32)[pidx], c)
    order = np.argsort(d, axis=1, kind="stable")[:, :k]
    return (-np.take_along_axis(d, order, axis=1).astype(np.float32),
            np.take_along_axis(pidx, order, axis=1))


def sharded_topk_search(mesh: Mesh, queries: jax.Array, gallery: jax.Array,
                        k: int = 10, similarity: Similarity = "cosine",
                        block_size: int = 8192, c: float = 1.0,
                        axis: str = "data", n_valid: int | None = None
                        ) -> tuple[jax.Array, jax.Array]:
    """Exact top-k with the gallery row-sharded over ``mesh[axis]``.

    Each shard runs the blockwise scan over its rows and produces [Q, k]
    local candidates; one all_gather brings the per-shard candidate
    sets together (k·n_shards ≪ G values) and a final top_k merges them.
    ``n_valid``: real rows of a gallery passed pre-padded (see
    ``shard_rows``).
    """
    n_shards = mesh.shape[axis]
    n_gallery = gallery.shape[0] if n_valid is None else n_valid
    # pad so the gallery divides evenly across shards
    per_shard = -(-gallery.shape[0] // n_shards)
    padded_n = per_shard * n_shards
    gallery = jnp.pad(gallery, ((0, padded_n - gallery.shape[0]), (0, 0)))

    from jax import shard_map

    def shard_fn(q, g):
        shard_i = jax.lax.axis_index(axis)
        vals, idx = topk_search(q, g, k=k, similarity=similarity,
                                block_size=block_size, c=c)
        idx = idx + shard_i * per_shard
        # mask out padding rows (only the last shard can contain them)
        valid = idx < n_gallery
        vals = jnp.where(valid, vals, -jnp.inf)
        all_vals = jax.lax.all_gather(vals, axis, axis=1, tiled=True)  # [Q, S*k]
        all_idx = jax.lax.all_gather(idx, axis, axis=1, tiled=True)
        mvals, pos = jax.lax.top_k(all_vals, k)
        midx = jnp.take_along_axis(all_idx, pos, axis=1)
        return mvals, midx

    fn = shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(), P(axis)),
        out_specs=(P(), P()),
        check_vma=False,
    )
    return fn(queries, gallery)


def shard_rows(mesh: Mesh, axis: str, *arrays):
    """Zero-pad each array's rows to a multiple of ``mesh[axis]`` and place
    it row-sharded over that axis, so no device holds the whole gallery."""
    from jax.sharding import NamedSharding

    n_shards = mesh.shape[axis]
    out = []
    for a in arrays:
        a = np.asarray(a)
        pad = -a.shape[0] % n_shards
        a = np.pad(a, [(0, pad)] + [(0, 0)] * (a.ndim - 1))
        out.append(jax.device_put(a, NamedSharding(mesh, P(axis))))
    return out


@functools.partial(jax.jit, static_argnames=("n", "similarity", "c"))
def _prepare_sharded(gallery: jax.Array, n: int, similarity: str,
                     c: float = 1.0):
    """Index-build transforms on a row-sharded, zero-padded f32 gallery;
    rows ≥ n are marked invalid (the outputs keep the input's sharding)."""
    valid = jnp.arange(gallery.shape[0]) < n
    if similarity == "poincare":
        gal = prepare_poincare_gallery(gallery, c)
        return gal._replace(w=jnp.where(valid, gal.w, 0.0))
    g16, _ = prepare_cosine_gallery_bf16(gallery)
    return g16, valid.astype(jnp.float32)


class EmbeddingIndex:
    """In-memory exact index with optional mesh sharding; persistence matches
    the reference's ``.npy`` + paths-JSON layout (retrieval.ipynb cell 2
    ``encode_dataset`` save block).
    """

    def __init__(self, embeddings: np.ndarray | jax.Array, names: list[str],
                 similarity: Similarity = "cosine", c: float = 1.0,
                 mesh: Mesh | None = None, axis: str = "data",
                 quantized: bool = False):
        """``quantized=True``: the device-resident gallery is per-row int8
        for BOTH similarities (4× the vectors per device, 4× less memory
        read per search; poincaré adds three f32 affine rows) — and
        searches over-fetch int8-scored candidates then re-rank them exactly
        host-side (topk_search_quantized / topk_search_poincare_fast).  The
        f32 copy stays host-side for re-ranking and persistence.

        With a ``mesh``, every device-resident gallery is zero-padded and
        row-sharded over ``mesh[axis]`` at build time (``shard_rows``): no
        device holds the whole gallery, and the f32 copy stays on the host
        for the re-rank."""
        if len(names) != int(embeddings.shape[0]):
            raise ValueError(
                f"names ({len(names)}) and embeddings ({embeddings.shape[0]}) disagree")
        self.names = list(names)
        self.similarity: Similarity = similarity
        self.c = c
        self.mesh = mesh
        self.axis = axis
        self.quantized = quantized
        n = int(embeddings.shape[0])
        if quantized:
            if similarity not in ("cosine", "poincare"):
                raise ValueError(
                    "quantized index supports cosine and poincare only")
            self._emb_np = np.asarray(embeddings, np.float32)
            self.embeddings = self._emb_np  # host f32 (rerank + save)
            if similarity == "cosine":
                i8, scale = quantize_gallery(self._emb_np)
                if mesh is not None:
                    self.emb_i8, self.emb_scale = shard_rows(mesh, axis, i8,
                                                             scale)
                else:
                    self.emb_i8, self.emb_scale = (jnp.asarray(i8),
                                                   jnp.asarray(scale))
            elif mesh is not None:
                (g,) = shard_rows(mesh, axis, self._emb_np)
                self.emb_gal = _prepare_sharded(g, n, "poincare", c)
            else:
                # device holds an int8 gallery + f32 per-row affine terms
                # (a quarter of the f32 bytes); searches run the int8
                # surrogate candidate stage + exact f64 host re-rank
                self.emb_gal = prepare_poincare_gallery(self._emb_np, c)
            return
        if mesh is not None:
            # host f32 for the re-rank and persistence; the device copies
            # are row-sharded (the bf16 candidate copy is built with them)
            self.embeddings = np.asarray(embeddings, np.float32)
            (self._dev,) = shard_rows(mesh, axis, self.embeddings)
            if similarity == "cosine":
                self._gal16, self._gal16_valid = _prepare_sharded(
                    self._dev, n, "cosine")
            return
        self.embeddings = jnp.asarray(embeddings)
        # bf16 candidate copy for the exact-cosine candidate path, built
        # lazily on the first search whose pool narrows the gallery (+50%
        # gallery memory); full-ranking-only callers (engine.evaluate)
        # never pay it
        self._gal16 = None
        self._gal16_valid = None

    def __len__(self) -> int:
        return len(self.names)

    def search(self, queries: np.ndarray | jax.Array, k: int = 10,
               block_size: int = 8192) -> tuple[np.ndarray, np.ndarray]:
        """Exact top-k. Returns (scores [Q, k], indices [Q, k]) best-first."""
        q = jnp.asarray(queries)
        k = min(k, len(self.names))
        if self.quantized:
            if self.similarity == "poincare":
                # int8 candidate stage + exact re-rank; gallery
                # row-sharded over the mesh when one is attached
                if self.mesh is not None:
                    vals, idx = sharded_topk_search_poincare_fast(
                        self.mesh, q, self.emb_gal, self._emb_np, k=k,
                        c=self.c, block_size=block_size, axis=self.axis,
                        n_valid=len(self.names))
                else:
                    vals, idx = topk_search_poincare_fast(
                        q, self.emb_gal, self._emb_np, k=k, c=self.c,
                        block_size=block_size)
                return np.asarray(vals), np.asarray(idx)
            if self.mesh is not None:
                vals, idx = sharded_topk_search_quantized(
                    self.mesh, q, self.emb_i8, self.emb_scale, self._emb_np,
                    k=k, block_size=block_size, axis=self.axis,
                    n_valid=len(self.names))
            else:
                vals, idx = topk_search_quantized(
                    q, self.emb_i8, self.emb_scale, self._emb_np, k=k,
                    block_size=block_size)
            return np.asarray(vals), np.asarray(idx)
        narrows = candidate_pool_narrows(len(self.names), k)
        if self.similarity == "cosine" and narrows:
            # bf16 candidates + exact f32 re-rank (per shard when a mesh is
            # attached) — identical ordering to the scan
            if self._gal16 is None:
                self._gal16, self._gal16_valid = \
                    prepare_cosine_gallery_bf16(self.embeddings)
            if self.mesh is not None:
                vals, idx = sharded_topk_search_cosine_fast(
                    self.mesh, q, self._gal16, self._gal16_valid,
                    self.embeddings, k=k, block_size=block_size,
                    axis=self.axis)
            else:
                vals, idx = topk_search_cosine_fast(
                    q, self._gal16, self._gal16_valid, self.embeddings, k=k,
                    block_size=block_size)
        elif self.mesh is not None:
            vals, idx = sharded_topk_search(self.mesh, q, self._dev, k=k,
                                            similarity=self.similarity,
                                            block_size=block_size, c=self.c,
                                            axis=self.axis,
                                            n_valid=len(self.names))
        else:
            vals, idx = topk_search(q, self.embeddings, k=k,
                                    similarity=self.similarity,
                                    block_size=block_size, c=self.c)
        return np.asarray(vals), np.asarray(idx)

    def search_names(self, queries, k: int = 10) -> list[list[tuple[str, float]]]:
        """Per query: [(gallery name, score), ...] best-first — the shape of
        ``retrieve_similar_images`` (retrieval.ipynb cell 2)."""
        vals, idx = self.search(queries, k=k)
        return [[(self.names[j], float(v)) for j, v in zip(row_i, row_v)]
                for row_i, row_v in zip(idx, vals)]

    # ----------------------------------------------------------- persistence
    def save(self, prefix: str) -> None:
        """Save as ``{prefix}.npy`` + ``{prefix}.json`` like the reference."""
        import json
        np.save(f"{prefix}.npy", np.asarray(self.embeddings))
        with open(f"{prefix}.json", "w") as f:
            json.dump(self.names, f)

    @classmethod
    def load(cls, prefix: str, **kwargs) -> "EmbeddingIndex":
        import json
        emb = np.load(f"{prefix}.npy")
        with open(f"{prefix}.json") as f:
            names = json.load(f)
        return cls(emb, names, **kwargs)

    def to_feature_dict(self, basename_keys: bool = True) -> dict:
        """{figure name: vector} dict — the reference's per-figure embedding
        pickle schema (graph gen cell 17 ``query_images_embeddings_*.pkl``,
        compute_graph_embeddings.py:53), consumed by the feature-matrix
        builder and the CLIP-alignment stage."""
        import os

        emb = np.asarray(self.embeddings)
        keyfn = os.path.basename if basename_keys else (lambda s: s)
        return {keyfn(n): emb[i] for i, n in enumerate(self.names)}

    def save_feature_pickle(self, path: str, basename_keys: bool = True) -> None:
        import pickle

        with open(path, "wb") as f:
            pickle.dump(self.to_feature_dict(basename_keys), f)
