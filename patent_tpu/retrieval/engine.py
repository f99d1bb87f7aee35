"""End-to-end retrieval engine: encode gallery → index → query → metrics.

The JAX equivalent of ``ImageRetrieval`` + the batch evaluation script
(notebooks/retrieval.ipynb cells 2-3): encode the gallery with a jitted
(optionally pjit-data-parallel) encoder, persist embeddings in the
reference's ``.npy`` + paths-JSON layout, answer queries with the sharded
exact top-k index, and score with the exact reference metric battery.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Mapping, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..input.pipeline import ImageBatcher, list_images
from ..metrics import RetrievalMetrics, evaluate_rankings
from .index import EmbeddingIndex, Similarity


def _fold_params_for_u8(params):
    """Fold input normalization into the tower weights (models.vit.
    fold_u8_normalize_params) — handles the {"params": tree} wrapper."""
    from ..models.vit import fold_u8_normalize_params

    if "params" in params and "patch_embed" in params["params"]:
        return {**params, "params": fold_u8_normalize_params(params["params"])}
    return fold_u8_normalize_params(params)


def make_device_normalizing_encoder(apply_fn, params, fold_u8: bool = False):
    """Encoder accepting uint8 RGB batches: (x/255 − mean)/std happens ON
    DEVICE inside the jit — pairs with ``ImageBatcher(out_dtype="u8")`` /
    input.native.decode_batch_native_u8 for 4× less host→device transfer
    (params are jit ARGUMENTS).  float32 batches pass through unnormalized
    (assumed pre-normalized), so the same encoder serves both input modes —
    the jit specializes per dtype.

    ``fold_u8=True`` folds the normalization into the patch-embed weights
    instead (fold_u8_normalize_params): uint8 batches then feed the tower
    raw, skipping the normalize pass over the C=3-minor-layout pixel
    stream.  The folded encoder accepts ONLY uint8."""
    from ..input.pipeline import device_normalize

    if fold_u8:
        params = _fold_params_for_u8(params)

        @jax.jit
        def encode_raw(params, batch):
            return apply_fn(params, batch)

        def run(batch):
            if batch.dtype != jnp.uint8:
                raise ValueError("fold_u8 encoder accepts uint8 batches only "
                                 "(weights are normalization-folded)")
            return encode_raw(params, batch)

        return run

    @jax.jit
    def encode(params, batch):
        return apply_fn(params, device_normalize(batch))

    return lambda batch: encode(params, batch)


def make_scan_encoder(apply_fn, params, fold_u8: bool = False):
    """Build a [k, B, ...] → [k, B, D] megabatch encoder: jitted lax.scan
    over ``apply_fn`` with params passed as a jit ARGUMENT (never a closure
    constant — closed-over weights bloat the HLO past remote-compile limits).

    Accepts float32 (pre-normalized) OR uint8 batches: uint8 input is
    CLIP-normalized on device inside the jit (the jit specializes on input
    dtype), pairing with ``ImageBatcher(out_dtype="u8")`` for 4× less
    host→device transfer.  ``fold_u8=True``: as in
    ``make_device_normalizing_encoder`` — normalization folded into the
    weights, uint8-only, no per-pixel normalize pass.
    """
    from ..input.pipeline import device_normalize

    if fold_u8:
        params = _fold_params_for_u8(params)

    @jax.jit
    def scan_encode(params, batches):
        def body(_, b):
            # normalize per scan step (fuses into the patch conv)
            return None, apply_fn(params, b if fold_u8
                                  else device_normalize(b))
        _, outs = jax.lax.scan(body, None, batches)
        return outs

    def run(batches):
        if fold_u8 and batches.dtype != jnp.uint8:
            raise ValueError("fold_u8 encoder accepts uint8 batches only "
                             "(weights are normalization-folded)")
        return scan_encode(params, batches)

    return run


class RetrievalEngine:
    """Encode → index → retrieve → evaluate.

    Args:
        encode_fn: jitted [B, H, W, 3] → [B, D] feature fn (e.g. a bound
            VisionTransformer apply, optionally pjit-sharded over a mesh).
        batch_size / num_workers: input-pipeline knobs (reference uses
            batch 128, workers 16 — retrieval.ipynb cell 2).
    """

    def __init__(self, encode_fn: Callable[[jax.Array], jax.Array],
                 batch_size: int = 128, num_workers: int = 8,
                 image_size: int = 224,
                 similarity: Similarity = "cosine", c: float = 1.0,
                 mesh=None, scan_batches: int = 1,
                 encode_many_fn: Callable[[jax.Array], jax.Array] | None = None,
                 input_dtype: str = "f32", cache_dir: str | None = None):
        """``encode_many_fn``: optional [k, B, H, W, 3] → [k, B, D] megabatch
        encoder (e.g. a jitted lax.scan over the model apply with params as
        arguments — see make_scan_encoder).  Amortizes per-dispatch overhead
        on high-latency device links; used when ``scan_batches > 1``.

        ``input_dtype``: "u8" feeds raw uint8 RGB batches and normalizes on
        device — 4× less host→device transfer (the reference normalizes on
        host workers, retrieval.ipynb cell 2; here XLA fuses the normalize
        into the patch conv).  The default "f32" feeds host-normalized batches.
        ``encode_fn`` must accept the chosen dtype: make_scan_encoder and
        make_device_normalizing_encoder handle u8; a bare ``model.apply``
        jit needs f32 — hence u8 is opt-in.

        ``cache_dir``: enable the decoded-u8 gallery cache
        (input.cache.DecodedU8Cache) under this directory — the first
        encode pass decodes and appends raw rows; every later pass over
        the same files (the eval batteries' repeated encodes, re-indexing)
        streams them at cache-read speed instead of decode speed."""
        self.encode_fn = encode_fn
        self.batch_size = batch_size
        self.image_size = image_size
        self.num_workers = num_workers
        self.similarity: Similarity = similarity
        self.c = c
        self.mesh = mesh
        self.scan_batches = max(1, scan_batches)
        self._scan_encode = encode_many_fn
        if input_dtype not in ("f32", "u8"):
            raise ValueError(f"input_dtype must be 'f32'|'u8', {input_dtype}")
        self.input_dtype = input_dtype
        if self.scan_batches > 1 and encode_many_fn is None:
            raise ValueError("scan_batches > 1 requires encode_many_fn "
                             "(build one with make_scan_encoder)")
        self._cache = None
        if cache_dir is not None:
            from ..input.cache import DecodedU8Cache

            self._cache = DecodedU8Cache(cache_dir, image_size)
        self.index: EmbeddingIndex | None = None

    def close(self) -> None:
        """Flush + close the engine-owned decoded-u8 cache (idempotent).
        The engine constructs the cache, so it owns the lifecycle the
        pipeline docstring assigns to the caller."""
        if self._cache is not None:
            self._cache.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------- encoding
    def encode_paths(self, image_paths: Sequence[str]
                     ) -> tuple[np.ndarray, list[str]]:
        """Decode+encode images; returns (embeddings [N, D], kept paths)."""
        batcher = ImageBatcher(image_paths, batch_size=self.batch_size,
                               image_size=self.image_size,
                               num_workers=self.num_workers,
                               out_dtype=self.input_dtype,
                               cache=self._cache)
        embs, names = [], []
        pending: list[tuple[np.ndarray, list[str], int]] = []

        def flush():
            if not pending:
                return
            if (self.scan_batches > 1
                    and len(pending) == self.scan_batches):
                # only FULL stacks ride the scan program: an odd-sized
                # tail (gallery batches % scan_batches != 0) would have a
                # new leading dim and pay a full ViT recompile just for
                # the tail — pad the stack with a copy of the last batch
                # instead and drop the padded outputs
                stacked = jnp.asarray(np.stack([b for b, _, _ in pending]))
                outs = np.asarray(self._scan_encode(stacked))
                for i, (_b, paths, n_valid) in enumerate(pending):
                    embs.append(outs[i, :n_valid])
                    names.extend(paths)
            elif self.scan_batches > 1 and len(pending) > 1:
                # tail flush: pad to the compiled scan shape (the padded
                # slots re-encode the last real batch; their outputs are
                # discarded below) — same program, zero recompiles
                stack = [b for b, _, _ in pending]
                stack += [stack[-1]] * (self.scan_batches - len(stack))
                outs = np.asarray(self._scan_encode(
                    jnp.asarray(np.stack(stack))))
                for i, (_b, paths, n_valid) in enumerate(pending):
                    embs.append(outs[i, :n_valid])
                    names.extend(paths)
            else:
                for batch, paths, n_valid in pending:
                    out = np.asarray(self.encode_fn(jnp.asarray(batch)))
                    embs.append(out[:n_valid])
                    names.extend(paths)
            pending.clear()

        for batch, paths, n_valid in batcher:
            if n_valid == 0:
                continue
            pending.append((batch, paths, n_valid))
            if len(pending) >= self.scan_batches:
                flush()
        flush()
        if self._cache is not None:
            self._cache.flush()       # persist manifest for the next pass
        if not embs:
            return np.zeros((0, 0), np.float32), []
        return np.concatenate(embs, axis=0), names

    def encode_dataset(self, gallery_folder_or_paths: str | Sequence[str],
                       save_prefix: str | None = None) -> EmbeddingIndex:
        """Encode the gallery and build the index (cell 2 ``encode_dataset``)."""
        if isinstance(gallery_folder_or_paths, str):
            paths = list_images(gallery_folder_or_paths)
        else:
            paths = list(gallery_folder_or_paths)
        emb, names = self.encode_paths(paths)
        self.index = EmbeddingIndex(emb, names, similarity=self.similarity,
                                    c=self.c, mesh=self.mesh)
        if save_prefix is not None:
            os.makedirs(os.path.dirname(save_prefix) or ".", exist_ok=True)
            self.index.save(save_prefix)
        return self.index

    def load_embeddings(self, prefix: str) -> EmbeddingIndex:
        """Load a saved index (cell 2 ``load_embeddings``)."""
        self.index = EmbeddingIndex.load(prefix, similarity=self.similarity,
                                         c=self.c, mesh=self.mesh)
        return self.index

    # ------------------------------------------------------------ retrieval
    def retrieve_similar_images(self, query_path: str, k: int = 20
                                ) -> list[tuple[str, float]]:
        """Single-query API matching cell 2 ``retrieve_similar_images``."""
        if self.index is None:
            raise ValueError("No database embeddings found. "
                             "Please encode dataset first.")
        emb, _names = self.encode_paths([query_path])
        if emb.shape[0] == 0:
            # the pipeline skips failed decodes by design; a single-query
            # caller needs a clean error, not an empty [0, 0] array fed
            # into the index (shape-mismatch crash — server.py turns this
            # ValueError into a 400)
            raise ValueError(f"query image failed to decode: {query_path}")
        return self.index.search_names(emb, k=k)[0]

    def rank_queries(self, query_folder_or_paths: str | Sequence[str],
                     k: int | None = None) -> dict[str, list[str]]:
        """Encode all queries and produce full (or top-k) gallery rankings
        keyed by query basename, values gallery basenames best-first."""
        if self.index is None:
            raise ValueError("No database embeddings found.")
        if isinstance(query_folder_or_paths, str):
            qpaths = list_images(query_folder_or_paths)
        else:
            qpaths = list(query_folder_or_paths)
        qemb, qnames = self.encode_paths(qpaths)
        if len(qnames) == 0:
            return {}
        kk = k if k is not None else len(self.index)
        _vals, idx = self.index.search(qemb, k=kk)
        gallery_basenames = [os.path.basename(n) for n in self.index.names]
        out = {}
        for q, row in zip(qnames, idx):
            key = os.path.basename(q)
            if key in out:
                # list_images walks recursively: identically-named queries
                # in different subdirectories would silently collapse to
                # one entry and evaluate() would score a smaller query set
                raise ValueError(
                    f"duplicate query basename {key!r}: rankings are keyed "
                    "by basename (the reference ground-truth convention) — "
                    "deduplicate the query set or flatten the directory")
            out[key] = [gallery_basenames[j] for j in row]
        return out

    # ----------------------------------------------------------- evaluation
    def evaluate(self, query_folder_or_paths: str | Sequence[str],
                 ground_truth: Mapping | str,
                 positives_key: str = "patent_positives",
                 results_path: str | None = None) -> RetrievalMetrics:
        """Full evaluation matching retrieval.ipynb cell 3: full-gallery
        rankings per query, reference metric battery, optional JSON dump in
        the reference's ``detailed_results`` schema."""
        if isinstance(ground_truth, str):
            with open(ground_truth) as f:
                ground_truth = json.load(f)
        rankings = self.rank_queries(query_folder_or_paths, k=None)
        metrics = evaluate_rankings(rankings, ground_truth,
                                    positives_key=positives_key)
        if results_path is not None:
            os.makedirs(os.path.dirname(results_path) or ".", exist_ok=True)
            metrics.save(results_path)
        return metrics
