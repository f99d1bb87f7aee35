"""Host-side image input pipeline: decode → resize → normalize → device batches.

Replaces the reference's ``torch.utils.data.DataLoader`` + torchvision stack
(retrieval.ipynb cell 2 ``ImageDataset``, src/models.py:77-95) with a
thread-pooled decoder feeding fixed-shape NHWC numpy batches — the device
side stays a single static-shape jit.  Semantics match the reference:

* decode → float32 in [0, 1],
* grayscale (1-channel) repeated to 3 channels, RGBA truncated to RGB
  (models.py:84-89),
* resize to 224×224 (torchvision ``Resize((224, 224))`` = bilinear,
  antialias — PIL's BILINEAR matches closely),
* CLIP normalization mean/std (retrieval.ipynb cell 2).

Failed decodes are skipped with a warning, preserving the reference's
failure policy (models.py:51-66 returns None → filtered in collate).

A native C++ decode/resize path (``patent_tpu.input.native``) is used
automatically when its extension is built; this module is the always-works
fallback and the correctness oracle for it.
"""

from __future__ import annotations

import concurrent.futures as cf
import functools
import logging
import os
from typing import Iterator, Sequence

import numpy as np

log = logging.getLogger(__name__)

# CLIP preprocessing constants (retrieval.ipynb cell 2)
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)
IMAGE_SIZE = 224

VALID_EXTENSIONS = {".jpg", ".jpeg", ".png", ".JPG", ".JPEG", ".PNG"}


def list_images(folder: str) -> list[str]:
    """Recursively list image files, matching the reference's extension set
    (retrieval.ipynb cell 3 ``valid_extensions`` + ``rglob``)."""
    out = []
    for root, _dirs, files in os.walk(folder):
        for f in files:
            if os.path.splitext(f)[1] in VALID_EXTENSIONS:
                out.append(os.path.join(root, f))
    return sorted(out)          # one global sort defines the order


def decode_image(path: str, image_size: int = IMAGE_SIZE) -> np.ndarray | None:
    """Decode one image → [H, W, 3] float32, CLIP-normalized; None when the
    file cannot be decoded.  A missing decoder (PIL) raises ImportError:
    turning it into None would silently empty a whole gallery."""
    from PIL import Image

    try:
        with Image.open(path) as im:
            im = im.convert("RGB")  # handles gray + RGBA like models.py:84-89
            im = im.resize((image_size, image_size), Image.BILINEAR)
            arr = np.asarray(im, np.float32) / 255.0
        return (arr - CLIP_MEAN) / CLIP_STD
    except Exception as e:  # failed decode → skip (reference policy)
        log.warning("failed to decode %s: %s", path, e)
        return None


def decode_image_u8(path: str, image_size: int = IMAGE_SIZE
                    ) -> np.ndarray | None:
    """Decode one image → [H, W, 3] uint8 RGB (no normalization); None on
    failure.  Pairs with a device-side ``(x/255 − mean)/std`` (see
    retrieval.engine.make_device_normalizing_encoder): uint8 batches are 4×
    smaller on the host→device link.  A missing PIL raises ImportError."""
    from PIL import Image

    try:
        with Image.open(path) as im:
            im = im.convert("RGB")
            im = im.resize((image_size, image_size), Image.BILINEAR)
            return np.asarray(im, np.uint8)
    except Exception as e:  # failed decode → skip (reference policy)
        log.warning("failed to decode %s: %s", path, e)
        return None


def device_normalize(batch):
    """CLIP-normalize a uint8 DEVICE batch inside a jit; float batches pass
    through unchanged (assumed pre-normalized).  The single shared contract
    for every ``out_dtype="u8"`` consumer (encode, scan encode, fine-tune
    step) — the jit specializes per input dtype, so the branch is free."""
    import jax.numpy as jnp

    if batch.dtype == jnp.uint8:
        batch = ((batch.astype(jnp.float32) / 255.0 - jnp.asarray(CLIP_MEAN))
                 * jnp.asarray(1.0 / CLIP_STD))
    return batch


def normalize_array(img: np.ndarray, image_size: int = IMAGE_SIZE) -> np.ndarray:
    """Normalize an already-decoded [H, W, C] uint8/float array (no resize)."""
    if img.dtype == np.uint8:
        img = img.astype(np.float32) / 255.0
    if img.ndim == 2:
        img = img[:, :, None]
    if img.shape[-1] == 1:
        img = np.repeat(img, 3, axis=-1)
    elif img.shape[-1] == 4:
        img = img[:, :, :3]
    return (img - CLIP_MEAN) / CLIP_STD


class ImageBatcher:
    """Threaded decode + fixed-shape batching with double-buffered prefetch.

    Equivalent of the reference's DataLoader(num_workers=16, prefetch_factor=8)
    (train.py:4292-4308) — but batches are NHWC numpy arrays ready for a
    static-shape jitted encoder, and the last partial batch is zero-padded to
    the full batch size with a validity count so device shapes never change.
    """

    def __init__(self, image_paths: Sequence[str], batch_size: int = 128,
                 image_size: int = IMAGE_SIZE, num_workers: int = 8,
                 prefetch: int = 4, drop_remainder: bool = False,
                 use_native: bool | None = None,
                 out_dtype: str = "f32", cache=None):
        """``out_dtype``: "f32" yields CLIP-normalized float32 batches;
        "u8" yields raw uint8 RGB (4× less host→device transfer — the
        encoder must normalize on device, see
        retrieval.engine.make_device_normalizing_encoder).

        ``cache``: optional ``input.cache.DecodedU8Cache`` — decode misses
        are appended; hits skip the decoder entirely, so repeat passes over
        the same gallery (the golden's bf16→int8→pruned triple encode, any
        re-index) stream at cache-read speed instead of decode speed.
        Caller owns the cache lifecycle (flush/close)."""
        self.image_paths = list(image_paths)
        self.batch_size = batch_size
        self.image_size = image_size
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.drop_remainder = drop_remainder
        if out_dtype not in ("f32", "u8"):
            raise ValueError(f"out_dtype must be 'f32' or 'u8', got {out_dtype}")
        self.out_dtype = out_dtype
        self._np_dtype = np.uint8 if out_dtype == "u8" else np.float32
        if use_native is None:
            from . import native

            use_native = native.native_available()
        self.use_native = use_native
        self.cache = cache
        if cache is not None and cache.image_size != image_size:
            raise ValueError(f"cache stores {cache.image_size}px rows, "
                             f"batcher wants {image_size}px")

    def __len__(self) -> int:
        n = len(self.image_paths)
        return n // self.batch_size if self.drop_remainder else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[tuple[np.ndarray, list[str], int]]:
        """Yields (batch [B, S, S, 3], valid paths, n_valid).

        Per-image decode futures flow through a bounded window
        (prefetch·batch_size) so decode overlaps with device compute; batches
        are assembled on the consumer thread (no nested pool waits).
        """
        from collections import deque

        paths = self.image_paths
        n = len(paths)
        if self.drop_remainder:
            n = (n // self.batch_size) * self.batch_size
        if self.use_native:
            yield from self._iter_native(paths, n)
            return
        window = max(self.batch_size * self.prefetch, self.batch_size)
        decode = decode_image_u8 if self.out_dtype == "u8" else decode_image
        if self.cache is not None:
            decode = self._decode_cached
        with cf.ThreadPoolExecutor(self.num_workers) as pool:
            futures: deque[tuple[cf.Future, str]] = deque()
            submitted = 0

            def top_up():
                nonlocal submitted
                while submitted < n and len(futures) < window:
                    p = paths[submitted]
                    futures.append(
                        (pool.submit(decode, p, self.image_size), p))
                    submitted += 1

            top_up()
            consumed = 0
            while consumed < n:
                take = min(self.batch_size, n - consumed)
                batch = np.zeros(
                    (self.batch_size, self.image_size, self.image_size, 3),
                    self._np_dtype)
                names: list[str] = []
                n_valid = 0
                for _ in range(take):
                    fut, p = futures.popleft()
                    top_up()
                    im = fut.result()
                    if im is not None:
                        batch[n_valid] = im
                        names.append(p)
                        n_valid += 1
                consumed += take
                yield batch, names, n_valid

    def _decode_cached(self, path: str, image_size: int) -> np.ndarray | None:
        return _cached_decode(self.cache, path, image_size, self.out_dtype)


def _cached_decode(cache, path: str, image_size: int,
                   out_dtype: str) -> np.ndarray | None:
    """Cache-first decode (shared by ImageBatcher and PairBatcher): hit →
    raw u8 row straight from the cache file; miss → full decode, appended
    for every later pass.  f32 output applies the identical normalization
    math decode_image uses (both start from the same post-resize u8
    array).  Thread-safe: DecodedU8Cache locks get/put internally."""
    arr = cache.get(path)
    if arr is None:
        arr = decode_image_u8(path, image_size)
        if arr is not None:
            cache.put(path, arr)
    if arr is None:
        return None
    return arr if out_dtype == "u8" else normalize_array(arr)


def _native_decode_chunk(chunk: list[str], image_size: int,
                         num_threads: int,
                         out_dtype: str = "f32",
                         cache=None) -> tuple[np.ndarray, list[int]]:
    """C++ threaded decode of one chunk + PIL retry for failed files.

    Returns (images [len(chunk), S, S, 3] in chunk order with failed rows
    dropped later, list of surviving positions).  With ``cache`` set,
    cached rows skip the native decoder and only misses are decoded (and
    appended)."""
    from . import native

    if cache is not None:
        rows: list[np.ndarray | None] = [cache.get(p) for p in chunk]
        miss = [i for i, r in enumerate(rows) if r is None]
        if miss:
            sub, sub_ok = _native_decode_chunk([chunk[i] for i in miss],
                                               image_size, num_threads, "u8")
            ok = set(sub_ok)
            for j, i in enumerate(miss):
                if j in ok:
                    rows[i] = sub[j]
                    cache.put(chunk[i], sub[j])
        batch = np.zeros((len(chunk), image_size, image_size, 3), np.uint8)
        survivors = []
        for i, r in enumerate(rows):
            if r is not None:
                batch[i] = r
                survivors.append(i)
        if out_dtype != "u8":
            batch = (batch.astype(np.float32) / 255.0 - CLIP_MEAN) / CLIP_STD
        return batch, survivors

    if out_dtype == "u8":
        batch, ok = native.decode_batch_native_u8(chunk, image_size,
                                                  num_threads)
        retry_fn = decode_image_u8
    else:
        batch, ok = native.decode_batch_native(chunk, image_size, num_threads)
        retry_fn = decode_image
    survivors: list[int] = []
    for i, good in enumerate(ok):
        if good:
            survivors.append(i)
            continue
        retry = retry_fn(chunk[i], image_size)       # non-PNG / exotic → PIL
        if retry is not None:
            batch[i] = retry
            survivors.append(i)
    return batch, survivors


def _iter_native(self, paths, n):
    """Batch iterator backed by the native decoder (native/patent_io.cc):
    the C++ thread pool decodes chunks while the previous chunk is consumed."""
    import concurrent.futures as cf

    executor = cf.ThreadPoolExecutor(1)   # pipeline: one chunk in flight
    try:
        pending = None
        starts = list(range(0, n, self.batch_size))
        for bi, start in enumerate(starts):
            chunk = paths[start:min(start + self.batch_size, n)]
            if pending is None:
                pending = executor.submit(_native_decode_chunk, chunk,
                                          self.image_size, self.num_workers,
                                          self.out_dtype, self.cache)
                cur_chunk = chunk
                continue
            nxt = executor.submit(_native_decode_chunk, chunk,
                                  self.image_size, self.num_workers,
                                  self.out_dtype, self.cache)
            batch, survivors = pending.result()
            yield self._emit(batch, cur_chunk, survivors)
            pending, cur_chunk = nxt, chunk
        if pending is not None:
            batch, survivors = pending.result()
            yield self._emit(batch, cur_chunk, survivors)
    finally:
        executor.shutdown(wait=False)


def _emit(self, batch, chunk, survivors):
    out = np.zeros((self.batch_size, self.image_size, self.image_size, 3),
                   self._np_dtype)
    names = []
    for slot, pos in enumerate(survivors):
        out[slot] = batch[pos]
        names.append(chunk[pos])
    return out, names, len(survivors)


# bound onto ImageBatcher below; module-level defs keep the native-path
# helpers greppable next to _native_decode_chunk (ordinary in-class
# methods would work too — globals resolve at call time)
ImageBatcher._iter_native = _iter_native
ImageBatcher._emit = _emit


class PairBatcher:
    """Threaded anchor∥positive pair batching with one-batch-ahead prefetch.

    Input stage for the CLIP fine-tune loop (L8): the reference feeds it
    with a DataLoader(num_workers=16-32, prefetch) (train.py:4292-4308);
    the framework's serial per-pair decode was host-bound.  A shared decode
    thread pool + a single assembler thread keep the NEXT batch decoding
    while the device steps on the current one.

    Semantics match the serial loader exactly: a pair is dropped when either
    side fails to decode (reference collate filters None), batches hold
    ``batch_size`` pairs (tail dropped unless the epoch is shorter than one
    batch), images are stacked anchors ∥ positives → [2b, S, S, 3].
    """

    def __init__(self, anchor_paths: Sequence[str],
                 positive_paths: Sequence[str], node_idx: Sequence[int],
                 batch_size: int = 32, image_size: int = IMAGE_SIZE,
                 num_workers: int = 8, use_native: bool | None = None,
                 out_dtype: str = "f32", cache=None):
        """``out_dtype="u8"``: yield raw uint8 RGB (the fine-tune step
        normalizes on device when it sees uint8 — 4× less host→device
        transfer per step).

        ``cache``: optional ``input.cache.DecodedU8Cache`` — the same
        contract as ImageBatcher's: decode misses are appended, hits skip
        the decoder, so every fine-tune epoch after the first streams at
        cache-read speed instead of decode speed (the reference's
        DataLoader re-decodes every image every epoch,
        /root/reference/src/train.py:4292-4308).  Caller owns the cache
        lifecycle (flush/close)."""
        assert len(anchor_paths) == len(positive_paths) == len(node_idx)
        self.anchors = list(anchor_paths)
        self.positives = list(positive_paths)
        self.node_idx = np.asarray(node_idx, np.int32)
        self.batch_size = batch_size
        self.image_size = image_size
        self.num_workers = max(1, num_workers)
        if out_dtype not in ("f32", "u8"):
            raise ValueError(f"out_dtype must be 'f32' or 'u8', got {out_dtype}")
        self.out_dtype = out_dtype
        if use_native is None:
            from . import native

            use_native = native.native_available()
        self.use_native = use_native
        self.cache = cache
        if cache is not None and cache.image_size != image_size:
            raise ValueError(f"cache stores {cache.image_size}px rows, "
                             f"batcher wants {image_size}px")
        self._pool = cf.ThreadPoolExecutor(self.num_workers)
        self._assembler = cf.ThreadPoolExecutor(1)

    def _assemble(self, ids: list[int]):
        """Decode one batch of pairs → (images [2b, S, S, 3], nodes [b])."""
        if self.use_native:
            paths = ([self.anchors[i] for i in ids]
                     + [self.positives[i] for i in ids])
            batch, survivors = _native_decode_chunk(paths, self.image_size,
                                                    self.num_workers,
                                                    self.out_dtype,
                                                    self.cache)
            alive = set(survivors)
            keep = [j for j in range(len(ids))
                    if j in alive and j + len(ids) in alive]
            if not keep:
                return None
            images = np.concatenate([batch[keep],
                                     batch[[j + len(ids) for j in keep]]])
            nodes = self.node_idx[[ids[j] for j in keep]]
            return images, nodes
        if self.cache is not None:
            decode = functools.partial(_cached_decode, self.cache,
                                       out_dtype=self.out_dtype)
        else:
            decode = (decode_image_u8 if self.out_dtype == "u8"
                      else decode_image)
        a_futs = [self._pool.submit(decode, self.anchors[i],
                                    self.image_size) for i in ids]
        p_futs = [self._pool.submit(decode, self.positives[i],
                                    self.image_size) for i in ids]
        pairs, nodes = [], []
        for i, fa, fp in zip(ids, a_futs, p_futs):
            a, p = fa.result(), fp.result()
            if a is None or p is None:
                continue
            pairs.append((a, p))
            nodes.append(self.node_idx[i])
        if not pairs:
            return None
        return (np.concatenate([np.stack([a for a, _ in pairs]),
                                np.stack([p for _, p in pairs])]),
                np.asarray(nodes, np.int32))

    def epoch(self, ids: Sequence[int]):
        """Iterate (images, nodes) batches over ``ids`` (an epoch order),
        prefetching one batch ahead of the consumer."""
        ids = [int(i) for i in ids]
        if len(ids) >= self.batch_size:
            usable = (len(ids) // self.batch_size) * self.batch_size
            batches = [ids[s:s + self.batch_size]
                       for s in range(0, usable, self.batch_size)]
        elif ids:
            batches = [ids]
        else:
            return
        pending = self._assembler.submit(self._assemble, batches[0])
        for k in range(len(batches)):
            nxt = (self._assembler.submit(self._assemble, batches[k + 1])
                   if k + 1 < len(batches) else None)
            out = pending.result()
            pending = nxt
            if out is not None:
                yield out

    def close(self):
        self._pool.shutdown(wait=False)
        self._assembler.shutdown(wait=False)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def shard_paths_per_host(paths: Sequence[str], host_id: int, num_hosts: int) -> list[str]:
    """Deterministic per-host shard of the file list (multi-host input:
    each host decodes its slice; device batches are formed per host)."""
    return list(paths)[host_id::num_hosts]
