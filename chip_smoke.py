#!/usr/bin/env python3
"""Smoke test of patent_tpu's serving and fine-tune paths on one NVIDIA GPU.

    python chip_smoke.py           # one GPU: every phase below
    python chip_smoke.py --four    # four GPUs: only the sharded paths

One process, one card, ViT-B/16 @224 at full width with random weights made
from a seed (no CLIP weights ship with the repository).  Phases:

  1. probe      — card name and power limit, JAX devices, optional packages,
                  the compiled ViT-B/16 serving step's memory analysis;
  2. native     — build and load native/libpatent_io.so for this host;
  3. corpus     — write a synthetic views corpus of a few thousand figures;
  4. serve      — ``train.py serve`` (cli.main) on threads in the default,
                  ``--quantize`` and ``--profile recommended`` modes; a few
                  concurrent /search requests each; every figure queried by
                  name must rank itself first;
  5. numerics   — bf16/int8 towers vs a float32 reference tower, the
                  default/int8/Poincaré searches at 1M×512 vs an f32
                  brute force, cuDNN attention vs XLA;
  6. finetune   — a few fine-tune steps at 32 pairs: finite, decreasing loss;
                  compiled memory at 32 and 128 pairs;
  7. timings    — informational: embed img/s, top-k QPS, attention and
                  per-block candidate-selection A/Bs.

``--four`` runs the sharded cosine, cosine-candidate, int8 and Poincaré
searches on a 4M×512 gallery row-sharded over four GPUs, each compared index
for index with the single-device search of the same data, and one sharded
fine-tune step.

Any failed check raises and the script exits non-zero.  Without a GPU it
exits non-zero before printing anything.  The last line of a passing run is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from contextlib import contextmanager

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# sizes of the one-card run (the --four gallery is GALLERY_ROWS_FOUR)
GALLERY_ROWS = 1_000_000
GALLERY_ROWS_FOUR = 4_000_000
DIM = 512
CHECK_QUERIES = 64
QPS_QUERIES = 256
CORPUS_PATENTS = 600
FIGURES_PER_PATENT = 5
FINETUNE_PAIRS = 32
EMBED_BATCH = 128
SEED = 0


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


@contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    print(f"== {name}", flush=True)
    yield
    print(f"== {name} ok ({time.perf_counter() - t0:.1f} s)", flush=True)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    check(r.returncode == 0, f"nvidia-smi failed: {r.stderr}")
    return r.stdout.strip()


def timed(fn, iters: int = 10) -> float:
    from patent_tpu.utils.timing import timed_seconds_per_iter

    return timed_seconds_per_iter(fn, iters)


def vit_config():
    from patent_tpu.models.vit import VIT_B16

    return VIT_B16


def drawings(n: int, size: int, seed: int) -> np.ndarray:
    """Drawing-like u8 batch [n, size, size, 3]."""
    from patent_tpu.data.synthetic import synthetic_drawing_arrays

    return (synthetic_drawing_arrays(n, size, seed=seed) * 255).astype(
        np.uint8)


# ---------------------------------------------------------------- phases

def phase_probe() -> None:
    import importlib.util

    import jax
    import jax.numpy as jnp

    from patent_tpu.models.vit import VisionTransformer

    print("devices:", jax.devices())
    print("device_kind:", jax.devices()[0].device_kind)
    for mod in ("flax", "PIL", "orbax"):
        print(f"import {mod}:", importlib.util.find_spec(mod) is not None)
    cfg = vit_config()
    model = VisionTransformer(cfg, dtype=jnp.bfloat16, cls_last=True)
    params = jax.eval_shape(model.init, jax.random.key(SEED))
    x = jax.ShapeDtypeStruct((EMBED_BATCH, cfg.image_size, cfg.image_size, 3),
                             jnp.float32)
    compiled = jax.jit(model.apply).lower(params, x).compile()
    print(f"ViT-B/16 bf16 serving step, batch {EMBED_BATCH}:",
          compiled.memory_analysis())


def phase_native() -> None:
    from patent_tpu.input import native

    check(native.native_available(), "native decoder did not build/load")
    print("native decoder:", native._lib_path())


def phase_corpus(root: str) -> int:
    from patent_tpu.data import (build_ground_truth, save_ground_truth,
                                 split_query_gallery, synthetic)

    records = synthetic.synthetic_records(num_patents=CORPUS_PATENTS,
                                          figures_per_patent=FIGURES_PER_PATENT,
                                          seed=SEED)
    q_recs, g_recs = split_query_gallery(records, seed=42)
    size = vit_config().image_size
    with cf.ThreadPoolExecutor(8) as ex:
        futs = []
        for recs, d in ((g_recs, "test_gallery"), (q_recs, "test_query")):
            for i in range(0, len(recs), 256):
                futs.append(ex.submit(synthetic.write_synthetic_view_images,
                                      recs[i:i + 256], os.path.join(root, d),
                                      image_size=size, seed=SEED))
        for f in futs:
            f.result()
    save_ground_truth(build_ground_truth(q_recs, g_recs, max_month=None),
                      os.path.join(root, "ground_truth.json"))
    print(f"corpus: {len(g_recs)} gallery + {len(q_recs)} query figures "
          f"at {size}px under {root}")
    return len(g_recs)


def _post(port: int, path: str, payload: dict) -> dict:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        return json.loads(r.read())


def _wait_healthy(port: int, thread: threading.Thread, timeout: float) -> dict:
    t0 = time.time()
    while time.time() - t0 < timeout:
        check(thread.is_alive(), f"server on port {port} exited")
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/healthz", timeout=5) as r:
                return json.loads(r.read())
        except OSError:
            time.sleep(1.0)
    raise AssertionError(f"server on port {port} not up after {timeout} s")


def phase_serve(root: str, n_gallery: int) -> None:
    from patent_tpu.cli.main import main as cli_main

    modes = {"default": [], "quantize": ["--quantize"],
             "recommended": ["--profile", "recommended"]}
    names = sorted(os.listdir(os.path.join(root, "test_gallery")))
    for i, (mode, flags) in enumerate(modes.items()):
        port = 18800 + i
        argv = ["serve", "--path", root, "--port", str(port)] + flags
        t = threading.Thread(target=cli_main, args=(argv,), daemon=True)
        t0 = time.perf_counter()
        t.start()
        health = _wait_healthy(port, t, timeout=900)
        check(health["gallery_size"] == n_gallery,
              f"{mode}: gallery {health['gallery_size']} != {n_gallery}")
        up = time.perf_counter() - t0
        probe = names
        with cf.ThreadPoolExecutor(16) as ex:
            outs = list(ex.map(lambda n: _post(
                port, "/search_by_name", {"name": n, "k": 5}), probe))
        for n, out in zip(probe, outs):
            top = out["results"][0][0]["name"]
            check(top == n, f"{mode}: {n} ranked {top} first")
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/stats",
                                    timeout=60) as r:
            dim = json.loads(r.read())["dim"]
        feats = np.random.default_rng(1).standard_normal((8, dim))
        out = _post(port, "/search", {"features": feats.tolist(), "k": 10})
        check(len(out["results"]) == 8
              and all(len(r) == 10 for r in out["results"]),
              f"{mode}: bad /search shape")
        print(f"serve[{mode}]: up (encode {n_gallery} figures) in {up:.1f} s;"
              f" all {len(probe)} gallery figures, queried by name over 16 "
              f"concurrent clients, rank themselves first")


def _min_cosine(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.min(np.sum(a * b, -1) / np.linalg.norm(a, axis=-1)
                        / np.linalg.norm(b, axis=-1)))


def phase_tower_numerics() -> dict:
    import jax
    import jax.numpy as jnp

    from patent_tpu.input.pipeline import device_normalize
    from patent_tpu.models.vit import VisionTransformer
    from patent_tpu.models.vit_int8 import (Int8VisionTransformer,
                                            quantize_vit_params)

    cfg = vit_config()
    params = jax.jit(VisionTransformer(cfg).init)(jax.random.key(SEED))
    x = jax.jit(device_normalize)(jnp.asarray(drawings(32, cfg.image_size,
                                                       SEED + 1)))
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(VisionTransformer(cfg, dtype=jnp.float32).apply)(
            params, x)
    bf16 = jax.jit(VisionTransformer(cfg, dtype=jnp.bfloat16,
                                     cls_last=True).apply)(params, x)
    qparams = {"params": quantize_vit_params(params["params"])}
    int8 = jax.jit(Int8VisionTransformer(cfg).apply)(qparams, x)
    cos16, cos8 = _min_cosine(bf16, ref), _min_cosine(int8, ref)
    print(f"tower bf16 vs f32 reference (precision highest), 32 drawings: "
          f"min feature cosine {cos16:.6f} (limit >= 0.999)")
    print(f"tower int8 vs f32 reference (precision highest), 32 drawings: "
          f"min feature cosine {cos8:.6f} (limit >= 0.99)")
    check(np.isfinite(np.asarray(bf16)).all()
          and np.isfinite(np.asarray(int8)).all(), "non-finite features")
    check(cos16 >= 0.999, f"bf16 tower cosine {cos16} < 0.999")
    check(cos8 >= 0.99, f"int8 tower cosine {cos8} < 0.99")
    return {"params": params, "qparams": qparams}


def make_gallery(n: int, seed: int, ball_c: float | None = None):
    """[n, DIM] f32 gallery made on the device from a seed; rows on the
    Poincaré ball (radius ≤ 0.9/√c) when ``ball_c`` is given."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def gen(key):
        g = jax.random.normal(key, (n, DIM), jnp.float32)
        if ball_c is None:
            return g
        k2 = jax.random.fold_in(key, 1)
        r = jax.random.uniform(k2, (n, 1), minval=0.05, maxval=0.9)
        return g / jnp.linalg.norm(g, axis=-1, keepdims=True) * r \
            / np.sqrt(ball_c)

    return gen(jax.random.key(seed))


def host_gallery(n: int, seed: int, ball_c: float | None = None
                 ) -> np.ndarray:
    """``make_gallery`` copied to the host; the device copy is freed."""
    dev = make_gallery(n, seed, ball_c)
    host = np.array(dev)
    dev.delete()
    return host


def queries_for(gallery, n: int, seed: int, ball_c: float | None = None):
    """Half near-duplicates of gallery rows, half fresh draws."""
    import jax
    import jax.numpy as jnp

    key = jax.random.key(seed)
    rows = jax.random.randint(key, (n // 2,), 0, gallery.shape[0])
    near = gallery[rows] + 0.01 * jax.random.normal(
        jax.random.fold_in(key, 1), (n // 2, DIM))
    fresh = make_gallery(n - n // 2, seed + 7, ball_c)
    q = jnp.concatenate([near, fresh])
    if ball_c is not None:
        from patent_tpu.ops import poincare

        q = poincare.project(q, ball_c)
    return q


def brute_force(q, g, k: int, similarity: str, c: float = 1.0):
    """Independent f32 brute force at HIGHEST precision: the whole [Q, N]
    score matrix, one top_k."""
    import jax
    import jax.numpy as jnp

    from patent_tpu.ops import poincare

    @jax.jit
    def run(q, g):
        if similarity == "cosine":
            qn = q / jnp.linalg.norm(q, axis=-1, keepdims=True)
            gn = g / jnp.linalg.norm(g, axis=-1, keepdims=True)
            s = jnp.dot(qn, gn.T, precision=jax.lax.Precision.HIGHEST)
        else:
            s = -poincare.pairwise_dist(q, g, c)
        return jax.lax.top_k(s, k)

    v, i = run(q, g)
    return np.asarray(v), np.asarray(i)


def poincare_dist_f64(q, g_rows, c: float) -> np.ndarray:
    q = np.asarray(q, np.float64)[:, None, :]
    g = np.asarray(g_rows, np.float64)
    diff = np.sum((q - g) ** 2, -1)
    den = (1 - c * np.sum(q * q, -1)) * (1 - c * np.sum(g * g, -1))
    return np.arccosh(1 + 2 * c * diff / den) / np.sqrt(c)


def phase_search_numerics() -> None:
    import jax

    from patent_tpu.retrieval.index import EmbeddingIndex

    n, k, c = GALLERY_ROWS, 10, 2.0
    g = make_gallery(n, SEED + 11)
    q = queries_for(g, CHECK_QUERIES, SEED + 12)
    names = [str(i) for i in range(n)]
    g_host = np.asarray(g)
    bv, bi = brute_force(q, g, k, "cosine")
    for label, quantized in (("cosine (bf16 candidates + f32 re-rank)",
                              False), ("int8 cosine", True)):
        index = EmbeddingIndex(g if not quantized else g_host, names,
                               quantized=quantized)
        v, i = index.search(np.asarray(q), k=k)
        same = np.array_equal(i, bi)
        dv = float(np.max(np.abs(v - bv)))
        print(f"search {label} @ {n}x{DIM}, {CHECK_QUERIES} queries vs f32 "
              f"HIGHEST brute force: top-{k} indices identical={same}, "
              f"max |value diff| {dv:.2e} (limit 1e-5)")
        check(same, f"{label}: top-{k} indices differ from brute force")
        check(dv <= 1e-5, f"{label}: values differ by {dv}")
        del index
    gb = make_gallery(n, SEED + 13, ball_c=c)
    qb = queries_for(gb, CHECK_QUERIES, SEED + 14, ball_c=c)
    gb_host = np.asarray(gb)
    # reference: f32 HIGHEST brute force for a 64-deep shortlist, ordered
    # by the float64 direct-form distance (the f32 expanded form rounds
    # at ~2e-6, coarser than the gaps between far neighbours in 512-d)
    bv, bi = brute_force(qb, gb, 64, "poincare", c)
    d64 = poincare_dist_f64(qb, gb_host[bi], c)
    order = np.argsort(d64, axis=1, kind="stable")[:, :k]
    ref_i = np.take_along_axis(bi, order, axis=1)
    ref_v = -np.take_along_axis(d64, order, axis=1)
    index = EmbeddingIndex(gb_host, names, similarity="poincare", c=c,
                           quantized=True)
    v, i = index.search(np.asarray(qb), k=k)
    same = np.array_equal(i, ref_i)
    dv = float(np.max(np.abs(v - ref_v)))
    dv32 = float(np.max(np.abs(v - bv[:, :k])))
    print(f"search int8 Poincaré (c={c}) @ {n}x{DIM} vs f32 HIGHEST brute "
          f"force shortlist ordered in float64: top-{k} indices "
          f"identical={same}, max |value diff| {dv:.2e} (limit 1e-5); vs "
          f"the f32 brute-force values {dv32:.2e} (its rounding)")
    check(same, "Poincaré: top-k indices differ from the reference")
    check(dv <= 1e-5, f"Poincaré: values differ by {dv}")
    del index, g, gb
    jax.clear_caches()


def phase_attention_numerics() -> None:
    import jax
    import jax.numpy as jnp

    from patent_tpu.ops.attention import attention

    rng = np.random.default_rng(SEED)
    q, k, v = (jnp.asarray(rng.standard_normal((EMBED_BATCH, 197, 12, 64)),
                           jnp.bfloat16) for _ in range(3))
    a = jax.jit(lambda *t: attention(*t, implementation="cudnn"))(q, k, v)
    b = jax.jit(lambda *t: attention(*t, implementation="xla"))(q, k, v)
    d = float(jnp.max(jnp.abs(a.astype(jnp.float32) - b.astype(jnp.float32))))
    print(f"attention cuDNN vs XLA, bf16 [{EMBED_BATCH},197,12,64]: max abs "
          f"diff {d:.3e} (bf16 tolerance 2e-2)")
    check(d <= 2e-2, f"cuDNN attention differs from XLA by {d}")


def _finetune_setup(cfg, pairs: int):
    import jax.numpy as jnp

    from patent_tpu.train.finetune_clip import (init_finetune_state,
                                                make_finetune_step)
    from patent_tpu.utils.config import ClipFinetuneConfig

    ft_cfg = ClipFinetuneConfig(batch_size=pairs)
    vgae = np.random.default_rng(SEED).standard_normal(
        (4 * pairs, 128)).astype(np.float32)
    (vit, head), params, opt, opt_state = init_finetune_state(
        cfg, ft_cfg, vgae, seed=SEED)
    step, _eval = make_finetune_step(vit, head, opt, ft_cfg)
    images = jnp.asarray(drawings(2 * pairs, cfg.image_size, SEED + 3))
    nodes = jnp.arange(pairs, dtype=jnp.int32)
    return step, params, opt_state, images, nodes


def phase_finetune() -> None:
    import jax

    cfg = vit_config()
    for pairs in (4 * FINETUNE_PAIRS, FINETUNE_PAIRS):
        step, params, opt_state, images, nodes = _finetune_setup(cfg, pairs)
        compiled = step.lower(params, opt_state, images, nodes, 0.1).compile()
        print(f"finetune step, {pairs} pairs: memory_analysis "
              f"{compiled.memory_analysis()}")
    step = compiled
    losses = []
    for _ in range(6):
        params, opt_state, m = step(params, opt_state, images, nodes, 0.1)
        losses.append(float(m["loss"]))
    print(f"finetune losses ({FINETUNE_PAIRS} pairs, one fixed batch): "
          f"{[round(x, 5) for x in losses]}")
    check(all(np.isfinite(losses)), "non-finite fine-tune loss")
    check(losses[-1] < losses[0], "fine-tune loss did not decrease")
    state = {"p": params, "o": opt_state}

    def one():
        state["p"], state["o"], m = step(state["p"], state["o"], images,
                                         nodes, 0.1)
        return m["loss"]

    ms = timed(one, iters=10) * 1e3
    print(f"finetune step time ({FINETUNE_PAIRS} pairs): {ms:.2f} ms "
          f"({2 * FINETUNE_PAIRS / ms * 1e3:.0f} img/s)")
    del state
    jax.clear_caches()


def _block_select_ab() -> None:
    """Per-block candidate selection inside the bf16 pool scan at 1M rows:
    ``lax.approx_max_k`` against ``lax.top_k``."""
    import jax
    import jax.numpy as jnp

    n, block, pool = GALLERY_ROWS, 8192, 80
    g = make_gallery(n, SEED + 21).astype(jnp.bfloat16)
    q = make_gallery(QPS_QUERIES, SEED + 22).astype(jnp.bfloat16)
    gal = jnp.pad(g, ((0, -n % block), (0, 0))).reshape(-1, block, DIM)

    def scan(select):
        @jax.jit
        def run(q, gal):
            def body(carry, blk):
                s = jax.lax.dot_general(q, blk, (((1,), (1,)), ((), ())),
                                        preferred_element_type=jnp.float32)
                bv, _ = select(s)
                cv = jnp.concatenate([carry, bv], axis=1)
                return jax.lax.top_k(cv, pool)[0], None
            init = jnp.full((q.shape[0], pool), -jnp.inf, jnp.float32)
            return jax.lax.scan(body, init, gal)[0]
        return run

    top = scan(lambda s: jax.lax.top_k(s, pool))
    approx = scan(lambda s: jax.lax.approx_max_k(s, pool,
                                                 recall_target=0.99))
    for label, fn in (("top_k", top), ("approx_max_k", approx),
                      ("top_k", top), ("approx_max_k", approx)):
        ms = timed(lambda: fn(q, gal), iters=5) * 1e3
        print(f"timing: pool scan {QPS_QUERIES}q x {n} bf16, per-block "
              f"{label}: {ms:.2f} ms ({QPS_QUERIES / ms * 1e3:.0f} QPS)")


def phase_timings(ctx: dict) -> None:
    import jax
    import jax.numpy as jnp

    from patent_tpu.input.pipeline import device_normalize
    from patent_tpu.models.vit import VisionTransformer
    from patent_tpu.models.vit_int8 import Int8VisionTransformer
    from patent_tpu.ops.attention import attention
    from patent_tpu.retrieval.index import EmbeddingIndex

    cfg = vit_config()
    x = jnp.asarray(drawings(EMBED_BATCH, cfg.image_size, SEED + 5))
    for label, model, p in (
            ("bf16", VisionTransformer(cfg, dtype=jnp.bfloat16,
                                       cls_last=True), ctx["params"]),
            ("int8", Int8VisionTransformer(cfg), ctx["qparams"])):
        fn = jax.jit(lambda p, x, m=model: m.apply(p, device_normalize(x)))
        ms = timed(lambda: fn(p, x)) * 1e3
        print(f"timing: embed {label} ViT-B/16, batch {EMBED_BATCH} u8: "
              f"{EMBED_BATCH / ms * 1e3:.0f} img/s ({ms:.2f} ms/batch)")

    rng = np.random.default_rng(SEED)
    for label, impl in (("cudnn", "cudnn"), ("xla", "xla")) * 2:
        q, k, v = (jnp.asarray(rng.standard_normal((EMBED_BATCH, 197, 12, 64)),
                               jnp.bfloat16) for _ in range(3))
        fwd = jax.jit(lambda q, k, v, i=impl: attention(
            q, k, v, implementation=i))
        ms_f = timed(lambda: fwd(q, k, v), iters=20) * 1e3
        qb, kb, vb = (t[:2 * FINETUNE_PAIRS] for t in (q, k, v))
        grad = jax.jit(jax.grad(
            lambda q, k, v, i=impl: jnp.sum(attention(
                q, k, v, implementation=i).astype(jnp.float32)),
            argnums=(0, 1, 2)))
        ms_b = timed(lambda: grad(qb, kb, vb), iters=20) * 1e3
        print(f"timing: attention {label} bf16 S=197 H=12 D=64: forward "
              f"batch {EMBED_BATCH} {ms_f:.3f} ms; forward+backward batch "
              f"{2 * FINETUNE_PAIRS} {ms_b:.3f} ms")

    n = GALLERY_ROWS
    names = [str(i) for i in range(n)]
    g = make_gallery(n, SEED + 31)
    q = np.asarray(queries_for(g, QPS_QUERIES, SEED + 32))
    for label, kwargs, gal in (
            ("cosine", {}, g),
            ("int8 cosine", {"quantized": True}, np.asarray(g)),
            ("int8 Poincaré", {"quantized": True, "similarity": "poincare",
                               "c": 2.0},
             np.asarray(make_gallery(n, SEED + 33, ball_c=2.0)))):
        index = EmbeddingIndex(gal, names, **kwargs)
        ms = timed(lambda: index.search(q, k=10)[1], iters=5) * 1e3
        print(f"timing: EmbeddingIndex.search {label} @ {n}x{DIM}, "
              f"{QPS_QUERIES} queries, k=10: {QPS_QUERIES / ms * 1e3:.0f} "
              f"QPS ({ms:.2f} ms/batch)")
        del index
    del g
    _block_select_ab()


# --------------------------------------------------------------- four GPUs

def run_four() -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from patent_tpu.retrieval.index import (EmbeddingIndex, shard_rows,
                                            sharded_topk_search, topk_search)

    devs = jax.devices()
    check(len(devs) == 4, f"--four needs 4 GPUs, found {len(devs)}")
    mesh = Mesh(np.asarray(devs), ("data",))
    n, k = GALLERY_ROWS_FOUR, 10
    names = [str(i) for i in range(n)]
    g = host_gallery(n, SEED + 41)
    q = np.asarray(queries_for(jnp.asarray(g[: n // 4]), CHECK_QUERIES,
                               SEED + 42))
    gallery_bytes = g.nbytes

    def device_bytes() -> list[int]:
        """Bytes of live arrays held on each device."""
        held = dict.fromkeys(devs, 0)
        for arr in jax.live_arrays():
            for shard in arr.addressable_shards:
                held[shard.device] += shard.data.nbytes
        return [held[d] for d in devs]

    def check_spread(used: list[int], whole: int) -> None:
        """Row-sharded: every device holds about the same share, and none
        holds the whole gallery."""
        print(f"device bytes held: {used} (whole f32 gallery {whole})")
        check(max(used) < whole, "a device holds the whole gallery")
        check(max(used) - min(used) < whole / 8,
              "gallery memory is not spread evenly over the devices")

    with phase("four: sharded cosine searches"):
        fast = EmbeddingIndex(g, names, mesh=mesh)
        check_spread(device_bytes(), gallery_bytes)
        fv, fi = fast.search(q, k=k)
        del fast
        (gs,) = shard_rows(mesh, "data", g)
        sv, si = sharded_topk_search(mesh, jnp.asarray(q), gs, k=k,
                                     n_valid=n)
        del gs
        qi = EmbeddingIndex(g, names, mesh=mesh, quantized=True)
        check_spread(device_bytes(), gallery_bytes)
        qv, qi_idx = qi.search(q, k=k)
        del qi
        single = jax.device_put(g, devs[0])
        ov, oi = topk_search(jnp.asarray(q), single, k=k)
        ov, oi = np.asarray(ov), np.asarray(oi)
        del single
        q1 = EmbeddingIndex(g, names, quantized=True)
        q1v, q1i = q1.search(q, k=k)
        del q1
        for label, (v, i), (rv, ri) in (
                ("sharded cosine scan", (sv, si), (ov, oi)),
                ("sharded cosine candidates", (fv, fi), (ov, oi)),
                ("sharded int8", (qv, qi_idx), (q1v, q1i))):
            same = np.array_equal(np.asarray(i), np.asarray(ri))
            dv = float(np.max(np.abs(np.asarray(v) - np.asarray(rv))))
            print(f"four: {label} @ {n}x{DIM} vs single device: indices "
                  f"identical={same}, max |value diff| {dv:.2e}")
            check(same, f"{label}: indices differ from single device")
            check(dv <= 1e-5, f"{label}: values differ by {dv}")
    del g
    with phase("four: sharded Poincaré search"):
        c = 2.0
        gb = host_gallery(n, SEED + 43, ball_c=c)
        qb = np.asarray(queries_for(jnp.asarray(gb[: n // 4]), CHECK_QUERIES,
                                    SEED + 44, ball_c=c))
        sh = EmbeddingIndex(gb, names, similarity="poincare", c=c,
                            quantized=True, mesh=mesh)
        check_spread(device_bytes(), gb.nbytes)
        sv, si = sh.search(qb, k=k)
        del sh
        one = EmbeddingIndex(gb, names, similarity="poincare", c=c,
                             quantized=True)
        ov, oi = one.search(qb, k=k)
        del one
        same = np.array_equal(si, oi)
        dv = float(np.max(np.abs(sv - ov)))
        print(f"four: sharded int8 Poincaré @ {n}x{DIM} vs single device: "
              f"indices identical={same}, max |value diff| {dv:.2e}")
        check(same and dv <= 1e-5, "sharded Poincaré differs")
    with phase("four: sharded fine-tune step"):
        from patent_tpu.models.vit import VIT_B16, VisionConfig
        from patent_tpu.train.finetune_clip import (
            init_finetune_state, make_sharded_finetune_step,
            pad_graph_table, shard_finetune_state)
        from patent_tpu.utils.config import ClipFinetuneConfig

        # full ViT-B/16 width, depth cut to 2 layers for the compile time
        cfg = VisionConfig(num_layers=2, hidden_dim=VIT_B16.hidden_dim,
                           num_heads=VIT_B16.num_heads,
                           mlp_dim=VIT_B16.mlp_dim)
        fmesh = Mesh(np.asarray(devs).reshape(2, 2), ("data", "model"))
        pairs = 8
        fcfg = ClipFinetuneConfig(batch_size=pairs, trainable_blocks=2)
        vgae = np.random.default_rng(SEED).standard_normal(
            (37, 128)).astype(np.float32)
        (vit, head), params, opt, opt_state = init_finetune_state(
            cfg, fcfg, vgae, seed=SEED)
        params, opt_state, _real, _pad = pad_graph_table(params, opt_state, 2)
        params, opt_state = shard_finetune_state(fmesh, params, opt_state)
        step, _ev, place = make_sharded_finetune_step(fmesh, vit, head, opt,
                                                      fcfg)
        images, nodes = place(drawings(2 * pairs, cfg.image_size, SEED + 6),
                              np.arange(pairs, dtype=np.int32))
        params, opt_state, m = step(params, opt_state, images, nodes, 0.1)
        loss = float(m["loss"])
        print(f"four: sharded fine-tune step over a 2x2 (data, model) mesh, "
              f"{pairs} pairs: loss {loss:.5f}")
        check(np.isfinite(loss), "non-finite sharded fine-tune loss")


# ------------------------------------------------------------------- main

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded paths on four GPUs")
    args = ap.parse_args(argv)

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX default device is "
              f"{devs[0].platform}); nothing run", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from patent_tpu.utils.compile_cache import enable_compilation_cache

    print("card:", card_line())
    print("compile cache:", enable_compilation_cache())
    if args.four:
        run_four()
    else:
        with phase("1 probe"):
            phase_probe()
        with phase("2 native decoder"):
            phase_native()
        with tempfile.TemporaryDirectory(dir=ROOT,
                                         prefix=".smoke_corpus_") as root:
            with phase("3 corpus"):
                n_gallery = phase_corpus(root)
            with phase("4 serve"):
                phase_serve(root, n_gallery)
        with phase("5 numerics"):
            ctx = phase_tower_numerics()
            phase_search_numerics()
            phase_attention_numerics()
        with phase("6 finetune"):
            phase_finetune()
        with phase("7 timings (informational)"):
            phase_timings(ctx)
    print("card:", card_line())
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
