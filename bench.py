#!/usr/bin/env python3
"""Benchmark of the serving and training hot paths — prints JSON lines,
each a complete, progressively richer result (consumers take the LAST).

Every section calls the public entry points users call and times them with
the host clock around work that ends in ``block_until_ready``
(``patent_tpu/utils/timing.py``); each repeats its window and reports the
median with ``[min, max]``:

  * embed_int8 / embed_bf16 — ViT-B/16 forward, batch 128, uint8 input
    normalized on the device (the engine's encoder), int8 and bf16 towers
  * topk_1M / topk_1M_int8 / poincare_1M — ``EmbeddingIndex.search`` at
    1M×512, 256 queries, k=10 (default cosine, ``quantized=True`` cosine,
    quantized Poincaré), each with its top-10 ordering parity against the
    exact scan
  * recall_parity — the exact search against a numpy brute force
  * finetune_step — ``make_finetune_step`` at 32 pairs
  * hyp_train — the train_hyp step (needs Flax; recorded as skipped
    without it)

Every line names the device (platform, kind, count) and the card's power
limit.  Without an accelerator the benchmark prints an error line and exits
non-zero: it never measures the CPU.  Sections that no longer fit the
budget (``PATENT_BENCH_DEADLINE_S``, default 900 s) are skipped and listed
in ``extras["skipped"]``.  The benchmark PR after this one redefines it.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

_SPREAD_REPS = 3


def _timed_spread(fn, units_per_iter: int, iters: int = 8,
                  reps: int = _SPREAD_REPS) -> tuple[float, list[float]]:
    """(median, [min, max]) units/s over ``reps`` windows."""
    from patent_tpu.utils.timing import timed_spread

    return timed_spread(fn, units_per_iter, iters, reps)


def _device_info() -> dict:
    import jax

    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def _card() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
        return r.stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def _embed_inputs(batch_size: int = 128):
    import jax
    import jax.numpy as jnp

    from patent_tpu.data.synthetic import synthetic_drawing_arrays
    from patent_tpu.models.vit import VIT_B16, VisionTransformer

    x = jnp.asarray((synthetic_drawing_arrays(batch_size, 224, seed=0)
                     * 255).astype(np.uint8))
    params = jax.jit(VisionTransformer(VIT_B16).init)(jax.random.key(0))
    return x, params


def _embed_fn(model):
    import jax

    from patent_tpu.input.pipeline import device_normalize

    return jax.jit(lambda p, x: model.apply(p, device_normalize(x)))


def bench_embed_int8(batch_size: int = 128) -> dict:
    """Int8 ViT-B/16 tower img/s on drawing-like u8 batches."""
    import jax.numpy as jnp

    from patent_tpu.models.vit import VIT_B16
    from patent_tpu.models.vit_int8 import (Int8VisionTransformer,
                                            quantize_vit_params)

    x, params = _embed_inputs(batch_size)
    qparams = {"params": quantize_vit_params(params["params"])}
    fn = _embed_fn(Int8VisionTransformer(VIT_B16, dtype=jnp.bfloat16))
    ips, spread = _timed_spread(lambda: fn(qparams, x), batch_size)
    return {"int8": ips, "int8_spread": spread,
            "_ctx": {"x": x, "params": params, "int8_feats": fn(qparams, x)}}


def bench_embed_bf16(ctx: dict, batch_size: int = 128) -> dict:
    """bf16 ViT-B/16 tower img/s, and the int8 tower's minimum feature
    cosine against it on the same drawings."""
    import jax.numpy as jnp

    from patent_tpu.models.vit import VIT_B16, VisionTransformer

    fn = _embed_fn(VisionTransformer(VIT_B16, dtype=jnp.bfloat16,
                                     cls_last=True))
    ips, spread = _timed_spread(lambda: fn(ctx["params"], ctx["x"]),
                                batch_size)
    a = np.asarray(fn(ctx["params"], ctx["x"]), np.float64)
    b = np.asarray(ctx["int8_feats"], np.float64)
    cos = np.sum(a * b, -1) / np.linalg.norm(a, axis=-1) / np.linalg.norm(
        b, axis=-1)
    return {"bf16": ips, "bf16_spread": spread,
            "int8_cosine_min": float(cos.min())}


def _gallery(n: int, dim: int, n_queries: int, seed: int = 0,
             ball: bool = False):
    """Gallery + queries made on the device from a seed."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def gen(key):
        kg, kq = jax.random.split(key)
        g = jax.random.normal(kg, (n, dim), jnp.float32)
        q = jax.random.normal(kq, (n_queries, dim), jnp.float32)
        if ball:
            g = g / jnp.linalg.norm(g, axis=-1, keepdims=True) * 0.6
            q = q / jnp.linalg.norm(q, axis=-1, keepdims=True) * 0.6
        return g, q

    return gen(jax.random.key(seed))


def bench_search(kind: str, n_gallery: int = 1_000_000, dim: int = 512,
                 n_queries: int = 256, k: int = 10
                 ) -> tuple[float, list[float], float]:
    """``EmbeddingIndex.search`` QPS for ``kind`` in {"cosine", "int8",
    "poincare"}, and the top-k ordering parity against the exact scan."""
    from patent_tpu.retrieval.index import EmbeddingIndex, topk_search

    g, q = _gallery(n_gallery, dim, n_queries, ball=kind == "poincare")
    names = [str(i) for i in range(n_gallery)]
    kwargs = {"cosine": {}, "int8": {"quantized": True},
              "poincare": {"quantized": True, "similarity": "poincare",
                           "c": 1.0}}[kind]
    index = EmbeddingIndex(g if kind == "cosine" else np.asarray(g), names,
                           **kwargs)
    qh = np.asarray(q)
    qps, spread = _timed_spread(lambda: index.search(qh, k=k)[1], n_queries,
                                iters=5)
    _v, idx = index.search(qh, k=k)
    _sv, si = topk_search(q, g, k=k, similarity="poincare"
                          if kind == "poincare" else "cosine")
    parity = float(np.mean(np.asarray(si) == idx))
    return qps, spread, parity


def bench_recall_parity(n_gallery: int = 100_000, dim: int = 512,
                        n_queries: int = 64, k: int = 10) -> float:
    """Exact index top-k vs a numpy brute force (recall@k)."""
    from patent_tpu.retrieval.index import EmbeddingIndex

    rng = np.random.default_rng(0)
    g = rng.standard_normal((n_gallery, dim)).astype(np.float32)
    q = rng.standard_normal((n_queries, dim)).astype(np.float32)
    index = EmbeddingIndex(g, [str(i) for i in range(n_gallery)])
    _v, idx = index.search(q, k=k)
    qn = q / np.linalg.norm(q, axis=-1, keepdims=True)
    gn = g / np.linalg.norm(g, axis=-1, keepdims=True)
    want = np.argsort(-(qn @ gn.T), axis=1)[:, :k]
    return float(np.mean([len(set(a) & set(b)) / k
                          for a, b in zip(idx, want)]))


def bench_finetune_step(pairs: int = 32) -> dict:
    """CLIP fine-tune step time at 32 pairs (64 images/step) — the shipped
    step: bf16 tower with the CLS-only last layer, multi-positive NT-Xent
    + graph alignment, 4-group optimizer, one jit."""
    import jax.numpy as jnp

    from patent_tpu.models.vit import VIT_B16
    from patent_tpu.train.finetune_clip import (init_finetune_state,
                                                make_finetune_step)
    from patent_tpu.utils.config import ClipFinetuneConfig

    rng = np.random.default_rng(0)
    images = jnp.asarray(rng.integers(0, 256, (2 * pairs, 224, 224, 3)),
                         jnp.uint8)
    node_idx = jnp.asarray(rng.integers(0, 64, pairs), jnp.int32)
    vgae = rng.standard_normal((64, 256)).astype(np.float32)
    cfg = ClipFinetuneConfig(batch_size=pairs)
    (vit, head), params, opt, opt_state = init_finetune_state(
        VIT_B16, cfg, vgae, seed=0)
    step, _ = make_finetune_step(vit, head, opt, cfg)
    sps, spread = _timed_spread(
        lambda: step(params, opt_state, images, node_idx,
                     jnp.float32(0.05))[2]["loss"], 1, iters=5)
    return {"ms": 1e3 / sps, "ms_spread": [1e3 / s for s in spread[::-1]],
            "img_per_s": 2 * pairs * sps}


def bench_hyp_train(batch_size: int = 256, feature_dim: int = 512,
                    embed_dim: int = 128, label_num: int = 16_384) -> float:
    """train_hyp steps/s at reference scale, CHUNK steps per dispatch."""
    import jax
    import jax.numpy as jnp

    from patent_tpu.models.hyperbolic import HyperbolicEmbeddingModel
    from patent_tpu.train.optim import manifold_mask, riemannian_adam
    from patent_tpu.train.train_hyp import make_train_step
    from patent_tpu.utils.config import HypTrainConfig

    rng = np.random.default_rng(0)
    cfg = HypTrainConfig(embed_dim=embed_dim, hidden_dims=(256,),
                         curvature=2.0, batch_size=batch_size,
                         num_neg_samples=1)
    model = HyperbolicEmbeddingModel(
        feature_dim=feature_dim, embed_dim=embed_dim, label_num=label_num,
        hidden_dims=(256,), c=2.0)
    params = model.init(jax.random.key(0),
                        jnp.zeros((1, feature_dim)))["params"]
    optimizer = riemannian_adam(cfg.learning_rate, c=2.0,
                                mask=manifold_mask(params))
    opt_state = optimizer.init(params)
    step, _ = make_train_step(model, optimizer, cfg)
    n_figures = 30_000
    x_figures = jnp.asarray(rng.standard_normal(
        (n_figures, feature_dim)).astype(np.float32))
    implication = jnp.asarray(rng.integers(0, label_num, (15_000, 2)),
                              jnp.int32)
    exclusion = jnp.zeros((0, 2), jnp.int32)
    batch = (jnp.asarray(rng.integers(0, n_figures, batch_size), jnp.int32),
             jnp.asarray(rng.integers(0, label_num, batch_size), jnp.int32),
             jnp.asarray(rng.integers(0, label_num, (batch_size, 1)),
                         jnp.int32),
             jnp.asarray(rng.integers(0, n_figures, batch_size), jnp.int32),
             jnp.asarray(rng.random(batch_size) < 0.5, jnp.float32),
             jnp.ones(batch_size, jnp.float32))
    key = jax.random.key(0)
    chunk = 200

    @jax.jit
    def steps_chunk(params, opt_state):
        def body(carry, i):
            p, o = carry
            p, o, metrics = step(p, o, batch, jax.random.fold_in(key, i),
                                 x_figures, implication, exclusion)
            return (p, o), metrics["total_loss"]

        (params, opt_state), losses = jax.lax.scan(
            body, (params, opt_state), jnp.arange(chunk))
        return params, opt_state, losses[-1]

    state = {"p": params, "o": opt_state}

    def one():
        state["p"], state["o"], loss = steps_chunk(state["p"], state["o"])
        return loss

    return _timed_spread(one, chunk, iters=3)[0]


def main() -> int:
    t_start = time.monotonic()
    deadline = t_start + float(os.environ.get("PATENT_BENCH_DEADLINE_S",
                                              "900"))
    result = {
        "metric": "vit_b16_embed_throughput",
        "value": 0.0,
        "unit": "images/sec/device",
        # the headline serves the int8 PTQ tower (production config);
        # bf16 numbers live in extras under explicit keys
        "precision": "int8",
        "extras": {"status": "started", "skipped": []},
    }

    def emit():
        result["extras"]["elapsed_s"] = round(time.monotonic() - t_start, 1)
        print(json.dumps(result), flush=True)

    info = _device_info()
    result["device"] = info
    if info["platform"] == "cpu":
        result["extras"]["error"] = "no accelerator: nothing measured"
        emit()
        return 1
    result["extras"]["card"] = _card()
    from patent_tpu.utils.compile_cache import enable_compilation_cache

    enable_compilation_cache()
    emit()

    sections_run: list[str] = []

    def section(name: str, est_cost_s: float, fn) -> None:
        """Run a section if it fits the remaining budget; record errors."""
        if time.monotonic() + est_cost_s > deadline:
            result["extras"]["skipped"].append(name)
        else:
            t0 = time.monotonic()
            try:
                fn()
                sections_run.append(f"{name}:{time.monotonic() - t0:.0f}s")
            except ImportError as e:
                result["extras"]["skipped"].append(f"{name}: {e}")
            except Exception as e:  # record, keep the line parseable
                result["extras"][f"{name}_error"] = f"{type(e).__name__}: {e}"
        emit()

    ctx: dict = {}

    def run_embed_int8():
        embed = bench_embed_int8()
        ctx.update(embed.pop("_ctx"))
        result["value"] = round(embed["int8"], 1)
        result["extras"].update({
            "status": "headline done",
            "int8_embed_spread": [round(v, 1) for v in embed["int8_spread"]],
        })

    def run_embed_bf16():
        embed = bench_embed_bf16(ctx)
        result["extras"].update({
            "embed_bf16_ips": round(embed["bf16"], 1),
            "embed_bf16_spread": [round(v, 1) for v in embed["bf16_spread"]],
            "int8_feature_cosine_min_drawings":
                round(embed["int8_cosine_min"], 5),
        })

    def run_search(kind: str):
        def run():
            qps, spread, parity = bench_search(kind)
            result["extras"][f"topk_qps_1M_{kind}"] = round(qps, 1)
            result["extras"][f"topk_qps_1M_{kind}_spread"] = \
                [round(v, 1) for v in spread]
            result["extras"][f"topk_1M_{kind}_parity_vs_scan"] = parity
        return run

    def run_parity():
        result["extras"]["recall10_parity_vs_bruteforce"] = \
            bench_recall_parity()

    def run_finetune():
        ft = bench_finetune_step()
        result["extras"]["finetune_step_ms_b32pairs"] = round(ft["ms"], 2)
        result["extras"]["finetune_step_ms_spread"] = \
            [round(v, 2) for v in ft["ms_spread"]]
        result["extras"]["finetune_img_per_s"] = round(ft["img_per_s"], 1)

    def run_hyp():
        result["extras"]["hyp_train_steps_per_sec"] = round(
            bench_hyp_train(), 2)

    section("embed_int8", 120, run_embed_int8)
    section("embed_bf16", 60, run_embed_bf16)
    section("recall_parity", 30, run_parity)
    section("finetune_step", 120, run_finetune)
    section("hyp_train", 60, run_hyp)
    section("topk_1M", 60, run_search("cosine"))
    section("topk_1M_int8", 60, run_search("int8"))
    section("poincare_1M", 60, run_search("poincare"))

    errored = [k[:-6] for k in result["extras"] if k.endswith("_error")]
    result["extras"]["status"] = ("complete" if not errored
                                  else f"complete_with_errors:{errored}")
    result["extras"]["section_times"] = sections_run
    emit()
    return 0


if __name__ == "__main__":
    sys.exit(main())
