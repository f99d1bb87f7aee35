#!/usr/bin/env python3
"""B/16-scale quality evidence for ink-mass token pruning (one GPU).

tests/test_finetune_lift.py pins the pruned-serving quality on a 64px
2-layer tower (CPU-deterministic).  This tool runs the SAME protocol at
production scale — ViT-B/16 @224, the 224px views corpus, fine-tune on
64 patents, cell-3 battery on 16 HELD-OUT patents — and reports the
battery for (a) the random-init tower, (b) the fine-tuned tower, (c) the
same fine-tuned checkpoint served with --keep-tokens 127 in bf16, and
(d) the int8-quantized pruned tower (the production sparsity-aware
serving config).  Prints one JSON line.

Run with ``python tools/pruning_quality_b16.py [corpus_seed]`` on a
machine with one GPU (~10 min incl. compiles).  Not yet re-run since the
towers moved to plain XLA and cuDNN attention; the caveat stands that
synthetic views corpora and from-scratch towers may rank differently from
pretrained CLIP weights on real DeepPatent.
"""
from __future__ import annotations

import json
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SIZE = 224


def main() -> None:
    corpus_seed = int(sys.argv[1]) if len(sys.argv) > 1 else 0

    import jax
    import jax.numpy as jnp

    from patent_tpu.data.ground_truth import (build_ground_truth,
                                              figure_to_pos_figures,
                                              save_ground_truth,
                                              split_query_gallery)
    from patent_tpu.data.schema import records_from_metadata
    from patent_tpu.data.synthetic import (synthetic_metadata,
                                           write_synthetic_view_images)
    from patent_tpu.models.vit import VIT_B16, VisionTransformer
    from patent_tpu.models.vit_int8 import (Int8VisionTransformer,
                                            quantize_vit_params)
    from patent_tpu.retrieval.engine import (RetrievalEngine,
                                             make_device_normalizing_encoder)
    from patent_tpu.train.finetune_clip import run_finetune
    from patent_tpu.utils.compile_cache import enable_compilation_cache
    from patent_tpu.utils.config import ClipFinetuneConfig

    enable_compilation_cache()
    root = tempfile.mkdtemp(prefix="pq_b16_")
    records = records_from_metadata(
        synthetic_metadata(num_patents=80, figures_per_patent=4,
                           seed=corpus_seed))
    pids = sorted({r.patent_id for r in records})
    held_out = set(pids[-16:])
    train_recs = [r for r in records if r.patent_id not in held_out]
    test_recs = [r for r in records if r.patent_id in held_out]

    imgs = os.path.join(root, "images")
    write_synthetic_view_images(records, imgs, image_size=SIZE,
                                seed=corpus_seed)
    q_recs, g_recs = split_query_gallery(test_recs, seed=42)
    gallery, query = os.path.join(root, "gal"), os.path.join(root, "qry")
    os.makedirs(gallery)
    os.makedirs(query)
    for recs, d in ((g_recs, gallery), (q_recs, query)):
        for r in recs:
            os.symlink(os.path.join(imgs, r.figure_id),
                       os.path.join(d, r.figure_id))
    gt_path = os.path.join(root, "gt.json")
    save_ground_truth(build_ground_truth(q_recs, g_recs, max_month=None),
                      gt_path)

    def battery(model, params):
        encode = make_device_normalizing_encoder(model.apply, params)
        engine = RetrievalEngine(encode, batch_size=32, image_size=SIZE,
                                 num_workers=4, input_dtype="u8")
        engine.encode_dataset(gallery)
        s = engine.evaluate(query, gt_path).summary_dict()
        return {k: round(v, 4) for k, v in s.items()
                if k in ("MRR", "mAP", "mNDCG", "Recall@10", "Recall@20")}

    full = VisionTransformer(VIT_B16, dtype=jnp.bfloat16)
    pruned = VisionTransformer(VIT_B16, dtype=jnp.bfloat16, keep_tokens=127)
    init_params = jax.jit(full.init)(
        jax.random.key(0), jnp.zeros((1, SIZE, SIZE, 3)))["params"]
    out = {"init_full": battery(full, {"params": init_params})}
    print(f"# init battery: {out['init_full']}", flush=True)

    pos_map = figure_to_pos_figures(train_recs)
    anchors = [os.path.join(imgs, a) for a in sorted(pos_map)]
    positives = [os.path.join(imgs, pos_map[a][-1]) for a in sorted(pos_map)]
    vgae = np.random.default_rng(0).standard_normal(
        (len(anchors), 128)).astype(np.float32)
    node_idx = np.arange(len(anchors), dtype=np.int32)
    # from-scratch regime on a small corpus: higher lr than the cell-20
    # pretrained-CLIP setting, few epochs (B/16 overfits 256 pairs fast)
    cfg = ClipFinetuneConfig(epochs=10, batch_size=32, val_every=0,
                             num_workers=4, lr_clip=2e-4)
    best, history = run_finetune(anchors, positives, node_idx, vgae,
                                 VIT_B16, cfg, image_size=SIZE)
    out["val_loss_first_to_best"] = [round(history["val_loss"][0], 3),
                                     round(min(history["val_loss"]), 3)]
    ftp = best["vit"]
    out["ft_full"] = battery(full, {"params": ftp})
    print(f"# ft battery: {out['ft_full']}", flush=True)
    out["ft_pruned127_bf16"] = battery(pruned, {"params": ftp})
    print(f"# ft pruned bf16: {out['ft_pruned127_bf16']}", flush=True)
    q8 = {"params": quantize_vit_params(ftp)}
    out["ft_pruned127_int8"] = battery(
        Int8VisionTransformer(VIT_B16, dtype=jnp.bfloat16, keep_tokens=127),
        q8)
    out["ft_full_int8"] = battery(
        Int8VisionTransformer(VIT_B16, dtype=jnp.bfloat16), q8)

    # the pruned-TRAINING arm (ClipFinetuneConfig.keep_tokens): train the
    # tower pruned, serve it pruned — the consistent production setup
    cfgp = ClipFinetuneConfig(epochs=10, batch_size=32, val_every=0,
                              num_workers=4, lr_clip=2e-4, keep_tokens=127)
    bestp, historyp = run_finetune(anchors, positives, node_idx, vgae,
                                   VIT_B16, cfgp, image_size=SIZE)
    out["pruned_train_val_loss_first_to_best"] = [
        round(historyp["val_loss"][0], 3),
        round(min(historyp["val_loss"]), 3)]
    out["ft_trained_pruned_served_pruned"] = battery(
        pruned, {"params": bestp["vit"]})
    out["ft_trained_pruned_served_pruned_int8"] = battery(
        Int8VisionTransformer(VIT_B16, dtype=jnp.bfloat16, keep_tokens=127),
        {"params": quantize_vit_params(bestp["vit"])})
    print(json.dumps(out))


if __name__ == "__main__":
    main()
