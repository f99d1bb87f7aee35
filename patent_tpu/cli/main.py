"""Command-line interface — the reference's public entry point, preserved.

``python train.py <action> [--model --path --input_dim --hidden_dim
--latent_dim --learning_rate --epochs]`` with the reference's action set
(src/train.py:3799-3821):

    train, train_gcn, train_hyp, train_hyp_con, train_end, train_end_2,
    train_class, plot, train_class_pro, test, infer, dist

plus framework additions: ``prep`` (ETL), ``encode`` / ``retrieve`` /
``eval`` (the retrieval.ipynb cells 2-3 surface), ``bench``.  Three of the
reference's declared actions (train, train_gcn, train_class) have NO handler
there (dead options, SURVEY §2.3); here they are aliases of their working
equivalents instead of silent no-ops.

Extra ``key=value`` overrides map onto the per-stage config dataclasses
(utils/config.py) — the reference hardcodes these inside each branch.

When ``--path`` has no prepared data, a deterministic synthetic corpus
(data/synthetic.py) is generated so every action runs end-to-end out of the
box.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

import numpy as np

ACTIONS = ["train", "train_gcn", "train_hyp", "train_hyp_con", "train_end",
           "train_end_2", "train_class", "plot", "train_class_pro", "test",
           "infer", "dist", "prep", "encode", "retrieve", "eval", "bench",
           "finetune", "serve"]

# actions whose models (models/hyperbolic.py, models/gcn.py) are Flax linen
# modules; the encoder, serving and fine-tune actions need no Flax
FLAX_ACTIONS = {"train", "train_gcn", "train_hyp", "train_hyp_con",
                "train_end", "train_end_2", "train_class", "train_class_pro",
                "test", "infer", "dist"}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="train.py",
        description="patent_tpu — patent image retrieval")
    p.add_argument("action", choices=ACTIONS)
    # reference flags (train.py:3803-3819)
    p.add_argument("--model", type=str, default="GE")
    p.add_argument("--path", type=str, default="data")
    p.add_argument("--input_dim", type=int, default=512)
    p.add_argument("--hidden_dim", type=int, default=512)
    p.add_argument("--latent_dim", type=int, default=128)
    p.add_argument("--learning_rate", type=float, default=None)
    p.add_argument("--epochs", type=int, default=None)
    # framework additions
    p.add_argument("--query", type=str, default=None,
                   help="query image path (retrieve action)")
    p.add_argument("--k", type=int, default=20)
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--resume", action="store_true",
                   help="continue train_hyp from the 'latest' checkpoint "
                        "under --path/models (TRUE resume: params + "
                        "optimizer state + epoch + RNG streams — epoch "
                        "k+1 after resume equals epoch k+1 of an "
                        "uninterrupted run)")
    p.add_argument("--synthetic", action="store_true",
                   help="force the synthetic corpus")
    p.add_argument("--quantize", action="store_true",
                   help="serve the int8 PTQ encoder (int8 products, min "
                        "feature cosine >= 0.99 vs the float tower)")
    p.add_argument("--keep-tokens", type=int, default=None,
                   dest="keep_tokens",
                   help="opt-in ink-mass token selection: serve only the K "
                        "darkest patches per image (+CLS). Quality deltas "
                        "pinned in "
                        "tests/test_finetune_lift.py and the golden "
                        "pipeline; B/16-scale table in "
                        "tools/pruning_quality_b16.py")
    p.add_argument("--profile", choices=["exact", "recommended", "turbo"],
                   default=None,
                   help="named serving profile (utils/config."
                        "SERVING_PROFILES): exact = int8 full tokens; "
                        "recommended = int8 + keep-tokens 175; turbo = "
                        "int8 + keep-tokens 127 (ranking deltas pinned in "
                        "tests/golden_pipeline_metrics.json). Shorthand "
                        "for --quantize/--keep-tokens; explicit flags win")
    p.add_argument("--port", type=int, default=8777,
                   help="retrieval server port (serve action)")
    p.add_argument("--positives", choices=["patent", "cpc"],
                   default="patent",
                   help="ground-truth positive set for the eval action: "
                        "'patent' scores same-patent gallery figures "
                        "(retrieval.ipynb cell 3); 'cpc' scores same-"
                        "medium-CPC figures — the reference's second "
                        "evaluation block (cell 4 'CPC' rows, ground truth "
                        "from split_query.ipynb cell 10)")
    p.add_argument("overrides", nargs="*",
                   help="config overrides as key=value")
    return p


def _ensure_training_data(path: str, synthetic: bool):
    """Load prepared training data, or build it from the synthetic corpus."""
    from ..data import (build_feature_matrix, build_hetero_graph,
                        prepare_training_data, synthetic as synth)
    from ..data.prep import TrainingData

    prep_dir = os.path.join(path, "prepared_training_data")
    if not synthetic and os.path.exists(os.path.join(prep_dir,
                                                     "training_data.npz")):
        return TrainingData.load(prep_dir)
    print(f"[patent_tpu] no prepared data under {prep_dir}; "
          "building synthetic corpus")
    records = synth.synthetic_records(num_patents=40, figures_per_patent=4,
                                      seed=0)
    graph = build_hetero_graph(records)
    feats = synth.synthetic_features(records, dim=64, seed=0)
    x = build_feature_matrix(graph, feats, feature_dim=64)
    td = prepare_training_data(graph, x, neg_ratio=5, fig_pair_ratio=3, seed=0)
    td.save(prep_dir)
    return td


def _ensure_graph(path: str, synthetic: bool):
    from ..data import (build_feature_matrix, build_hetero_graph,
                        sample_figure_pairs, synthetic as synth)

    records = synth.synthetic_records(num_patents=40, figures_per_patent=4,
                                      seed=0)
    graph = build_hetero_graph(records)
    feats = synth.synthetic_features(records, dim=64, seed=0)
    x = build_feature_matrix(graph, feats, feature_dim=64)
    pair_data = sample_figure_pairs(records, num_samples=20000,
                                    cap_per_level=2000, seed=0)
    return graph, x, pair_data


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.action in FLAX_ACTIONS and importlib.util.find_spec("flax") is None:
        print(f"action {args.action!r} needs Flax (its hyperbolic/graph "
              f"models are Flax linen modules), which is not installed; the "
              f"encode, retrieve, eval, serve and finetune actions do not",
              file=sys.stderr)
        return 2
    if args.profile is not None:
        # named serving profile → quantize/keep_tokens defaults; explicit
        # flags win (a user combining --profile with --keep-tokens is
        # dialing deliberately)
        from ..utils.config import SERVING_PROFILES

        prof = SERVING_PROFILES[args.profile]
        if not args.quantize:
            args.quantize = prof["quantize"]
        if args.keep_tokens is None:
            args.keep_tokens = prof["keep_tokens"]
    from ..utils.compile_cache import enable_compilation_cache

    enable_compilation_cache()

    from ..utils.config import (GCNTrainConfig, HypConTrainConfig,
                                HypTrainConfig, apply_overrides)
    from ..utils.logging import MetricsLogger
    from ..utils.checkpoint import CheckpointManager

    action = args.action
    logger = MetricsLogger(log_dir=os.path.join(args.path, "logs"),
                           run_name=action)

    if action in ("train_hyp", "test", "infer", "dist"):
        cfg = HypTrainConfig()
        if args.learning_rate:
            cfg.learning_rate = args.learning_rate
        if args.epochs:
            cfg.epochs = args.epochs
        cfg.embed_dim = args.latent_dim
        apply_overrides(cfg, args.overrides)
        td = _ensure_training_data(args.path, args.synthetic)

        from ..train.train_hyp import train_hyperbolic_retrieval
        from ..train.evaluate import distance_analysis, evaluate_retrieval_map
        from ..models.hyperbolic import HyperbolicEmbeddingModel

        if action == "train_hyp":
            ckpt = CheckpointManager(os.path.join(args.path, "models"))
            best_params, history = train_hyperbolic_retrieval(
                td, cfg, logger=logger, ckpt=ckpt, resume=args.resume)
            # final test-split mAP (reference train.py:1642-1757)
            fig_pos = {}
            for f, p in td.y_pos.tolist():
                fig_pos.setdefault(f, []).append(p)
            model = HyperbolicEmbeddingModel(
                feature_dim=td.x_figures.shape[1], embed_dim=cfg.embed_dim,
                label_num=cfg.label_num or td.num_labels,
                hidden_dims=tuple(cfg.hidden_dims), c=cfg.curvature)
            num_patents = (td.label_offsets["medium_cpcs"] -
                           td.label_offsets["patents"])
            test_map = evaluate_retrieval_map(
                model, best_params, td.x_figures, history["test_indices"],
                fig_pos, num_patents)
            print(f"test mAP (label retrieval): {test_map:.4f}")
            return 0

        # test / infer / dist need a trained checkpoint
        ckpt = CheckpointManager(os.path.join(args.path, "models"))
        name = (args.checkpoint or
                f"best_retrieval_model_c{cfg.curvature}_e{cfg.embed_dim}")
        if not ckpt.exists(name):
            print(f"no checkpoint {name!r} under {args.path}/models — "
                  "run train_hyp first", file=sys.stderr)
            return 1
        state = ckpt.restore(name)
        params = state["params"]
        model = HyperbolicEmbeddingModel(
            feature_dim=td.x_figures.shape[1], embed_dim=cfg.embed_dim,
            label_num=params["label_emb"].shape[0],
            hidden_dims=tuple(cfg.hidden_dims), c=cfg.curvature)
        fig_pos: dict[int, list[int]] = {}
        for f, p in td.y_pos.tolist():
            fig_pos.setdefault(f, []).append(p)
        num_patents = (td.label_offsets["medium_cpcs"] -
                       td.label_offsets["patents"])
        if action in ("test", "infer"):
            test_map = evaluate_retrieval_map(
                model, params, td.x_figures, sorted(fig_pos), fig_pos,
                num_patents)
            print(f"mAP (label retrieval): {test_map:.4f}")
        if action == "dist":
            from ..train.evaluate import save_distance_analysis, strip_raw_samples

            analysis = distance_analysis(model, params, td.x_figures,
                                         td.y_pos, td.label_offsets,
                                         td.implication)
            files = save_distance_analysis(analysis,
                                           os.path.join(args.path, "analysis"))
            print(json.dumps(strip_raw_samples(analysis), indent=2))
            print("\n".join(files))
        return 0

    if action == "train_hyp_con":
        cfg = HypConTrainConfig()
        if args.learning_rate:
            cfg.learning_rate = args.learning_rate
        if args.epochs:
            cfg.epochs = args.epochs
        apply_overrides(cfg, args.overrides)
        td = _ensure_training_data(args.path, args.synthetic)
        from ..train.train_hyp_con import train_hyperbolic_contrastive

        train_hyperbolic_contrastive(td, cfg, logger=logger)
        return 0

    if action in ("train_class_pro", "train_class", "train_gcn", "train"):
        # the reference declares train/train_gcn/train_class but only
        # train_class_pro has a handler (SURVEY §2.3) — alias them here
        cfg = GCNTrainConfig()
        if args.learning_rate:
            cfg.learning_rate = args.learning_rate
        if args.epochs:
            cfg.epochs = args.epochs
        cfg.hidden_dim = args.hidden_dim
        cfg.latent_dim = args.latent_dim
        apply_overrides(cfg, args.overrides)
        graph, x, pair_data = _ensure_graph(args.path, args.synthetic)
        pairs = np.asarray(pair_data["pairs"], np.int32)
        labels = np.asarray(pair_data["labels"], np.int32) - 1
        cfg.input_dim = x.shape[1]
        if args.model.upper() == "VGAE":
            # unsupervised VGAE link prediction (reference models.py:881-903
            # + auxiliary.py:36-58 as a reachable trainer; the reference CLI
            # declares `train` but never handles it, SURVEY §2.3).  `auto`
            # mode picks the sampled-edge objective above 16k nodes — the
            # only form that exists at the 2019 graph scale.
            from ..train.train_vgae import train_vgae_link_prediction

            # read epochs/lr from cfg when the USER set them (via flag or
            # key=value override — reading args alone silently discarded
            # `epochs=200`-style overrides); otherwise keep the VGAE
            # defaults, which differ from the pair-classifier's
            user_set = {ov.split("=", 1)[0] for ov in args.overrides}
            variables, _split, report = train_vgae_link_prediction(
                x, graph.adjacency, hidden_dim=cfg.hidden_dim,
                latent_dim=cfg.latent_dim,
                epochs=cfg.epochs
                if (args.epochs or "epochs" in user_set) else 50,
                learning_rate=cfg.learning_rate
                if (args.learning_rate or "learning_rate" in user_set)
                else 1e-2, logger=logger)
            print(json.dumps({k: float(v) for k, v in report.items()},
                             indent=2))
            return 0
        from ..train.train_gcn import (export_graph_embeddings,
                                       train_pair_classification)

        # pass the ETL's native scipy-sparse adjacency: prepare_adjacency
        # picks sparse (O(E·D) gather+segment-sum) above 16k nodes — the
        # only representation that fits the 2019-scale 95k-node graph
        variables, history, report = train_pair_classification(
            x, graph.adjacency, pairs, labels, cfg, logger=logger)
        print(json.dumps({k: v for k, v in report.items()
                          if k != "confusion_matrix"}, indent=2))
        # export graph embeddings for the alignment stage (L9)
        emb = export_graph_embeddings(
            variables, x, graph.adjacency, cfg.hidden_dim,
            cfg.latent_dim, cfg.num_layers, graph.figure_index,
            adjacency_mode=cfg.adjacency)
        out_dir = os.path.join(args.path, "graph_embeddings")
        os.makedirs(out_dir, exist_ok=True)
        import pickle

        with open(os.path.join(out_dir,
                               f"image_ge_embeddings_{args.model}.pkl"),
                  "wb") as f:
            pickle.dump(emb, f)
        print(f"graph embeddings -> {out_dir}")
        return 0

    if action in ("train_end", "train_end_2"):
        from ..train.train_end import run_end_to_end_synthetic

        run_end_to_end_synthetic(args.path, epochs=args.epochs or 2,
                                 logger=logger)
        return 0

    if action == "plot":
        from ..train.plots import run_plot_action

        run_plot_action(args.path, checkpoint=args.checkpoint)
        return 0

    if action == "prep":
        td = _ensure_training_data(args.path, synthetic=True)
        print(f"prepared: {len(td.y_pos)} Y_pos, {len(td.y_neg)} Y_neg, "
              f"{len(td.implication)} implications, "
              f"{td.num_labels} labels")
        return 0

    if action in ("encode", "retrieve", "eval"):
        from ..retrieval.cli_actions import run_retrieval_action

        return run_retrieval_action(action, args)

    if action == "serve":
        # production serving: encode (or load) the gallery, start the HTTP
        # retrieval server (retrieval/server.py)
        # corpus/encoder/engine/prefix via the SAME helper the
        # encode/retrieve/eval actions use (cli_actions.build_engine) —
        # the serve copy used to drift from it
        from ..retrieval.cli_actions import build_engine
        from ..retrieval.server import serve

        gallery_dir, _q, _gt, engine, prefix = build_engine(args)
        if os.path.exists(prefix + ".npy"):
            engine.load_embeddings(prefix)
        else:
            engine.encode_dataset(gallery_dir, save_prefix=prefix)
        # image_path queries are confined to the gallery directory
        serve(engine, port=args.port, data_root=gallery_dir)
        return 0

    if action == "finetune":
        # CLIP fine-tune with graph alignment (retrieval.ipynb cell 20):
        # uses graph embeddings exported by train_class_pro when present
        import pickle

        from ..data import figure_to_pos_figures, synthetic
        from ..models.vit import VisionConfig
        from ..train.finetune_clip import run_finetune
        from ..utils.config import ClipFinetuneConfig

        cfg = ClipFinetuneConfig()
        if args.epochs:
            cfg.epochs = args.epochs
        if getattr(args, "keep_tokens", None) is not None:
            # same validation contract as the serving path
            # (retrieval/cli_actions._build_encoder): reject ≤0 loudly
            # instead of crashing inside lax.top_k at model init;
            # keep ≥ num_patches normalizes to the exact tower below once
            # the vision config is known
            if args.keep_tokens <= 0:
                raise ValueError(
                    f"--keep-tokens must be positive, got {args.keep_tokens}")
            cfg.keep_tokens = args.keep_tokens
        apply_overrides(cfg, args.overrides)

        corpus_root = os.path.join(args.path, "synthetic_corpus")
        meta_path = os.path.join(args.path, "metadata.json")
        if os.path.exists(meta_path) and os.path.isdir(
                os.path.join(args.path, "images")):
            from ..data import records_from_metadata

            with open(meta_path) as f:
                records = records_from_metadata(json.load(f))
            images_dir = os.path.join(args.path, "images")
        else:
            print(f"[patent_tpu] no corpus under {args.path}; using synthetic")
            records, images_dir = synthetic.write_synthetic_corpus(
                corpus_root, num_patents=16, figures_per_patent=3,
                image_size=64)
        pos_map = figure_to_pos_figures(records)
        anchors, positives = [], []
        for name, partners in sorted(pos_map.items()):
            anchors.append(os.path.join(images_dir, name))
            positives.append(os.path.join(images_dir, partners[0]))

        ge_dir = os.path.join(args.path, "graph_embeddings")
        node_idx = np.arange(len(anchors)) % max(len(anchors), 1)
        vgae = None
        if os.path.isdir(ge_dir):
            pkls = sorted(os.listdir(ge_dir))
            if pkls:
                with open(os.path.join(ge_dir, pkls[0]), "rb") as f:
                    ge = pickle.load(f)
                keys = {os.path.basename(a): i
                        for i, a in enumerate(sorted(ge))}
                matched = sum(os.path.basename(a) in keys for a in anchors)
                if matched == 0:
                    # a stale pickle from a DIFFERENT corpus would map
                    # every anchor to node 0 — the alignment loss then
                    # pulls all images toward one graph node while the
                    # log claims success.  Refuse the degenerate mapping.
                    print(f"[patent_tpu] WARNING: graph-embedding pickle "
                          f"{pkls[0]} matches 0/{len(anchors)} anchors "
                          f"(different corpus?); training WITHOUT graph "
                          f"alignment")
                else:
                    vgae = np.stack([ge[k] for k in sorted(ge)])
                    node_idx = np.asarray(
                        [keys.get(os.path.basename(a), 0) for a in anchors],
                        np.int32)
                    print(f"[patent_tpu] aligned to {len(ge)} exported "
                          f"graph embeddings from {ge_dir} "
                          f"({matched}/{len(anchors)} anchors matched)")
        if vgae is None:
            vgae = np.random.default_rng(0).standard_normal(
                (max(len(anchors), 2), 128)).astype(np.float32)

        # small-image corpora (the bundled synthetic sets) get a small
        # tower; decide by PROBING an actual image, not by a path
        # substring (a real corpus under .../synthetic_baseline/ must not
        # silently train the 64px toy config)
        from ..retrieval.cli_actions import _gallery_image_size

        probed = _gallery_image_size(images_dir)
        image_size = probed if probed and probed < 224 else cfg.image_size
        clip_params = None
        if image_size == 224:
            from ..models.vit import VIT_B16 as vc

            if args.checkpoint and os.path.isdir(args.checkpoint):
                # start from pretrained CLIP weights like the reference
                # (cell 20 fine-tunes openai/clip-vit-base-patch16) — the
                # serving path already honors --checkpoint
                # (cli_actions._build_encoder); without this the
                # "fine-tune" silently trained from random init
                from ..models.vit import load_hf_clip_params

                clip_params = load_hf_clip_params(args.checkpoint, vc)
                print(f"[patent_tpu] fine-tuning from CLIP weights at "
                      f"{args.checkpoint}")
        else:
            vc = VisionConfig(image_size=image_size, patch_size=8,
                              hidden_dim=64, num_layers=2, num_heads=4,
                              mlp_dim=128, projection_dim=64)
        if cfg.keep_tokens is not None and cfg.keep_tokens <= 0:
            raise ValueError(
                f"keep_tokens must be positive, got {cfg.keep_tokens}")
        if cfg.keep_tokens is not None and cfg.keep_tokens >= vc.num_patches:
            print(f"--keep-tokens {cfg.keep_tokens} >= {vc.num_patches} "
                  f"patches: training the exact (unpruned) tower")
            cfg.keep_tokens = None
        ckpt = CheckpointManager(os.path.join(args.path, "models"))
        # decoded-u8 cache shared with encode/eval: epoch 1 fills it, every
        # later epoch + validation pass streams at cache-read speed instead
        # of re-decoding (reference: /root/reference/src/train.py:4292-4308)
        from ..input.cache import DecodedU8Cache

        with DecodedU8Cache(os.path.join(args.path, "decoded_cache"),
                            image_size=image_size) as dcache:
            _best, history = run_finetune(anchors, positives, node_idx, vgae,
                                          vc, cfg, clip_params=clip_params,
                                          logger=logger, ckpt=ckpt,
                                          image_size=image_size,
                                          cache=dcache)
        print(f"finetune done: val_loss trajectory {history['val_loss']}")
        return 0

    if action == "bench":
        bench_py = os.path.join(os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))), "bench.py")
        if not os.path.isfile(bench_py):
            # the pip-installed console script ships only patent_tpu/*;
            # bench.py lives at the repo root
            print("bench.py not found next to the package (it ships with "
                  "the repository, not the wheel); run it from a checkout",
                  file=sys.stderr)
            return 1
        os.execvp(sys.executable, [sys.executable, bench_py])

    print(f"unhandled action {action}", file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())
