"""Per-stage configuration dataclasses with CLI overrides.

The reference buries its hyperparameters as constants inside each CLI branch
(e.g. src/train.py:4070-4090, 4008-4019, 3876-3878); here every pipeline
stage has one dataclass whose fields are overridable from the command line
(``cli/main.py``), and whose defaults ARE the reference's published values so
``python train.py train_hyp`` reproduces the reference run shape.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Sequence

# Named serving profiles (``--profile``): the speed/fidelity dial as named,
# quality-pinned configs.  Speed on the H100 is not measured yet; the
# quality numbers are the views-corpus ranking deltas pinned in
# tests/golden_pipeline_metrics.json (re-pinned on every golden run):
#
#   exact        int8 PTQ, all 197 tokens — ranking deltas ≈ int8_delta.
#   recommended  int8 + ink-mass keep=175 — pruned_kt57_delta.
#   turbo        int8 + keep=127 — an explicitly approximate mode,
#                pruned_kt41_delta.
#
# Feature-cosine alone overstates pruning fidelity — quote the ranking
# deltas alongside.
SERVING_PROFILES: dict[str, dict] = {
    "exact": {"quantize": True, "keep_tokens": None},
    "recommended": {"quantize": True, "keep_tokens": 175},
    "turbo": {"quantize": True, "keep_tokens": 127},
}


@dataclasses.dataclass
class HypTrainConfig:
    """train_hyp — hyperbolic retrieval training (reference train.py:4008-4055)."""

    feature_dim: int = 512
    embed_dim: int = 128           # latent_dim flag default (train.py:3812)
    hidden_dims: tuple[int, ...] = (256,)
    curvature: float = 2.0         # c=2 (train.py:4026)
    label_num: int | None = None   # derived from data unless forced
    epochs: int = 150
    batch_size: int = 128
    learning_rate: float = 6e-3
    num_neg_samples: int = 1
    margin: float = 0.1
    temperature: float = 0.07
    figure_pair_weight: float = 2.0
    constraint_penalty: float = 3.0
    retrieval_penalty: float = 2.0   # used MULTIPLICATIVELY here (the
    # reference adds it as a constant by mistake, train.py:1461-1466)
    reg_penalty: float = 0.01
    patience: int = 10
    train_ratio: float = 0.8
    val_ratio: float = 0.1
    seed: int = 42
    data_dir: str = "prepared_training_data"
    model_dir: str = "models"
    use_dropout: bool = True
    # validation metric for best-checkpoint selection / early stopping:
    # "loss" (this engine's default) or "map" — mean AP of ranking patent
    # labels, like the reference legacy trainer (train.py:2264)
    validate_with: str = "loss"


@dataclasses.dataclass
class HypConTrainConfig:
    """train_hyp_con — hyperbolic InfoNCE training (train.py:1792-1910)."""

    feature_dim: int = 512
    embed_dim: int = 128
    hidden_dims: tuple[int, ...] = (256,)
    curvature: float = 1.0
    epochs: int = 100
    batch_size: int = 128
    learning_rate: float = 1e-3
    temperature: float = 0.07
    patience: int = 7
    seed: int = 42
    data_dir: str = "prepared_training_data"
    model_dir: str = "models"


@dataclasses.dataclass
class GCNTrainConfig:
    """train_class_pro — GCN pair classification (train.py:124-377, 3827-3868)."""

    input_dim: int = 512
    hidden_dim: int = 512
    latent_dim: int = 256
    num_layers: int = 3
    epochs: int = 100
    batch_size: int = 512          # pairs per step
    learning_rate: float = 2e-3
    weight_decay: float = 1e-4
    patience: int = 10
    train_ratio: float = 0.8
    val_ratio: float = 0.1
    seed: int = 42
    graph_dir: str = "data/graph"
    model_dir: str = "models"
    # adjacency representation: "auto" (sparse for scipy input >16k nodes),
    # "dense", or "sparse" — see train/train_gcn.py::prepare_adjacency
    adjacency: str = "auto"


@dataclasses.dataclass
class ClipFinetuneConfig:
    """CLIP fine-tune with graph alignment (retrieval.ipynb cell 20)."""

    epochs: int = 8
    batch_size: int = 64           # anchors per batch (2B images on device)
    image_size: int = 224
    alpha_max: float = 0.1         # alignment weight, warm-up over 5 epochs
    warmup_epochs: int = 5
    init_tau: float = 0.10
    lr_clip: float = 2e-5
    lr_proj: float = 2e-4
    lr_embed: float = 1e-4
    lr_logit_scale: float = 5e-4
    weight_decay: float = 1e-2
    trainable_blocks: int = 9      # last 9 vision layers (cell 20)
    graph_proj_dim: int = 128
    val_every: int = 60            # batches (cell 20)
    num_workers: int = 8           # decode threads (ref DataLoader 16-32,
    # train.py:4292-4308; this host pipeline prefetches one batch ahead)
    seed: int = 42
    model_dir: str = "models/patent-wise"
    # opt-in ink-mass token selection DURING fine-tuning (models/vit.py
    # keep_tokens): differentiable (gather passes gradients; the top-k
    # indices are data-dependent constants, like maxpool), same params as
    # the full tower, fewer tokens per step.  The served tower's
    # keep_tokens need not match — tools/pruning_quality_b16 shows
    # full↔pruned feature agreement — but training and serving pruned the
    # same way is the consistent production setup.
    keep_tokens: int | None = None
    # CLS-only last layer (models/vit.transformer_layer cls_only): only
    # the CLS row of the last block feeds the projection, so the other S−1
    # rows' out-proj/MLP forward AND backward are dead work — dropping
    # them is gradient-EXACT (their cotangents are identically zero)
    cls_last: bool = True


@dataclasses.dataclass
class EndToEndConfig:
    """train_end_2 — joint CLIP + hyperbolic training (train.py:2415-3106)."""

    clip_weight: float = 0.5       # w·CLIP + (1−w)·hyperbolic (train.py:2760)
    epochs: int = 10
    batch_size: int = 32
    image_size: int = 224
    embed_dim: int = 256           # HYPERBOLIC_EMBED_DIM (train.py:4075)
    curvature: float = 2.0
    lr_clip: float = 1e-5
    lr_euclidean: float = 1e-3
    lr_label_emb: float = 5e-3
    trainable_blocks: int = 9
    val_every: int = 30            # mid-epoch validation (train.py:2805)
    seed: int = 42
    model_dir: str = "models"


@dataclasses.dataclass
class EvalConfig:
    """Retrieval evaluation (retrieval.ipynb cell 3)."""

    batch_size: int = 128
    image_size: int = 224
    k_values: tuple[int, ...] = (5, 10, 20)
    positives_key: str = "patent_positives"
    results_dir: str = "results"


def apply_overrides(cfg, overrides: Sequence[str]):
    """Apply ``key=value`` CLI overrides to a config dataclass in place."""
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override must be key=value, got {ov!r}")
        key, val = ov.split("=", 1)
        if not hasattr(cfg, key):
            raise ValueError(
                f"unknown config field {key!r} for {type(cfg).__name__}; "
                f"valid: {[f.name for f in dataclasses.fields(cfg)]}")
        current = getattr(cfg, key)
        # none/null clears Optional fields regardless of their CURRENT
        # value (keep_tokens=175 then keep_tokens=none must round-trip;
        # the int branch below would crash on int("none"))
        ann = next((str(f.type) for f in dataclasses.fields(cfg)
                    if f.name == key), "")
        if val.strip().lower() in ("none", "null") and "None" in ann:
            setattr(cfg, key, None)
            continue
        if isinstance(current, bool):
            setattr(cfg, key, val.lower() in ("1", "true", "yes"))
        elif isinstance(current, int):
            setattr(cfg, key, int(val))
        elif isinstance(current, float):
            setattr(cfg, key, float(val))
        elif isinstance(current, tuple):
            setattr(cfg, key, tuple(json.loads(val)))
        elif current is None:
            # None-default fields (e.g. keep_tokens: int | None) carry no
            # runtime type to coerce to — parse the literal: none/null →
            # None, then int, then float, else the raw string (storing
            # the raw string for keep_tokens=175 used to crash the CLI's
            # later `>= num_patches` comparison with a TypeError)
            v = val.strip()
            if v.lower() in ("none", "null"):
                setattr(cfg, key, None)
            else:
                for cast in (int, float):
                    try:
                        setattr(cfg, key, cast(v))
                        break
                    except ValueError:
                        continue
                else:
                    setattr(cfg, key, v)
        else:
            setattr(cfg, key, val)
    return cfg
