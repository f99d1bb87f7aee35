"""Model zoo: the ViT encoders (plain JAX), and the hyperbolic and GCN/VGAE
model families (Flax linen modules, imported on first use so the encoders
and the serving path need no Flax)."""

import importlib

_LAZY = {
    "DROPOUT_RATE": "hyperbolic", "HMI": "hyperbolic",
    "MANIFOLD_PARAM_NAMES": "hyperbolic",
    "FigureOnlyHyperbolicModel": "hyperbolic",
    "HyperbolicEmbeddingModel": "hyperbolic",
    "HyperbolicEncoder": "hyperbolic", "MobiusDense": "hyperbolic",
    "EnhancedVGAE": "gcn", "GCNLayer": "gcn",
    "ResidualGCNEncoder": "gcn", "VGAE": "gcn",
    "normalize_adjacency": "adjacency",
}


def __getattr__(name):
    if name in _LAZY:
        module = importlib.import_module(f".{_LAZY[name]}", __name__)
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
