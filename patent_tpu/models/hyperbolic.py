"""Hyperbolic (Poincaré-ball) Flax modules.

Re-design of the reference's hyperbolic model family
(src/models.py:255-318 MobiusLinear/mobius_linear, 355-445 HMI, 447-505
DeeperHyperbolicEncoder, 507-784 HyperbolicEmbeddingModel, 788-838
FigureOnlyHyperbolicModel): parameters live in flax pytrees, every forward is
a pure jittable function, and the label table is a plain [L, D] array whose
Riemannian structure is handled by the optimizer (train/optim.py), not by a
wrapper class.

Behavioral notes vs the reference:
* ``MobiusDense`` fixes the reference's ``dropout``-undefined crash for
  hyperbolic inputs (src/models.py:306) with the intended semantics: weight
  dropout before ``mobius_matvec`` (rate = DROPOUT_RATE 0.1, models.py:16).
* The reference silently runs float64 (models.py:248-249); we run f32 with
  clamped geometry (see ops/poincare.py) — parity is covered by tests.
* Manifold parameters are initialized exactly like the reference:
  label table = expmap0(0.1·N(0,1)) (models.py:524-526), HMI table =
  expmap0(1e-5·N(0,1)) (models.py:361-363), hyperbolic bias =
  expmap0(1e-3·N(0,1)) (models.py:261-263).
"""

from __future__ import annotations

from typing import Callable, Sequence

import flax.linen as nn
import jax
import jax.numpy as jnp

from ..ops import poincare

DROPOUT_RATE = 0.1  # reference src/models.py:16

# Parameter-name markers: leaves with these names are points on the ball and
# get Riemannian updates (see train/optim.py manifold_label_fn).
MANIFOLD_PARAM_NAMES = ("label_emb", "hyp_bias")


class MobiusDense(nn.Module):
    """Hyperbolic dense layer (reference MobiusLinear, src/models.py:255-318).

    * ``hyperbolic_input=True``: weight-dropout → mobius_matvec(W, x)
    * ``hyperbolic_input=False``: expmap0(x @ W)
    then optional hyperbolic bias via mobius_add, optional möbius nonlinearity,
    and a final projection into the ball.
    """

    features: int
    c: float = 1.0
    hyperbolic_input: bool = True
    hyperbolic_bias: bool = True
    use_bias: bool = True
    nonlin: Callable[[jax.Array], jax.Array] | None = None
    weight_dropout_rate: float = DROPOUT_RATE

    @nn.compact
    def __call__(self, x: jax.Array, *, deterministic: bool = True) -> jax.Array:
        in_features = x.shape[-1]
        # xavier-uniform, matching models.py:264-267
        kernel = self.param(
            "kernel", nn.initializers.xavier_uniform(), (in_features, self.features))
        c = self.c

        if self.hyperbolic_input:
            w = kernel
            if not deterministic and self.weight_dropout_rate > 0.0:
                rng = self.make_rng("dropout")
                keep = 1.0 - self.weight_dropout_rate
                mask = jax.random.bernoulli(rng, keep, w.shape)
                w = jnp.where(mask, w / keep, 0.0)
            # mobius_matvec expects [out, in] (torch Linear layout)
            out = poincare.mobius_matvec(w.T, x, c)
        else:
            out = jnp.dot(x, kernel, precision=jax.lax.Precision.HIGHEST)
            out = poincare.expmap0(out, c)

        if self.use_bias:
            if self.hyperbolic_bias:
                bias = self.param(
                    "hyp_bias",
                    lambda key, shape: poincare.expmap0(
                        1e-3 * jax.random.normal(key, shape), c),
                    (self.features,))
                out = poincare.mobius_add(out, bias, c)
            else:
                bias = self.param("bias", nn.initializers.zeros, (self.features,))
                out = poincare.mobius_add(out, poincare.expmap0(bias, c), c)

        if self.nonlin is not None:
            out = poincare.mobius_fn_apply(self.nonlin, out, c)
        return poincare.project(out, c)


class HyperbolicEncoder(nn.Module):
    """Euclidean features → Poincaré ball (reference DeeperHyperbolicEncoder,
    src/models.py:447-505: first layer Euclid→hyp, möbius tanh, dropout,
    final hyp→hyp layer, project; middle layers were commented out there and
    are configurable here via ``hidden_dims``)."""

    hidden_dims: Sequence[int] = (256,)
    output_dim: int = 128
    c: float = 1.0
    dropout_rate: float = 0.3

    @nn.compact
    def __call__(self, x: jax.Array, *, deterministic: bool = True) -> jax.Array:
        c = self.c
        x = nn.Dropout(self.dropout_rate, deterministic=deterministic)(x)
        x = MobiusDense(self.hidden_dims[0], c=c, hyperbolic_input=False,
                        name="first_layer")(x, deterministic=deterministic)
        x = poincare.mobius_fn_apply(jnp.tanh, x, c)
        for i, h in enumerate(self.hidden_dims[1:]):
            x = nn.Dropout(self.dropout_rate, deterministic=deterministic)(x)
            x = MobiusDense(h, c=c, hyperbolic_input=True,
                            name=f"middle_{i}")(x, deterministic=deterministic)
            x = poincare.mobius_fn_apply(jnp.tanh, x, c)
        x = nn.Dropout(self.dropout_rate, deterministic=deterministic)(x)
        x = MobiusDense(self.output_dim, c=c, hyperbolic_input=True,
                        name="final_layer")(x, deterministic=deterministic)
        return poincare.project(x, c)


class HyperbolicEmbeddingModel(nn.Module):
    """Figure encoder + learnable hyperbolic label table (reference
    HyperbolicEmbeddingModel, src/models.py:507-784).

    ``__call__`` encodes figures (input dropout then encoder — the reference
    applies dropout twice: encode_figures models.py:542 and the encoder's own
    first dropout models.py:486; we keep both for parity).  The hierarchy /
    regularization / pair losses are pure functions in ``patent_tpu.losses``
    operating on ``label_emb`` and the encodings.
    """

    feature_dim: int = 512
    embed_dim: int = 128
    label_num: int = 1024
    hidden_dims: Sequence[int] = (256,)
    c: float = 1.0
    dropout_rate: float = DROPOUT_RATE

    def setup(self):
        self.label_emb = self.param(
            "label_emb",
            lambda key, shape: poincare.expmap0(
                0.1 * jax.random.normal(key, shape), self.c),
            (self.label_num, self.embed_dim))
        self.encoder = HyperbolicEncoder(
            hidden_dims=self.hidden_dims, output_dim=self.embed_dim, c=self.c,
            dropout_rate=0.3)
        self.input_dropout = nn.Dropout(self.dropout_rate)

    def __call__(self, features: jax.Array, *, deterministic: bool = True) -> jax.Array:
        return self.encode_figures(features, deterministic=deterministic)

    def encode_figures(self, features: jax.Array, *, deterministic: bool = True) -> jax.Array:
        x = self.input_dropout(features, deterministic=deterministic)
        return self.encoder(x, deterministic=deterministic)

    def labels(self) -> jax.Array:
        return self.label_emb


class FigureOnlyHyperbolicModel(nn.Module):
    """Encoder-only variant (reference FigureOnlyHyperbolicModel,
    src/models.py:788-838)."""

    feature_dim: int = 512
    embed_dim: int = 128
    hidden_dims: Sequence[int] = (256,)
    c: float = 1.0
    dropout_rate: float = 0.3

    @nn.compact
    def __call__(self, features: jax.Array, *, deterministic: bool = True) -> jax.Array:
        x = nn.Dropout(self.dropout_rate, deterministic=deterministic)(features)
        return HyperbolicEncoder(
            hidden_dims=self.hidden_dims, output_dim=self.embed_dim, c=self.c,
            dropout_rate=self.dropout_rate, name="encoder")(
                x, deterministic=deterministic)


class HMI(nn.Module):
    """Hyperbolic Multi-label Inference model (reference src/models.py:355-445):
    single Möbius layer encoder + unit-ball label table; classification logit
    is insideness − disjointedness against every label sphere."""

    feature_dim: int = 512
    embed_dim: int = 128
    label_num: int = 1024

    def setup(self):
        self.label_emb = self.param(
            "label_emb",
            lambda key, shape: poincare.expmap0(
                1e-5 * jax.random.normal(key, shape), 1.0),
            (self.label_num, self.embed_dim))
        self.encoder = MobiusDense(self.embed_dim, c=1.0, hyperbolic_input=True,
                                   nonlin=None, name="encoder")

    def encode(self, x: jax.Array, *, deterministic: bool = True) -> jax.Array:
        x = poincare.project(x, 1.0)   # ball.projx (models.py:381)
        return self.encoder(x, deterministic=deterministic)

    def __call__(self, x: jax.Array, *, deterministic: bool = True) -> jax.Array:
        """Returns [n, label_num] logits; the loss terms live in losses/hierarchy.py."""
        from ..ops.horosphere import hmi_logit
        encoded = self.encode(x, deterministic=deterministic)
        return hmi_logit(encoded, self.label_emb)
