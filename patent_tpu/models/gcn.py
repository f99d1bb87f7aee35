"""Graph convolutional models (VGAE family) in Flax.

Re-design of the reference's GCN stack (src/models.py:187-245 GCNLayer /
InferenceModel, 840-879 EnhancedVGAE, 881-903 VGAE).  The whole ~44k-node,
512-d graph forward is a chain of dense matmuls, so the encoder is
expressed as plain jitted matmul chains; the normalized adjacency is precomputed once on the host (see ``normalize_adjacency``)
instead of being re-normalized inside every forward like the reference
(models.py:233 renormalizes per call — kept, it is cheap and fused).
"""

from __future__ import annotations

import flax.linen as nn
import jax
import jax.numpy as jnp

from .adjacency import (SparseAdj, adj_rowsum, normalize_adjacency,  # noqa: F401
                        normalize_adjacency_host, normalize_adjacency_sparse,
                        spmm)


class GCNLayer(nn.Module):
    """A_tilde @ (X @ W) with xavier init (reference src/models.py:187-197).

    Dense path: a bf16 ``a_tilde`` runs the [N, N] matmul in bf16 with f32
    accumulation (the dominant FLOPs at graph scale) — X·W stays
    f32 and is cast down only for the A contraction.  A ``SparseAdj``
    contracts via gather + sorted segment-sum instead (O(E·D))."""

    features: int

    @nn.compact
    def __call__(self, x: jax.Array, a_tilde) -> jax.Array:
        kernel = self.param("kernel", nn.initializers.xavier_uniform(),
                            (x.shape[-1], self.features))
        xw = jnp.dot(x, kernel)             # [N, out]
        if isinstance(a_tilde, SparseAdj):
            return spmm(a_tilde, xw)
        return jnp.dot(a_tilde, xw.astype(a_tilde.dtype),
                       preferred_element_type=jnp.float32)


class ResidualGCNEncoder(nn.Module):
    """Deep residual GCN encoder (reference InferenceModel, src/models.py:200-245):
    input GCN+BN+ReLU, residual hidden GCN+BN+ReLU blocks, linear GCN output.
    Row-normalizes A on the fly like the reference (models.py:233)."""

    hidden_dim: int
    latent_dim: int
    num_layers: int = 3

    @nn.compact
    def __call__(self, x: jax.Array, a_tilde,
                 *, deterministic: bool = True) -> jax.Array:
        # the reference row-normalizes A on the fly (models.py:233).  Use
        # (A @ Y) / rowsum instead of (A / rowsum) @ Y — same math, but no
        # second N×N tensor is ever materialized (at 44k nodes that
        # intermediate alone is 3.9-7.7 GB); adj_rowsum dispatches dense /
        # SparseAdj
        inv_row = 1.0 / (adj_rowsum(a_tilde)[:, None] + 1e-8)

        def gcn(feats, layer):
            return layer(feats, a_tilde) * inv_row

        h = gcn(x, GCNLayer(self.hidden_dim, name="gcn_in"))
        h = nn.BatchNorm(use_running_average=deterministic, name="bn_in")(h)
        h = nn.relu(h)
        for i in range(self.num_layers - 3):
            hn = gcn(h, GCNLayer(self.hidden_dim, name=f"gcn_h{i}"))
            hn = nn.BatchNorm(use_running_average=deterministic, name=f"bn_h{i}")(hn)
            h = h + nn.relu(hn)
        return gcn(h, GCNLayer(self.latent_dim, name="gcn_out"))


class VGAE(nn.Module):
    """GCN encoder + L2-normalize + sigmoid(Z Zᵀ) adjacency reconstruction
    (reference src/models.py:881-903)."""

    hidden_dim: int
    latent_dim: int
    num_layers: int = 3

    def setup(self):
        self.encoder = ResidualGCNEncoder(self.hidden_dim, self.latent_dim,
                                          self.num_layers, name="encoder")

    def __call__(self, x: jax.Array, a_tilde,
                 *, deterministic: bool = True) -> tuple[jax.Array, jax.Array]:
        z = self.encode(x, a_tilde, deterministic=deterministic)
        a_rec = jax.nn.sigmoid(jnp.dot(z, z.T))
        return z, a_rec

    def encode(self, x: jax.Array, a_tilde,
               *, deterministic: bool = True) -> jax.Array:
        """Latents only — no [N, N] reconstruction tensor.  The sampled-edge
        trainer (train_vgae mode='sampled') scores individual pairs from z,
        which is what makes VGAE training possible at the 2019 graph scale
        (sigmoid(Z Zᵀ) at 108k nodes is a 47 GB tensor)."""
        z = self.encoder(x, a_tilde, deterministic=deterministic)
        return z / jnp.maximum(jnp.linalg.norm(z, axis=1, keepdims=True), 1e-12)


class EnhancedVGAE(nn.Module):
    """Residual GCN encoder + MLP pair classifier over concatenated embeddings
    → 5 CPC-connection levels (reference src/models.py:840-879)."""

    hidden_dim: int
    latent_dim: int
    num_layers: int = 3
    num_classes: int = 5
    dropout_rate: float = 0.3

    def setup(self):
        self.encoder = ResidualGCNEncoder(self.hidden_dim, self.latent_dim,
                                          self.num_layers)
        self.linear = nn.Dense(self.latent_dim)
        self.linear2 = nn.Dense(self.latent_dim // 2)
        self.classifier = nn.Dense(self.num_classes)
        self.dropout = nn.Dropout(self.dropout_rate)

    def __call__(self, x: jax.Array, a_tilde: jax.Array,
                 *, deterministic: bool = True) -> jax.Array:
        z = self.encoder(x, a_tilde, deterministic=deterministic)
        return z / jnp.maximum(jnp.linalg.norm(z, axis=1, keepdims=True), 1e-12)

    def classify_pair(self, z1: jax.Array, z2: jax.Array,
                      *, deterministic: bool = True) -> jax.Array:
        pair = jnp.concatenate([z1, z2], axis=1)
        h = nn.relu(self.linear(pair))
        h = self.dropout(h, deterministic=deterministic)
        h = nn.relu(self.linear2(h))
        h = self.dropout(h, deterministic=deterministic)
        return self.classifier(h)

    def encode_and_classify(self, x, a_tilde, pair_idx,
                            *, deterministic: bool = True) -> jax.Array:
        """Full-graph encode + classify the given [P, 2] node-index pairs.

        The reference re-runs the full-graph GCN forward inside every batch
        (src/train.py:240); under jit the encode is shared per step here.
        """
        z = self(x, a_tilde, deterministic=deterministic)
        return self.classify_pair(z[pair_idx[:, 0]], z[pair_idx[:, 1]],
                                  deterministic=deterministic)
