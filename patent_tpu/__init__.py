"""patent_tpu — a patent-image retrieval framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of
``Alvarodelamaza/patent-image-retrieval`` (CLIP image encoder fine-tuned with
graph alignment + hyperbolic (Poincaré-ball) projection + exact retrieval
with a full metric battery), run on NVIDIA GPUs:

* ``ops``       — Poincaré-ball geometry core, attention, int8 matmuls.
* ``models``    — ViT image/text encoders (plain JAX); GCN/VGAE graph
                  encoders, Möbius layers and hyperbolic embedding models
                  (Flax linen).
* ``losses``    — vectorized contrastive / prototype / hierarchy losses.
* ``train``     — jitted per-method training engines + Riemannian optax.
* ``retrieval`` — sharded exact top-k embedding index over a device mesh.
* ``metrics``   — MRR/mAP/NDCG/R@k/P@k exactly matching the reference eval.
* ``data``      — deterministic host-side ETL (graph build, pair gen, splits).
* ``input``     — image decode/resize/normalize input pipeline.
* ``parallel``  — mesh construction and sharding helpers.
* ``utils``     — configs, checkpointing, logging.
"""

__version__ = "0.1.0"
