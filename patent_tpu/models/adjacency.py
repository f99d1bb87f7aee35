"""Graph adjacency normalization and the sparse (COO) adjacency type.

Plain JAX/numpy/scipy, shared by the ETL (data/graph_build.py) and the GCN
models (models/gcn.py), which re-export these names.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp


@functools.partial(jax.tree_util.register_dataclass,
                   data_fields=["rows", "cols", "vals"], meta_fields=["n"])
@dataclasses.dataclass(frozen=True)
class SparseAdj:
    """Normalized adjacency in sorted COO form for the sparse GCN path.

    The dense path materializes the [N, N] normalized adjacency — 7.7 GB
    f32 at the reference's 2018 scale (44k nodes, fits bf16) and ~36 GB at
    its 2019 scale (95,299 figures + labels, split_query.ipynb cell 10) —
    most of one device's memory for one operand.  The patent graph is extremely sparse
    (tree-like hierarchy: figure→patent→medium→big→main, ~2-4 edges/node),
    so the same contraction runs as gather + segment-sum over the E edges:
    O(E·D) memory traffic instead of O(N²) — both faster at 44k and the only
    option at 95k.

    ``rows`` are sorted ascending (scipy CSR→COO order) so ``segment_sum``
    takes the sorted fast path; ``n`` is static for jit."""

    rows: jax.Array                                   # [E] int32, sorted
    cols: jax.Array                                   # [E] int32
    vals: jax.Array                                   # [E] f32
    n: int

    @property
    def shape(self) -> tuple[int, int]:
        return (self.n, self.n)


def spmm(adj: SparseAdj, y: jax.Array) -> jax.Array:
    """A @ y for a SparseAdj: gather + sorted segment-sum."""
    return jax.ops.segment_sum(adj.vals[:, None] * y[adj.cols], adj.rows,
                               num_segments=adj.n, indices_are_sorted=True)


def adj_rowsum(a_tilde) -> jax.Array:
    """Row sums [N] for either adjacency representation (f32)."""
    if isinstance(a_tilde, SparseAdj):
        return jax.ops.segment_sum(a_tilde.vals, a_tilde.rows,
                                   num_segments=a_tilde.n,
                                   indices_are_sorted=True)
    return jnp.sum(a_tilde.astype(jnp.float32), axis=1)


def normalize_adjacency(a: jax.Array, out_dtype=None) -> jax.Array:
    """Self-loops + symmetric D^{-1/2} A D^{-1/2} + re-symmetrization.

    Matches ``normalize_adjacency_dense_gpu`` (reference src/auxiliary.py:12-34).

    ``out_dtype=jnp.bfloat16`` halves the resident N×N matrix (a 44k-node
    f32 adjacency is 7.7 GB); normalized entries are ≤ 1, well inside bf16
    range, and the GCN matmuls accumulate in f32.
    """
    a = a + jnp.eye(a.shape[0], dtype=a.dtype)
    row_sum = jnp.sum(a, axis=1)
    d_inv_sqrt = 1.0 / jnp.sqrt(1e-10 + row_sum)
    normalized = a * d_inv_sqrt[:, None] * d_inv_sqrt[None, :]
    out = (normalized + normalized.T) / 2.0
    return out.astype(out_dtype) if out_dtype is not None else out


def normalize_adjacency_host(a: "np.ndarray", out_dtype: str = "bfloat16",
                             blk: int = 4096) -> "np.ndarray":
    """Host-side (numpy, in-place where possible) version of
    ``normalize_adjacency`` for graphs too big to normalize on device: the
    eager device path materializes several N×N f32 intermediates (several
    times the bf16 RESULT at 44k nodes), and
    host→device traffic drops to the one bf16 upload."""
    import ml_dtypes
    import numpy as np

    a = np.array(a, np.float32, copy=True)
    n = a.shape[0]
    np.fill_diagonal(a, a.diagonal() + 1.0)
    d = 1.0 / np.sqrt(1e-10 + a.sum(axis=1))
    a *= d[:, None]
    a *= d[None, :]
    # blocked in-place (M + Mᵀ)/2 — the SAME re-symmetrization the device
    # path performs, so asymmetric (or float-noisy near-symmetric) inputs
    # produce identical results on both paths instead of diverging at the
    # train_gcn size threshold.  Block tiles keep the transposed access
    # cache-resident (a naive a + a.T at 44k nodes is a cache-hostile
    # full-matrix gather); ~2 passes over the matrix, seconds at 44k.
    for i0 in range(0, n, blk):
        i1 = min(i0 + blk, n)
        diag = a[i0:i1, i0:i1]
        a[i0:i1, i0:i1] = 0.5 * (diag + diag.T)
        for j0 in range(i1, n, blk):
            j1 = min(j0 + blk, n)
            avg = 0.5 * (a[i0:i1, j0:j1] + a[j0:j1, i0:i1].T)
            a[i0:i1, j0:j1] = avg
            a[j0:j1, i0:i1] = avg.T
    return a.astype(ml_dtypes.bfloat16 if out_dtype == "bfloat16"
                    else out_dtype)


def normalize_adjacency_sparse(a, out_dtype=None) -> SparseAdj:
    """Sparse (scipy) twin of ``normalize_adjacency``: self-loops +
    symmetric D^{-1/2} A D^{-1/2} + (M + Mᵀ)/2 re-symmetrization — the SAME
    math as the dense and host paths, so all three agree bit-for-bit up to
    float rounding (pinned in tests/test_gcn_sparse.py).  Accepts any
    scipy.sparse matrix; returns a sorted-COO ``SparseAdj``."""
    import numpy as np
    import scipy.sparse as sp

    a = sp.csr_matrix(a, dtype="float32", copy=True)
    n = a.shape[0]
    a = a + sp.identity(n, dtype="float32", format="csr")
    d = np.asarray(a.sum(axis=1)).ravel()
    d_inv_sqrt = 1.0 / np.sqrt(1e-10 + d)
    dmat = sp.diags(d_inv_sqrt)
    m = dmat @ a @ dmat
    m = (m + m.T) * 0.5
    coo = m.tocsr().tocoo()                 # CSR round-trip sorts by row
    vals = coo.data.astype(out_dtype if out_dtype is not None else "float32")
    return SparseAdj(rows=jnp.asarray(coo.row, jnp.int32),
                     cols=jnp.asarray(coo.col, jnp.int32),
                     vals=jnp.asarray(vals), n=n)
