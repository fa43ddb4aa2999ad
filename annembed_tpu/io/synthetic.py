"""Deterministic synthetic datasets for benchmarks (zero-egress stand-ins).

Three generators:

* :func:`synthetic_blobs` — the historical bench shape: isotropic
  per-cluster Gaussians in a ``latent_dim``-dim latent, linearly lifted.
  Intrinsic dimension = ``latent_dim`` (20 by default), which a 2-d
  embedding CANNOT conserve well — the measured ~82% no-match at 70k is
  a property of the data, not the optimizer (PERF.md round-4 scale
  study, digits real-data defense).

* :func:`synthetic_clustered_manifold` — a structured LOW-intrinsic-dim
  manifold: each cluster is a smooth 2-d surface
  (random Fourier lift of a 2-d latent) offset in ambient space, plus
  tiny ambient noise.  Intrinsic dim ~= 2, so a 2-d embedding can
  conserve neighborhoods the way the reference's real MNIST/fashion
  rows do (embedder.rs:588-599) — the like-for-like conservation
  fixture at bench scale.

* :func:`synthetic_higgs` — the Higgs-shaped 28-d float32 cloud of the
  hierarchical examples: 32 clusters on an 8-d latent.

The first two return uint8-quantized (n, d) arrays scaled like MNIST
pixels (1 byte/value to upload, kernel scales in a realistic regime).
"""

from __future__ import annotations

import numpy as np


def _quantize_u8(x: np.ndarray) -> np.ndarray:
    x = (x - x.min()) / (x.max() - x.min()) * 255.0
    return np.round(x).astype(np.uint8)


def synthetic_blobs(n: int, d: int = 784, seed: int = 42,
                    n_clusters: int = 10,
                    latent_dim: int = 20) -> np.ndarray:
    """Isotropic Gaussian clusters, linear lift (the bench's historical
    ``synthetic_mnist``)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, latent_dim)) * 6.0
    labels = rng.integers(0, n_clusters, n)
    z = centers[labels] + rng.normal(size=(n, latent_dim))
    lift = rng.normal(size=(latent_dim, d)) / np.sqrt(latent_dim)
    x = z @ lift + 0.05 * rng.normal(size=(n, d))
    return _quantize_u8(x)


def synthetic_clustered_manifold(n: int, d: int = 784, seed: int = 7,
                                 n_clusters: int = 10,
                                 latent_dim: int = 2,
                                 labels_out: bool = False):
    """Clustered smooth low-dim manifold lifted to ``d`` ambient dims.

    Per cluster c: points z ~ N(0, I_latent) map to
    ``cos(z @ W_c + b_c) * a + offset_c`` — random Fourier features of
    the latent, a standard construction for a smooth compact manifold of
    intrinsic dimension ``latent_dim`` embedded in R^d.  Cluster offsets
    separate the surfaces; 1% ambient noise keeps distances generic.
    """
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_clusters, n)
    z = rng.normal(size=(n, latent_dim)).astype(np.float64)
    w = rng.normal(size=(n_clusters, latent_dim, d)) * 0.9
    b = rng.uniform(0.0, 2.0 * np.pi, size=(n_clusters, d))
    offs = rng.normal(size=(n_clusters, d)) * 0.8
    x = np.empty((n, d), np.float64)
    for c in range(n_clusters):
        m = labels == c
        x[m] = np.cos(z[m] @ w[c] + b[c])
    x += offs[labels]
    x += 0.01 * rng.normal(size=(n, d))
    xq = _quantize_u8(x)
    if labels_out:
        return xq, labels
    return xq


def synthetic_higgs(n: int, seed: int = 7) -> np.ndarray:
    """32-cluster 8-d latent manifold lifted to 28 dims: featureless
    blobs embed degenerately in 2-D (any method), clustered data
    exercises the quality estimator meaningfully.  float32 draws keep
    generation at 11M x 28 within a few minutes on one host core."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((32, 8), dtype=np.float32) * 4.0
    latent = (centers[rng.integers(0, 32, n)]
              + rng.standard_normal((n, 8), dtype=np.float32))
    lift = rng.standard_normal((8, 28), dtype=np.float32)
    return (latent @ lift
            + 0.3 * rng.standard_normal((n, 28), dtype=np.float32))
