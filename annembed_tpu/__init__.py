"""annembed_tpu — nonlinear dimension reduction on accelerators.

A ground-up JAX/XLA/Pallas rebuild of the capabilities of the
``annembed`` Rust crate (t-SNE / LargeVis / UMAP family): approximate
k-NN graph construction as batched distance matmuls, perplexity-calibrated probability
graphs, diffusion-maps spectral initialization via randomized SVD,
cross-entropy negative-sampling embedding optimization, and the
quality / intrinsic-dimension / hubness estimators.

Public surface (mirrors reference src/prelude.rs + src/python.rs):
  embed, dmap_embed, Embedder, DiffusionMaps,
  EmbedderParams, DiffusionParams, KnnParams.
"""

from .params import (EmbedderParams, DiffusionParams, KnnParams, PROBA_MIN)
from .api import embed, dmap_embed
from .graph.kgraph import KGraph
from .graph.proba import to_proba_edges, NodeParams
from .knn.api import build_kgraph, recall_at_k
from .knn.hierarchy import build_projection, KGraphProjection
from .optim.embedder import Embedder
from .spectral.diffmaps import DiffusionMaps
from .estimators.quality import quality_estimate
from .estimators.hdbscan import (hdbscan, single_linkage, HdbscanResult,
                                 outlier_scores)
from .estimators.dimension import (intrinsic_dim_levina_bickel,
                                   intrinsic_dim_2nn)
from .estimators.hubness import Hubness

__version__ = "0.1.0"

__all__ = [
    "embed", "dmap_embed", "Embedder", "DiffusionMaps",
    "EmbedderParams", "DiffusionParams", "KnnParams", "PROBA_MIN",
    "KGraph", "NodeParams", "to_proba_edges", "build_kgraph",
    "recall_at_k", "build_projection", "KGraphProjection",
    "quality_estimate", "intrinsic_dim_levina_bickel",
    "intrinsic_dim_2nn", "Hubness",
    "hdbscan", "single_linkage", "HdbscanResult", "outlier_scores",
]
