"""kNN graph construction front-end: brute force vs IVF dispatch.

Top-level replacement for reference ``get_kgraph`` (bin/embed.rs:450):
data -> HNSW -> KGraph becomes data -> (brute | IVF) -> KGraph.
"""

from __future__ import annotations

import logging

import jax.numpy as jnp

from ..graph.kgraph import KGraph
from ..params import KnnParams
from .brute import knn_graph_brute

logger = logging.getLogger(__name__)


def build_kgraph(x, knbn: int, distance: str = "DistL2",
                 params: KnnParams | None = None) -> KGraph:
    """Build the k-NN graph of ``x`` with the strategy fitting its size."""
    if params is None:
        params = KnnParams(knbn=knbn, distance=distance)
    n = x.shape[0]
    if n <= params.brute_force_limit:
        idx, dist = knn_graph_brute(x, knbn, distance=distance,
                                    block_rows=params.block_rows,
                                    dtype=params.dtype)
    else:
        from .ivf import knn_graph_ivf
        # enlarged build-k: construct and refine at build_k_factor * k,
        # truncate to k at the end.  Wider neighbour lists make each
        # NN-descent round propagate much further (the candidate set is
        # B(B(i))), so recall@k rises faster per round than refining at
        # k itself — the "refine at 2k, truncate" recipe.
        kb = knbn
        if params.refine_rounds > 0 and params.build_k_factor > 1.0:
            kb = max(knbn + 1, int(round(knbn * params.build_k_factor)))
        idx, dist = knn_graph_ivf(x, kb, distance=distance,
                                  nlist=params.nlist, nprobe=params.nprobe,
                                  dtype=params.dtype,
                                  quantizer=params.quantizer,
                                  layout=params.ivf_layout)
        if params.refine_rounds > 0:
            from .nndescent import nndescent_refine
            idx, dist = nndescent_refine(x, idx, dist,
                                         n_rounds=params.refine_rounds,
                                         distance=distance,
                                         dtype=params.dtype,
                                         rho=params.nndescent_rho)
        idx, dist = idx[:, :knbn], dist[:, :knbn]
    return KGraph(indices=idx, dists=dist)


def sampled_exact_recall(x, g, sample: int = 2000, seed: int = 11,
                         sample_ids=None) -> float:
    """recall@k of the build graph ``g`` vs an exact (chunked brute)
    search, on a row sample — the shared implementation behind
    bench.py, chip_smoke.py and examples/higgs.py (self column dropped
    from the k+1 search result; a duplicate twin displacing self is
    handled by the [:k] truncation).  The exact side runs its f32
    matmuls at Precision.HIGHEST (no TF32).  Only the sampled query
    rows are uploaded; ``x`` may be a host numpy array or an on-device
    array."""
    import jax
    import numpy as np
    from .brute import knn_search_brute

    n, k = g.indices.shape
    if sample_ids is None:
        rng = np.random.default_rng(seed)
        sub = np.sort(rng.choice(n, size=min(sample, n),
                                 replace=False)).astype(np.int32)
    else:
        sub = np.asarray(sample_ids, np.int32)
    with jax.default_matmul_precision("highest"):
        ei, _ = knn_search_brute(x[sub], x, k=k + 1)
    ei = np.asarray(ei)
    not_self = ei != sub[:, None]
    exact = np.stack([row[m][:k] for row, m in zip(ei, not_self)])
    return recall_at_k(np.asarray(g.indices)[sub], exact)


def recall_at_k(approx_idx, exact_idx, row_chunk: int = 500_000) -> float:
    """Mean fraction of true k-NN recovered (the north-star metric
    'kNN-graph recall@10 vs HNSW', BASELINE.json).

    Duplicate ids in an approx row (the IVF under-filled fallback
    duplicates the last valid neighbour) count as ONE hit — measured
    from the exact side: fraction of exact neighbours present in the
    approx row.  Rows are processed in chunks so the (c, k, k) match
    tensor stays bounded at 11M scale."""
    approx = jnp.asarray(approx_idx)
    exact = jnp.asarray(exact_idx)
    n = exact.shape[0]
    hits = 0.0
    for c0 in range(0, n, row_chunk):
        a = approx[c0:c0 + row_chunk]
        e = exact[c0:c0 + row_chunk]
        # per exact neighbour: is it anywhere in the approx row? (each
        # exact id is unique within its row, so no double counting)
        m = (e[:, :, None] == a[:, None, :]).any(-1)
        hits += float(m.sum())
    return hits / float(exact.size)
