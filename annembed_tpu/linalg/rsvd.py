"""Randomized truncated SVD (Halko-Tropp) for dense and k-sparse operators.

Rebuilds reference src/tools/svdapprox.rs (1669 LoC of LAPACK-backed
range finding) as compiled JAX:

  * fixed-rank subspace (QR) iteration  (svdapprox.rs:285 algo 4.4)
  * epsilon-adaptive rank discovery      (svdapprox.rs:444 algo 4.2) —
    ``adaptive_range_finder``: blocked Gram-Schmidt growth under
    ``lax.while_loop`` with the reference's Halko lemma-4.1 stopping
    rule (the reference grows one RwLock'd vector at a time; a block
    of 8 per iteration is the batched equivalent).
  * ``randomized_svd_op(..., epsil=...)``: cheap fixed-rank pass with
    residual-based truncation, kept for pipelines that know a rank cap.
  * ``direct_svd``: B = Q^T A, small dense SVD of B, U = Q Ub
    (svdapprox.rs:721-782; the LAPACK ``svddc`` boundary becomes
    ``jnp.linalg.svd`` on the (l, n) projection).

Operators are abstracted as a matmul closure ``matmat(X: (n, r)) -> (m, r)``
so the same code serves dense matrices and the COO graph Laplacians
(SpMM = scatter-add, replacing the reference's sprs CSR products,
svdapprox.rs:366,390).
"""

from __future__ import annotations

import functools
import os
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp


class SvdResult(NamedTuple):
    """Mirrors the reference ``SvdResult`` (svdapprox.rs): left singular
    vectors U (m, r), singular values s (r,), right vectors Vt (r, n)."""
    u: jnp.ndarray
    s: jnp.ndarray
    vt: jnp.ndarray


#: panel-orthogonalization algorithm: "auto" (CholeskyQR3 for tall
#: panels, Householder otherwise), "cholqr", "householder".  Env
#: override for A/Bs.
_QR_MODE = os.environ.get("ANNEMBED_RSVD_QR", "auto")


#: The (l, l) Gram and the (n, l) @ (l, l) basis products are pinned to
#: full f32: at DEFAULT precision a GPU runs them in TF32, which left
#: the 70k diffusion-maps basis 2.3e-4 from orthonormal (measured on
#: an H100); their cost is negligible next to the SpMMs.
_HIGHEST = jax.lax.Precision.HIGHEST


def _chol_qr_pass(y: jnp.ndarray, shift_rel: float) -> jnp.ndarray:
    """One CholeskyQR pass: Q = Y (L^T)^-1 with G = Y^T Y = L L^T.
    ``shift_rel`` > 0 adds a relative diagonal shift so the Cholesky
    stays positive-definite in f32 for ill-conditioned panels."""
    l = y.shape[1]
    g = jnp.matmul(y.T, y, precision=_HIGHEST)
    shift = shift_rel * jnp.trace(g) + 1e-20
    g = g + shift * jnp.eye(l, dtype=y.dtype)
    r = jnp.linalg.cholesky(g)                        # lower, G = R R^T
    qt = jax.scipy.linalg.solve_triangular(r, y.T, lower=True)
    return qt.T


def _qr_q(y: jnp.ndarray) -> jnp.ndarray:
    """Orthonormal basis of a (m, l) panel.

    Tall panels (the randomized-SVD hot path: m = n points, l ~ 30)
    use shifted CholeskyQR3 (Fukaya et al.): a shifted pass that
    guarantees a positive-definite f32 Gram even near rank deficiency,
    then two clean passes restoring orthogonality to machine
    precision.  Each pass is two matmuls plus an (l, l)
    Cholesky/triangular-solve — the matmul-shaped replacement for XLA's
    sequential Householder panel QR (which the reference reaches via
    LAPACK, svdapprox.rs:1006-1012).  Small panels keep double
    Householder QR ("twice is enough"): its cost is negligible there
    and it is the more robust algorithm for m ~ l.
    """
    m, l = y.shape
    mode = _QR_MODE
    if mode == "auto":
        mode = "cholqr" if (m >= 4096 and m >= 32 * l) else "householder"
    if mode == "cholqr":
        # the clean passes keep an eps-level shift: an EXACTLY
        # rank-deficient panel (operator rank < l) has a singular Gram
        # and an unshifted Cholesky would NaN; with the shift its null
        # directions become zero columns, which the projected SVD then
        # reports as zero singular values — same effective truncation
        # as the Householder path's orthogonal completion.
        q = _chol_qr_pass(y, 4e-6)
        q = _chol_qr_pass(q, 1e-7)
        return _chol_qr_pass(q, 1e-7)
    q, _ = jnp.linalg.qr(y)
    q, _ = jnp.linalg.qr(q)
    return q


def subspace_range(matmat: Callable, rmatmat: Callable, n_cols: int,
                   rank: int, n_iter: int, key: jax.Array,
                   dtype=jnp.float32) -> jnp.ndarray:
    """Randomized range finder with QR-stabilized power iteration.

    Reference subspace_iteration_full/csr (svdapprox.rs:285,343):
    Y = A Omega; repeat (Q <- qr(Y); Y <- A (A^T Q)).  Returns Q (m, rank).
    """
    omega = jax.random.normal(key, (n_cols, rank), dtype)
    y = matmat(omega)
    q = _qr_q(y)

    def body(_, q):
        z = rmatmat(q)
        qz = _qr_q(z)
        y = matmat(qz)
        return _qr_q(y)

    return jax.lax.fori_loop(0, n_iter, body, q)


def randomized_svd_op(matmat: Callable, rmatmat: Callable,
                      shape: tuple[int, int], rank: int,
                      n_iter: int = 5, n_oversample: int = 10,
                      key: Optional[jax.Array] = None,
                      epsil: Optional[float] = None,
                      dtype=jnp.float32) -> SvdResult:
    """Truncated SVD of a linear operator given by matmat closures.

    ``rank`` singular triplets are returned (after an oversampled range
    pass).  If ``epsil`` is given, triplets with s_i <= epsil * s_0 are
    additionally zeroed/truncated — the compiled stand-in for the
    reference's adaptive RangePrecision mode (svdapprox.rs:155,444).

    ``dtype=jnp.float64`` gives the f64 path (the reference is generic
    over ``F: Float``, svdapprox.rs:210); requires x64 enabled
    (``jax.config.update("jax_enable_x64", True)`` or the
    ``jax.experimental.enable_x64`` context) and closures that preserve
    the probe dtype.
    """
    m, n = shape
    if key is None:
        key = jax.random.PRNGKey(4664397)  # reference seed svdapprox.rs:70
    l = min(rank + n_oversample, min(m, n))
    q = subspace_range(matmat, rmatmat, n, l, n_iter, key,
                       dtype=dtype)  # (m, l)
    b = rmatmat(q).T  # (l, n)  == Q^T A
    ub, s, vt = jnp.linalg.svd(b, full_matrices=False)
    u = jnp.matmul(q, ub, precision=_HIGHEST)
    r = min(rank, l)
    u, s, vt = u[:, :r], s[:r], vt[:r]
    if epsil is not None:
        keep = s > epsil * s[0]
        s = jnp.where(keep, s, 0.0)
    return SvdResult(u=u, s=s, vt=vt)


def randomized_svd_dense(a: jnp.ndarray, rank: int, n_iter: int = 5,
                         n_oversample: int = 10,
                         key: Optional[jax.Array] = None,
                         epsil: Optional[float] = None,
                         dtype=jnp.float32) -> SvdResult:
    """Randomized SVD of a dense matrix (MatMode::FULL path)."""
    a = jnp.asarray(a, dtype)
    matmat = lambda x: a @ x
    rmatmat = lambda x: a.T @ x
    return randomized_svd_op(matmat, rmatmat, a.shape, rank, n_iter,
                             n_oversample, key, epsil, dtype=dtype)


def full_svd_dense(a: jnp.ndarray, dtype=jnp.float32) -> SvdResult:
    """Exact SVD (reference svd_f32 -> LAPACK gesdd, graphlaplace.rs:296;
    the reference is also generic over f64 — pass ``dtype=jnp.float64``
    with x64 enabled for that path)."""
    u, s, vt = jnp.linalg.svd(jnp.asarray(a, dtype),
                              full_matrices=False)
    return SvdResult(u=u, s=s, vt=vt)


# ---------------------------------------------------------------------------
# COO sparse operator (the k-sparse graph Laplacian)
# ---------------------------------------------------------------------------

#: One-shot SpMM materializes a (nnz, r) gather intermediate; above
#: this edge count it is sliced into edge slabs under a fori_loop so
#: HBM holds one slab at a time.  At 6.6M x 17 edges (nnz 112M) and
#: r=30 the one-shot form needs an f32[112.2M, 30] temp (13.4 GB);
#: the slabbed form peaks at slab*r.  Env override: ANNEMBED_COO_EDGE_SLAB.
_COO_SLAB_THRESHOLD = 16_000_000
_COO_EDGE_SLAB = int(os.environ.get("ANNEMBED_COO_EDGE_SLAB",
                                    4_000_000))


def spmm_scatter(rows: jnp.ndarray, cols: jnp.ndarray,
                 vals: jnp.ndarray, x: jnp.ndarray,
                 n_rows: int) -> jnp.ndarray:
    """COO SpMM A @ X by gather + scatter-add, with the gather sliced
    into edge slabs under ``lax.fori_loop`` once nnz crosses the slab
    threshold — identical results (f32 scatter-add order within a slab
    is unchanged; across slabs addition order shifts by at most slab
    boundaries), bounded HBM temps.  Shared by the single-chip
    ``coo_matmat`` closure and the per-device shard of
    ``parallel/sharded_svd.py``."""
    nnz = int(rows.shape[0])
    if nnz <= max(_COO_SLAB_THRESHOLD, _COO_EDGE_SLAB):
        contrib = vals[:, None] * x[cols]              # (nnz, r)
        return jnp.zeros((n_rows, x.shape[1]), x.dtype).at[rows].add(contrib)

    slab = _COO_EDGE_SLAB
    n_slabs = -(-nnz // slab)
    pad = n_slabs * slab - nnz
    # zero-valued pads aimed at row/col 0: contribute exactly 0
    rows_p = jnp.concatenate([rows, jnp.zeros((pad,), rows.dtype)])
    cols_p = jnp.concatenate([cols, jnp.zeros((pad,), cols.dtype)])
    vals_p = jnp.concatenate([vals, jnp.zeros((pad,), vals.dtype)])

    def body(i, acc):
        sl = lambda a: jax.lax.dynamic_slice_in_dim(a, i * slab, slab)
        contrib = sl(vals_p)[:, None] * x[sl(cols_p)]  # (slab, r)
        return acc.at[sl(rows_p)].add(contrib)

    return jax.lax.fori_loop(0, n_slabs, body,
                             jnp.zeros((n_rows, x.shape[1]), x.dtype))


def coo_matmat(rows: jnp.ndarray, cols: jnp.ndarray, vals: jnp.ndarray,
               n_rows: int):
    """Return matmat closure computing A @ X for COO A of shape
    (n_rows, *): one gather + scatter-add, replacing sprs
    ``csr_mulacc_dense_rowmaj`` (svdapprox.rs:366).  Large operators
    run edge-slabbed (see ``spmm_scatter``)."""

    def matmat(x: jnp.ndarray) -> jnp.ndarray:
        return spmm_scatter(rows, cols, vals, x, n_rows)

    return matmat


@functools.partial(jax.jit, static_argnames=("n", "rank", "n_iter",
                                              "n_oversample"))
def _randomized_svd_coo_fused(rows, cols, vals, key, n: int, rank: int,
                              n_iter: int = 5,
                              n_oversample: int = 10) -> SvdResult:
    """Fully-jitted randomized SVD of a symmetric COO operator — one
    XLA program for the whole range iteration + projection (keeps
    the dispatch and compile count low)."""
    mm = coo_matmat(rows, cols, vals, n)
    return randomized_svd_op(mm, mm, (n, n), rank, n_iter=n_iter,
                             n_oversample=n_oversample, key=key,
                             dtype=vals.dtype)


#: Above this nnz the fused single-program SVD is split into one
#: program per stage, so every execution is ~one SpMM + one QR (at
#: these sizes dispatch overhead is noise).  Whether a GPU needs the
#: split is not measured yet (ROADMAP queue 3).
_FUSED_SVD_NNZ_LIMIT = int(os.environ.get("ANNEMBED_FUSED_SVD_NNZ",
                                          48_000_000))

_spmm_jit = jax.jit(spmm_scatter, static_argnames=("n_rows",))
_qr_q_jit = jax.jit(_qr_q)


@functools.partial(jax.jit, static_argnames=("rank",))
def _project_svd(q, b, rank: int):
    ub, s, vt = jnp.linalg.svd(b, full_matrices=False)
    r = min(rank, q.shape[1])
    return SvdResult(u=jnp.matmul(q, ub, precision=_HIGHEST)[:, :r],
                     s=s[:r], vt=vt[:r])


def _randomized_svd_coo_eager(rows, cols, vals, key, n: int, rank: int,
                              n_iter: int = 5,
                              n_oversample: int = 10) -> SvdResult:
    """Stage-per-program randomized SVD of a symmetric COO operator.

    Same stages, same QR and same PRNG draw as the fused form (range
    finder = ``subspace_range``, projection = ``randomized_svd_op``
    tail), but each SpMM / QR / final projection is its own XLA
    program (see _FUSED_SVD_NNZ_LIMIT).
    Results agree with the fused form to f32 fusion-reassociation
    tolerance (pinned by tests/test_rsvd.py)."""
    dtype = vals.dtype
    l = min(rank + n_oversample, n)
    omega = jax.random.normal(key, (n, l), dtype)
    q = _qr_q_jit(_spmm_jit(rows, cols, vals, omega, n_rows=n))
    for _ in range(n_iter):
        qz = _qr_q_jit(_spmm_jit(rows, cols, vals, q, n_rows=n))
        q = _qr_q_jit(_spmm_jit(rows, cols, vals, qz, n_rows=n))
    b = _spmm_jit(rows, cols, vals, q, n_rows=n).T       # (l, n)
    return _project_svd(q, b, rank)


def randomized_svd_coo(rows, cols, vals, key, n: int, rank: int,
                       n_iter: int = 5, n_oversample: int = 10) -> SvdResult:
    """Randomized SVD of a symmetric COO operator: fused single
    program below _FUSED_SVD_NNZ_LIMIT nnz, stage-per-program above."""
    if int(rows.shape[0]) > _FUSED_SVD_NNZ_LIMIT:
        return _randomized_svd_coo_eager(rows, cols, vals, key, n=n,
                                         rank=rank, n_iter=n_iter,
                                         n_oversample=n_oversample)
    return _randomized_svd_coo_fused(rows, cols, vals, key, n=n,
                                     rank=rank, n_iter=n_iter,
                                     n_oversample=n_oversample)


def adaptive_range_finder(matmat: Callable, shape: tuple[int, int],
                          epsil: float = 0.05, max_rank: int = 128,
                          block_size: int = 8,
                          key: Optional[jax.Array] = None):
    """Epsilon-adaptive randomized range finder (Halko-Tropp algo 4.2;
    reference ``adaptative_range_finder_matrep``, svdapprox.rs:444-597).

    The reference grows the basis one Gaussian sample at a time inside
    a RwLock'd vector pool; here the same stopping rule runs *blocked*
    under ``lax.while_loop`` with a static (m, max_rank) basis buffer —
    each iteration draws ``block_size`` fresh Gaussian samples y = A w,
    projects out the current basis (twice, for f32 stability), measures
    the residual norms, and appends an orthonormalized block.  Stopping
    rule: Halko lemma 4.1 bounds ||A - QQ^T A|| <= 10 sqrt(2/pi)
    max_j ||y_j|| (used verbatim by the reference at
    svdapprox.rs:521-545); the reference compares against an absolute
    epsil, here ``epsil`` is *relative* to the operator scale (the max
    first-block sample norm) so the rule is usable without knowing
    ||A|| — in f32, residuals of a captured range sit at ~1e-5 of the
    scale, not at an absolute constant.

    Returns (q (m, max_rank) with zero columns past the discovered
    rank, rank scalar int32).  Fully jittable.
    """
    m, n = shape
    if key is None:
        key = jax.random.PRNGKey(4664397)  # reference seed svdapprox.rs:70
    max_rank = min(max_rank, min(m, n))
    nb = -(-max_rank // block_size)
    halko = 10.0 * jnp.sqrt(2.0 / jnp.pi)

    def cond(state):
        _, i, _, done, _, _ = state
        return jnp.logical_and(jnp.logical_not(done), i < nb)

    def body(state):
        q, i, count, _, scale, key = state
        key, k2 = jax.random.split(key)
        omega = jax.random.normal(k2, (n, block_size), jnp.float32)
        y = matmat(omega)                        # (m, bs)
        # project out the current basis; zero columns of q are inert
        y = y - q @ (q.T @ y)
        y = y - q @ (q.T @ y)
        res_max = jnp.max(jnp.linalg.norm(y, axis=0))
        scale = jnp.maximum(scale, res_max)      # first block sets it
        done = halko * res_max < epsil * scale
        # per-column modified Gram-Schmidt (the reference's
        # orthogonalize_with_q, svdapprox.rs:975, batched per block).
        # QR is NOT usable here: its completion of rank-deficient
        # blocks is arbitrary and need not be orthogonal to q.
        # Degenerate directions (norm below f32 noise of the operator
        # scale) are zeroed and not counted.
        cols = []
        kept = []
        for j in range(block_size):
            v = y[:, j]
            for u in cols:
                v = v - u * jnp.dot(u, v)
            v = v - q @ (q.T @ v)
            nrm = jnp.linalg.norm(v)
            ok = jnp.logical_and(nrm > 1e-5 * scale,
                                 jnp.logical_not(done))
            cols.append(jnp.where(ok, v / jnp.maximum(nrm, 1e-30), 0.0))
            kept.append(ok)
        qb = jnp.stack(cols, axis=1)
        count = count + jnp.sum(jnp.stack(kept).astype(jnp.int32))
        q = jax.lax.dynamic_update_slice(q, qb, (0, i * block_size))
        return q, i + 1, count, done, scale, key

    q0 = jnp.zeros((m, nb * block_size), jnp.float32)
    q, i, count, done, _, _ = jax.lax.while_loop(
        cond, body, (q0, jnp.int32(0), jnp.int32(0), jnp.bool_(False),
                     jnp.float32(0.0), key))
    return q[:, :max_rank], jnp.clip(count, 0, max_rank)


def randomized_svd_adaptive(matmat: Callable, rmatmat: Callable,
                            shape: tuple[int, int], epsil: float = 0.05,
                            max_rank: int = 128, block_size: int = 8,
                            key: Optional[jax.Array] = None) -> SvdResult:
    """Adaptive-precision truncated SVD (the reference's
    RangeApproxMode::EPSIL path, svdapprox.rs:155,721): discover the
    rank with the adaptive finder, then project and SVD.  Columns past
    the discovered rank are zero, so their singular triplets land at
    the tail and are masked out."""
    q, rank = adaptive_range_finder(matmat, shape, epsil=epsil,
                                    max_rank=max_rank,
                                    block_size=block_size, key=key)
    b = rmatmat(q).T                              # (l, n) = Q^T A
    ub, s, vt = jnp.linalg.svd(b, full_matrices=False)
    u = q @ ub
    keep = jnp.arange(s.shape[0]) < rank
    s = jnp.where(keep, s, 0.0)
    return SvdResult(u=u, s=s, vt=vt)


def estimate_first_singular_value(matmat: Callable, rmatmat: Callable,
                                  n_cols: int, n_iter: int = 20,
                                  key: Optional[jax.Array] = None) -> jnp.ndarray:
    """Power iteration estimator of sigma_1 (svdapprox.rs:844)."""
    if key is None:
        key = jax.random.PRNGKey(0)
    v = jax.random.normal(key, (n_cols, 1), jnp.float32)
    v = v / jnp.linalg.norm(v)

    def body(_, v):
        w = rmatmat(matmat(v))
        return w / jnp.maximum(jnp.linalg.norm(w), 1e-30)

    v = jax.lax.fori_loop(0, n_iter, body, v)
    return jnp.linalg.norm(matmat(v))
