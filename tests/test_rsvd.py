"""Randomized SVD tests, mirroring the reference's heaviest test area
(svdapprox.rs:1017-1669): the Wikipedia 4x5 fixture with known singular
values [3, sqrt(5), 2, 0] (svdapprox.rs:1335), synthetic low-rank random
matrices, and COO SpMM cross-checks.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from annembed_tpu.linalg.rsvd import (randomized_svd_dense, full_svd_dense,
                                      randomized_svd_op, coo_matmat,
                                      estimate_first_singular_value)

WIKI = np.array([[1., 0., 0., 0., 2.],
                 [0., 0., 3., 0., 0.],
                 [0., 0., 0., 0., 0.],
                 [0., 2., 0., 0., 0.]], dtype=np.float32)
WIKI_SIGMA = np.array([3.0, np.sqrt(5.0), 2.0, 0.0], dtype=np.float32)


def test_full_svd_wiki():
    res = full_svd_dense(jnp.asarray(WIKI))
    np.testing.assert_allclose(np.asarray(res.s), WIKI_SIGMA, atol=1e-5)


def test_randomized_svd_wiki():
    res = randomized_svd_dense(jnp.asarray(WIKI), rank=4, n_iter=6,
                               n_oversample=1)
    np.testing.assert_allclose(np.asarray(res.s), WIKI_SIGMA, atol=1e-4)


def test_randomized_svd_reconstruction(rng):
    # synthetic low-rank: A = U diag(s) V^T with rank 12 inside 200x150
    r = 12
    u, _ = np.linalg.qr(rng.normal(size=(200, r)))
    v, _ = np.linalg.qr(rng.normal(size=(150, r)))
    s = np.sort(rng.random(r) + 0.5)[::-1]
    a = (u * s) @ v.T
    res = randomized_svd_dense(jnp.asarray(a, jnp.float32), rank=r, n_iter=7)
    np.testing.assert_allclose(np.asarray(res.s), s, rtol=1e-3)
    recon = np.asarray(res.u) * np.asarray(res.s) @ np.asarray(res.vt)
    np.testing.assert_allclose(recon, a, atol=1e-3)


def test_randomized_svd_truncation_vs_exact(rng):
    a = rng.normal(size=(120, 80)).astype(np.float32)
    exact = np.linalg.svd(a, compute_uv=False)
    res = randomized_svd_dense(jnp.asarray(a), rank=10, n_iter=8,
                               n_oversample=15)
    np.testing.assert_allclose(np.asarray(res.s), exact[:10], rtol=2e-2)


def test_coo_matmat_matches_dense(rng):
    n, m = 50, 40
    dense = np.zeros((n, m), np.float32)
    nnz = 200
    rows = rng.integers(0, n, nnz).astype(np.int32)
    cols = rng.integers(0, m, nnz).astype(np.int32)
    vals = rng.normal(size=nnz).astype(np.float32)
    for r_, c_, v_ in zip(rows, cols, vals):
        dense[r_, c_] += v_
    mm = coo_matmat(jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(vals), n)
    x = rng.normal(size=(m, 7)).astype(np.float32)
    np.testing.assert_allclose(np.asarray(mm(jnp.asarray(x))), dense @ x,
                               rtol=1e-4, atol=1e-4)


def test_coo_matmat_slabbed_matches_oneshot(rng, monkeypatch):
    # force the large-nnz edge-slab path and pin it to the one-shot form
    import annembed_tpu.linalg.rsvd as rsvd_mod
    n, m = 60, 45
    nnz = 1000
    rows = rng.integers(0, n, nnz).astype(np.int32)
    cols = rng.integers(0, m, nnz).astype(np.int32)
    vals = rng.normal(size=nnz).astype(np.float32)
    x = rng.normal(size=(m, 9)).astype(np.float32)
    one_shot = coo_matmat(jnp.asarray(rows), jnp.asarray(cols),
                          jnp.asarray(vals), n)(jnp.asarray(x))
    monkeypatch.setattr(rsvd_mod, "_COO_SLAB_THRESHOLD", 0)
    monkeypatch.setattr(rsvd_mod, "_COO_EDGE_SLAB", 128)  # 8 slabs + pad
    slabbed = rsvd_mod.coo_matmat(jnp.asarray(rows), jnp.asarray(cols),
                                  jnp.asarray(vals), n)(jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(slabbed), np.asarray(one_shot),
                               rtol=1e-5, atol=1e-5)


def test_randomized_svd_on_coo_operator(rng):
    # symmetric graph-like operator via COO closures
    n = 100
    a = rng.normal(size=(n, n)).astype(np.float32)
    a = 0.5 * (a + a.T)
    rows, cols = np.nonzero(np.ones_like(a))
    vals = a[rows, cols]
    mm = coo_matmat(jnp.asarray(rows.astype(np.int32)),
                    jnp.asarray(cols.astype(np.int32)),
                    jnp.asarray(vals), n)
    res = randomized_svd_op(mm, mm, (n, n), rank=5, n_iter=8)
    exact = np.linalg.svd(a, compute_uv=False)
    np.testing.assert_allclose(np.asarray(res.s), exact[:5], rtol=2e-2)


def test_first_singular_value_power_iteration(rng):
    a = rng.normal(size=(60, 60)).astype(np.float32)
    mm = lambda x: jnp.asarray(a) @ x
    rmm = lambda x: jnp.asarray(a).T @ x
    est = estimate_first_singular_value(mm, rmm, 60, n_iter=50)
    exact = np.linalg.svd(a, compute_uv=False)[0]
    np.testing.assert_allclose(float(est), exact, rtol=1e-3)


def test_epsil_truncation():
    res = randomized_svd_dense(jnp.asarray(WIKI), rank=4, n_iter=6,
                               n_oversample=1, epsil=0.5)
    s = np.asarray(res.s)
    assert s[0] > 0 and (s[s < 0.5 * s[0]] == 0).all()


def test_adaptive_range_finder_discovers_rank(rng):
    """Reference test_range_approx_epsil (svdapprox.rs:1192): on a
    synthetic rank-r matrix the adaptive finder must stop at ~r (within
    block granularity), not at max_rank."""
    from annembed_tpu.linalg.rsvd import adaptive_range_finder
    m, n, r = 300, 250, 20
    u = np.linalg.qr(rng.normal(size=(m, r)))[0]
    v = np.linalg.qr(rng.normal(size=(n, r)))[0]
    s = np.linspace(5.0, 1.0, r)
    a = jnp.asarray((u * s) @ v.T, jnp.float32)
    q, rank = adaptive_range_finder(lambda x: a @ x, (m, n),
                                    epsil=1e-3, max_rank=128,
                                    block_size=8)
    rank = int(rank)
    assert r <= rank <= r + 16, rank
    # basis captures the range: ||A - QQ^T A||_F tiny vs ||A||_F
    qa = np.asarray(q[:, :rank])
    res = np.asarray(a) - qa @ (qa.T @ np.asarray(a))
    assert np.linalg.norm(res) < 1e-2 * np.linalg.norm(np.asarray(a))


def test_adaptive_svd_wiki_fixture():
    """EPSIL-mode SVD on the wiki matrix (svdapprox.rs:1458-1527):
    singular values [3, sqrt(5), 2, 0] recovered, zero dropped."""
    from annembed_tpu.linalg.rsvd import randomized_svd_adaptive
    a = jnp.asarray(WIKI, jnp.float32)
    res = randomized_svd_adaptive(lambda x: a @ x, lambda x: a.T @ x,
                                  a.shape, epsil=0.5, max_rank=4,
                                  block_size=2)
    s = np.asarray(res.s)
    s_nz = np.sort(s[s > 1e-5])[::-1]
    np.testing.assert_allclose(s_nz[:3], [3.0, np.sqrt(5.0), 2.0],
                               atol=1e-4)


# ---------------------------------------------------------------------------
# CholeskyQR3 panel orthogonalization (the tall-panel path)
# ---------------------------------------------------------------------------

def test_cholqr_orthogonality_tall_panel(rng):
    """_qr_q's CholeskyQR3 branch must deliver machine-precision
    orthogonality on tall panels, including ill-conditioned ones."""
    _check_cholqr_tall_panel(rng)


@pytest.mark.gpu
def test_cholqr_orthogonality_tall_panel_on_gpu(gpu_device, rng):
    """The same on the card, where DEFAULT f32 matmuls run in TF32."""
    _check_cholqr_tall_panel(rng)


def _check_cholqr_tall_panel(rng):
    from annembed_tpu.linalg.rsvd import _qr_q
    m, l = 8192, 24
    y = rng.normal(size=(m, l)).astype(np.float32)
    # make the panel ill-conditioned: last columns nearly dependent
    y[:, -1] = y[:, 0] + 1e-4 * y[:, -1]
    y[:, -2] = y[:, 1] + 1e-5 * y[:, -2]
    q = np.asarray(_qr_q(jnp.asarray(y)))
    assert q.shape == (m, l)
    err = np.abs(q.T @ q - np.eye(l, dtype=np.float32)).max()
    assert err < 5e-5, f"orthogonality error {err}"
    # Q must span the panel: projecting y onto Q reproduces it
    resid = np.linalg.norm(y - q @ (q.T @ y)) / np.linalg.norm(y)
    assert resid < 1e-3, f"range residual {resid}"


def test_cholqr_svd_matches_householder(rng):
    """Singular values through the CholQR path agree with the
    Householder path on a tall low-rank operator."""
    import annembed_tpu.linalg.rsvd as rsvd
    r = 10
    m, n = 9000, 64
    u = np.linalg.qr(rng.normal(size=(m, r)))[0]
    v = np.linalg.qr(rng.normal(size=(n, r)))[0]
    s = np.linspace(8.0, 0.5, r)
    a = (u * s) @ v.T
    a = jnp.asarray(a.astype(np.float32))
    old = rsvd._QR_MODE
    try:
        rsvd._QR_MODE = "cholqr"
        res_c = randomized_svd_dense(a, rank=r, n_iter=4)
        rsvd._QR_MODE = "householder"
        res_h = randomized_svd_dense(a, rank=r, n_iter=4)
    finally:
        rsvd._QR_MODE = old
    np.testing.assert_allclose(np.asarray(res_c.s), s, rtol=2e-4)
    np.testing.assert_allclose(np.asarray(res_c.s), np.asarray(res_h.s),
                               rtol=2e-4)


def test_cholqr_zero_panel_no_nan():
    """A zero panel must not produce NaNs (degenerate operator guard)."""
    from annembed_tpu.linalg.rsvd import _qr_q
    q = np.asarray(_qr_q(jnp.zeros((8192, 8), jnp.float32)))
    assert np.isfinite(q).all()


def test_randomized_svd_wiki_f64():
    """f64 escape hatch (the reference is generic
    over F: Float, svdapprox.rs:210): the wiki fixture at float64
    should reach far tighter tolerances than f32 allows."""
    with jax.enable_x64():
        res = randomized_svd_dense(jnp.asarray(WIKI, jnp.float64), rank=4,
                                   n_iter=6, n_oversample=1,
                                   dtype=jnp.float64)
        assert res.s.dtype == jnp.float64
        np.testing.assert_allclose(np.asarray(res.s),
                                   WIKI_SIGMA.astype(np.float64), atol=1e-10)
        full = full_svd_dense(jnp.asarray(WIKI, jnp.float64),
                              dtype=jnp.float64)
        assert full.s.dtype == jnp.float64
        np.testing.assert_allclose(np.asarray(full.s),
                                   WIKI_SIGMA.astype(np.float64), atol=1e-12)


def test_eager_svd_matches_fused(rng):
    """Stage-per-program COO SVD (the large-nnz dispatch) must match
    the fused single-program form: same stages, same PRNG, same QR."""
    import annembed_tpu.linalg.rsvd as rsvd_mod

    n, k = 500, 6
    rows = np.repeat(np.arange(n), k).astype(np.int32)
    cols = rng.integers(0, n, n * k).astype(np.int32)
    vals = rng.uniform(0.1, 1.0, n * k).astype(np.float32)
    # symmetrize so the operator matches the Laplacian's structure
    rows_s = np.concatenate([rows, cols]).astype(np.int32)
    cols_s = np.concatenate([cols, rows]).astype(np.int32)
    vals_s = np.concatenate([vals, vals]).astype(np.float32)
    key = jax.random.PRNGKey(4664397)
    args = (jnp.asarray(rows_s), jnp.asarray(cols_s), jnp.asarray(vals_s),
            key)
    fused = rsvd_mod._randomized_svd_coo_fused(*args, n=n, rank=8,
                                               n_iter=3, n_oversample=4)
    eager = rsvd_mod._randomized_svd_coo_eager(*args, n=n, rank=8,
                                               n_iter=3, n_oversample=4)
    np.testing.assert_allclose(np.asarray(eager.s), np.asarray(fused.s),
                               rtol=3e-5)
    # singular vectors up to sign
    fu, eu = np.asarray(fused.u), np.asarray(eager.u)
    sign = np.sign(np.sum(fu * eu, axis=0))
    np.testing.assert_allclose(eu * sign, fu, atol=3e-4)


def test_randomized_svd_coo_dispatch(rng, monkeypatch):
    """The public entry dispatches to the eager path above the nnz
    limit and returns the same result."""
    import annembed_tpu.linalg.rsvd as rsvd_mod
    from annembed_tpu.linalg.rsvd import randomized_svd_coo

    n, k = 300, 5
    rows = np.repeat(np.arange(n), k).astype(np.int32)
    cols = rng.integers(0, n, n * k).astype(np.int32)
    vals = rng.uniform(0.1, 1.0, n * k).astype(np.float32)
    key = jax.random.PRNGKey(0)
    args = (jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(vals), key)
    big = randomized_svd_coo(*args, n=n, rank=6, n_iter=2)
    monkeypatch.setattr(rsvd_mod, "_FUSED_SVD_NNZ_LIMIT", 10)
    small = randomized_svd_coo(*args, n=n, rank=6, n_iter=2)
    np.testing.assert_allclose(np.asarray(small.s), np.asarray(big.s),
                               rtol=3e-5)
