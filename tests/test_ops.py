"""Fused top-1 kernel (ops/top1.py): the Triton-route Pallas kernel in
interpret mode on the CPU, its operand padding, and the projection's
choice between the kernel and the plain XLA search."""

import numpy as np
import jax.numpy as jnp
import pytest

from annembed_tpu.knn import hierarchy
from annembed_tpu.ops.top1 import pad_operands, top1_l2


def _oracle(q, c):
    d2 = ((q[:, None, :] - c[None, :, :]) ** 2).sum(-1)
    i = d2.argmin(1)
    return i, np.sqrt(d2[np.arange(len(q)), i])


def test_top1_matches_oracle(rng):
    q = rng.normal(size=(300, 16)).astype(np.float32)
    c = rng.normal(size=(500, 16)).astype(np.float32)
    idx, dist = top1_l2(q, c, block_q=128, tile_m=64, interpret=True)
    ref_idx, ref_dist = _oracle(q, c)
    np.testing.assert_array_equal(np.asarray(idx), ref_idx)
    np.testing.assert_allclose(np.asarray(dist), ref_dist,
                               rtol=1e-5, atol=1e-6)


def test_top1_padded_shapes(rng):
    # nq and m not multiples of the blocks; padded corpus must not win
    q = rng.normal(size=(77, 5)).astype(np.float32)
    c = rng.normal(size=(131, 5)).astype(np.float32) + 10.0
    idx, dist = top1_l2(q, c, block_q=32, tile_m=64, interpret=True)
    ref_idx, ref_dist = _oracle(q, c)
    np.testing.assert_array_equal(np.asarray(idx), ref_idx)
    assert (np.asarray(idx) < 131).all()
    np.testing.assert_allclose(np.asarray(dist), ref_dist, rtol=1e-5)


def test_top1_pad_operands_higgs_width(rng):
    """d = 28 pads to 32 features, queries to the block, the corpus to
    a whole number of tiles with +inf norms on its pad rows; the kernel
    then agrees with the oracle at that width."""
    q = rng.normal(size=(70, 28)).astype(np.float32)
    c = rng.normal(size=(300, 28)).astype(np.float32)
    qp, cp, csq = pad_operands(jnp.asarray(q), jnp.asarray(c),
                               block_q=64, tile_m=128)
    assert qp.shape == (128, 32) and cp.shape == (384, 32)
    csq = np.asarray(csq)
    assert np.isinf(csq[300:]).all() and np.isfinite(csq[:300]).all()
    np.testing.assert_allclose(csq[:300], (c ** 2).sum(1), rtol=1e-5)
    np.testing.assert_array_equal(np.asarray(qp)[:70, :28], q)
    assert not np.asarray(qp)[70:].any() and not np.asarray(qp)[:, 28:].any()
    idx, _ = top1_l2(q, c, block_q=64, tile_m=128, interpret=True)
    np.testing.assert_array_equal(np.asarray(idx), _oracle(q, c)[0])


@pytest.mark.parametrize("backend,distance,kernel", [
    ("cpu", "DistL2", False),
    ("gpu", "DistL2", True),
    ("gpu", "DistL1", False),
])
def test_projection_routing(rng, monkeypatch, backend, distance, kernel):
    """The GPU takes the kernel for L2; every other case takes the
    plain search, by platform choice (no try/except fallback)."""
    monkeypatch.setattr(hierarchy.jax, "default_backend", lambda: backend)
    assert hierarchy.use_top1_kernel(distance) is kernel
    calls = []
    import annembed_tpu.ops.top1 as top1_mod
    real = top1_mod.top1_l2
    monkeypatch.setattr(top1_mod, "top1_l2", lambda a, b: calls.append(1)
                        or real(a, b, interpret=True))
    x = rng.normal(size=(40, 6)).astype(np.float32)
    idx, dist = hierarchy.project_top1(x, x[:10], distance)
    assert bool(calls) is kernel
    ref = np.abs(x[:, None] - x[None, :10]).sum(-1) if distance == "DistL1" \
        else ((x[:, None] - x[None, :10]) ** 2).sum(-1)
    np.testing.assert_array_equal(np.asarray(idx), ref.argmin(1))


@pytest.mark.gpu
def test_top1_compiled_on_gpu(gpu_device, rng):
    """The kernel as compiled for the card agrees with the oracle."""
    q = rng.normal(size=(1000, 28)).astype(np.float32)
    c = rng.normal(size=(3000, 28)).astype(np.float32)
    idx, dist = top1_l2(q, c)
    ref_idx, ref_dist = _oracle(q, c)
    assert (np.asarray(idx) == ref_idx).mean() >= 0.999
    np.testing.assert_allclose(np.asarray(dist), ref_dist, rtol=1e-4)
