"""Top-level API + CLI tests (reference python.rs embed/dmap_embed
signatures and bin/embed.rs flow)."""

import json
import os
import subprocess
import sys

import numpy as np

import annembed_tpu as at

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def blobs(rng, n_per=80, d=12):
    centers = rng.normal(size=(3, d)) * 10
    x = np.concatenate([centers[i] + rng.normal(size=(n_per, d))
                        for i in range(3)])
    return x.astype(np.float32)


def test_embed_from_array(rng):
    x = blobs(rng)
    y, info = at.embed(x, dim=2, batch=5, nbng=6)
    assert y.shape == (240, 2)
    assert np.isfinite(y).all()
    assert info["final_ce"] < info["initial_ce"] * 1.5


def test_embed_from_csv_with_quality(tmp_path, rng):
    x = blobs(rng, n_per=60)
    p = tmp_path / "in.csv"
    np.savetxt(p, x, delimiter=",")
    out = tmp_path / "out.csv"
    y, info = at.embed(str(p), outfile=str(out), dim=2, batch=5, nbng=6,
                       with_quality=True)
    assert out.exists()
    assert "quality" in info
    assert info["quality"]["mean_nb_matched"] > 0


def test_embed_hierarchical(rng):
    x = blobs(rng, n_per=100)
    y, info = at.embed(x, dim=2, batch=4, nbng=6, layer=1,
                       hierarchy_fraction=0.2)
    assert y.shape == (300, 2)
    assert np.isfinite(y).all()


def test_dmap_embed_api(rng):
    x = blobs(rng)
    y, info = at.dmap_embed(x, dim=3, alfa=0.5, beta=-0.1, nbng=8)
    assert y.shape == (240, 3)
    assert np.isfinite(y).all()


def test_dmap_embed_layer(rng):
    x = blobs(rng, n_per=100)
    y, info = at.dmap_embed(x, dim=2, nbng=8, layer=1,
                            hierarchy_fraction=0.3)
    # hierarchical dmap embeds only the subsample (dmapembed.rs:415-422)
    assert y.shape[0] == info["nb_embedded"]
    assert 70 <= y.shape[0] <= 110


def test_cli_embed(tmp_path, rng):
    x = blobs(rng, n_per=40)
    p = tmp_path / "in.csv"
    np.savetxt(p, x, delimiter=",")
    out = tmp_path / "o.csv"
    res = subprocess.run(
        [sys.executable, "-m", "annembed_tpu.cli", "embed",
         "--csv", str(p), "--outfile", str(out), "--nbng", "5",
         "--batch", "3"],
        capture_output=True, text=True, timeout=300,
        env={"JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin",
             "PYTHONPATH": REPO_ROOT,
             "HOME": str(tmp_path)})
    assert res.returncode == 0, res.stderr[-2000:]
    info = json.loads(res.stdout.strip().split("\n")[-1])
    assert info["n"] == 120
    assert out.exists()


def test_cli_dmapembed(tmp_path, rng):
    x = blobs(rng, n_per=40)
    p = tmp_path / "in.csv"
    np.savetxt(p, x, delimiter=",")
    out = tmp_path / "o.csv"
    res = subprocess.run(
        [sys.executable, "-m", "annembed_tpu.cli", "dmapembed",
         "--csv", str(p), "--outfile", str(out), "--nbng", "8",
         "--alfa", "0.5", "--beta", "-0.1", "--dim", "3"],
        capture_output=True, text=True, timeout=300,
        env={"JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin",
             "PYTHONPATH": REPO_ROOT,
             "HOME": str(tmp_path)})
    assert res.returncode == 0, res.stderr[-2000:]
    info = json.loads(res.stdout.strip().split("\n")[-1])
    assert info["n"] == 120 and info["dim"] == 3
    assert out.exists()


def test_embed_params_not_mutated_and_sampled_csv_alignment(tmp_path, rng):
    """params= objects are copied (kwargs win for their six fields but
    the caller's instance is untouched); under quality sampling the
    first_dist/continuity_ratio dumps pair stats with the SAME rows of
    the embedding (q.sample_ids), not the first m rows."""
    from annembed_tpu.params import EmbedderParams
    x = blobs(rng, n_per=60)
    p = EmbedderParams(grad_factor=3, n_sub=7)
    out = tmp_path / "emb.csv"
    y, info = at.embed(x, outfile=str(out), dim=2, batch=5, nbng=6,
                       params=p, with_quality=True, quality_fraction=0.4,
                       quality_nbng=6)
    # caller's object untouched
    assert p.nb_grad_batch != 5 or EmbedderParams().nb_grad_batch == 5
    assert p.asked_dim == EmbedderParams().asked_dim
    assert p.grad_factor == 3 and p.n_sub == 7
    fd = np.loadtxt(tmp_path / "first_dist.csv", delimiter=",")
    m = fd.shape[0]
    assert m < x.shape[0]          # sampling actually active
    # each dumped row's coordinates must exist in the embedding; match
    # rows by coordinates and confirm they are not simply rows 0..m-1
    coords = fd[:, 1:3]
    dists = np.linalg.norm(coords[:, None, :] - y[None], axis=-1)
    matched_rows = dists.argmin(1)
    assert (dists.min(1) < 1e-4).all()
    assert not np.array_equal(matched_rows, np.arange(m))


def test_embed_crash_resume_caches(tmp_path, rng):
    """The 11M harness's crash-resume contract: an eager graph cache is
    written right after the build, the embedding checkpoint right
    after optimize; a second call resumes from BOTH (same results),
    and a stale embed cache from a different run errors loudly."""
    x = blobs(rng, n_per=50)
    gc = tmp_path / "gcache"
    ec = tmp_path / "ecache"
    y1, info1 = at.embed(x, dim=2, batch=4, nbng=6,
                         graph_cache=str(gc), graph_cache_eager=True,
                         embed_cache=str(ec))
    assert gc.exists() and ec.exists()
    # resume: loads both caches; embedding identical (it IS the cache)
    y2, info2 = at.embed(x, dim=2, batch=4, nbng=6,
                         graph_cache=str(gc), graph_cache_eager=True,
                         embed_cache=str(ec))
    np.testing.assert_allclose(y1, y2, rtol=1e-6)
    # stale cache (wrong n) rejected loudly
    import pytest
    with pytest.raises(ValueError, match="stale|shape"):
        at.embed(x[:100], dim=2, batch=4, nbng=6, embed_cache=str(ec))
