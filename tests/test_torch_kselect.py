"""loam_tpu_torch's knn_select (plain version, the CPU path of the
kselect CUDA kernel) against loam_tpu's Pallas kselect kernel (interpret
mode) and its lax.top_k reference.

Squared distances are held to 1e-6 absolute (the inputs are O(1), so
that is an ulp or two: XLA:CPU may contract the 3-wide sum).  Picked
coordinates must be equal wherever a neighbour exists (d2 < 1e29); with
fewer than k valid candidates the tail reads d2 >= 1e29, and its
coordinates are not part of the contract (the Pallas kernel and
lax.top_k differ there too).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loam_tpu.ops.pallas import kselect as JK

from loam_tpu_torch.ops.cuda import kselect as TK

from torch_parity import kselect_argsort, kselect_lattice_case

torch.set_num_threads(1)


def _case(Q, C, seed, frac_valid):
    """The generator of tests/test_pallas_kselect.py."""
    rng = np.random.default_rng(seed)
    cand = rng.normal(size=(Q, C, 3)).astype(np.float32)
    valid = rng.uniform(size=(Q, C)) < frac_valid
    q = rng.normal(size=(Q, 3)).astype(np.float32)
    return cand, valid, q


def _ties_case(Q, C, seed):
    """Candidates on a half-integer lattice around lattice queries (many
    exactly equal distances), the second half of each row a copy of the
    first (duplicated candidates, as when two of a query's 27 cells
    share a bucket)."""
    rng = np.random.default_rng(seed)
    half = rng.integers(-2, 3, size=(Q, C // 2, 3)).astype(np.float32) * 0.5
    cand = np.concatenate([half, half], 1)
    valid = rng.uniform(size=(Q, C)) < 0.8
    q = rng.integers(-1, 2, size=(Q, 3)).astype(np.float32) * 0.5
    return cand, valid, q


CASES = {
    "aligned": (lambda: _case(64, 96, 0, 0.7), 5, 32),
    "few_valid": (lambda: _case(16, 32, 0, 0.1), 8, 16),
    "unaligned": (lambda: _case(37, 130, 3, 0.7), 3, 32),
    "duplicates_and_ties": (lambda: _ties_case(48, 64, 5), 5, 16),
    # the dense cell's shapes (search_bucket_cap 48, knn_candidates 40):
    # its gather chunk (27 cells of 48) and its re-rank, few queries
    "dense_gather": (lambda: _case(16, 1296, 7, 0.6), 40, 16),
    "dense_rerank": (lambda: _case(64, 40, 8, 0.7), 5, 32),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_knn_select_plain_matches_pallas_and_top_k(name):
    make, k, tile_q = CASES[name]
    cand, valid, q = make()
    pts_t, d2_t = TK.knn_select(torch.tensor(cand), torch.tensor(valid),
                                torch.tensor(q), k)
    pts_t, d2_t = pts_t.numpy(), d2_t.numpy()
    assert pts_t.shape == (len(q), k, 3) and d2_t.shape == (len(q), k)
    jargs = (jnp.asarray(cand), jnp.asarray(valid), jnp.asarray(q), k)
    refs = {"pallas": JK.knn_select(*jargs, tile_q=tile_q, interpret=True),
            "top_k": JK.knn_select_reference(*jargs)}
    n_valid = valid.sum(1)
    for which, (pts_j, d2_j) in refs.items():
        pts_j, d2_j = np.asarray(pts_j), np.asarray(d2_j)
        found = d2_j < 1e29
        np.testing.assert_array_equal(d2_t < 1e29, found, err_msg=which)
        np.testing.assert_allclose(d2_t[found], d2_j[found], atol=1e-6,
                                   err_msg=which)
        np.testing.assert_array_equal(pts_t[found], pts_j[found],
                                      err_msg=which)
        assert (d2_t[~found] >= 1e29).all()
    # exactly min(k, valid candidates) neighbours a row, nearest first
    np.testing.assert_array_equal((d2_t < 1e29).sum(1),
                                  np.minimum(n_valid, k))
    assert (np.diff(d2_t, axis=1) >= 0).all()
    if name == "few_valid":
        assert (n_valid < k).any()
    if name == "duplicates_and_ties":
        live = np.where(d2_t < 1e29, d2_t, -1.0)
        assert (live[:, 1:] == live[:, :-1])[live[:, 1:] >= 0].any()


def test_knn_select_tail_rule_and_duplicates():
    """The port's own rule where the JAX formulations differ: k distinct
    indices in (distance, index) order, so a duplicated candidate is
    picked twice and the tail holds the lowest-index invalid entries."""
    cand = torch.tensor([[[9., 9, 9], [1, 0, 0], [7, 7, 7], [1, 0, 0],
                          [0, 2, 0], [5, 5, 5]]])
    valid = torch.tensor([[False, True, False, True, True, False]])
    q = torch.zeros(1, 3)
    pts, d2 = TK.knn_select_plain(cand, valid, q, 5)
    np.testing.assert_array_equal(d2.numpy(), np.array(
        [[1.0, 1.0, 4.0, 1e30, 1e30]], np.float32))
    np.testing.assert_array_equal(pts[0].numpy(), np.array(
        [[1, 0, 0], [1, 0, 0], [0, 2, 0], [9, 9, 9], [7, 7, 7]], np.float32))


def test_knn_select_cpu_runs_plain_and_limits_raise():
    cand, valid, q = (torch.tensor(a) for a in _case(8, 16, 1, 0.7))
    before = TK.knn_select.launches
    a = TK.knn_select(cand, valid, q, 4)
    b = TK.knn_select_plain(cand, valid, q, 4)
    assert TK.knn_select.launches == before   # no kernel on a CPU tensor
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    with pytest.raises(ValueError, match="k=17"):
        TK.knn_select(cand, valid, q, 17)            # k > C
    # k past 32 and C past 1024 run
    pts, d2 = TK.knn_select(torch.zeros(2, 1025, 3),
                            torch.ones(2, 1025, dtype=torch.bool),
                            torch.zeros(2, 3), 33)
    assert pts.shape == (2, 33, 3) and (d2 == 0).all()
    with pytest.raises(ValueError, match="C=17881"):
        TK.knn_select(torch.zeros(1, 17881, 3),
                      torch.ones(1, 17881, dtype=torch.bool),
                      torch.zeros(1, 3), 5)          # past MAX_C


@pytest.mark.parametrize("C,k", [(8, 5), (24, 5), (33, 5), (40, 5), (64, 5),
                                 (65, 5), (864, 24), (1296, 40)])
def test_knn_select_plain_lattice_matches_stable_argsort(C, k):
    """Lattice candidates (exact ties in every row) at the candidate
    counts the kernel treats differently: the picks are the first k of a
    stable argsort of the float32 distances, with rows of fewer than k
    valid candidates (lowest-index invalid ones in the tail) and rows of
    none (candidates 0..k-1 at 1e30)."""
    cand, valid, q = kselect_lattice_case(37, C, k)
    pts, d2 = TK.knn_select_plain(torch.tensor(cand), torch.tensor(valid),
                                  torch.tensor(q), k)
    want_pts, want_d2 = kselect_argsort(cand, valid, q, k)
    np.testing.assert_array_equal(d2.numpy(), want_d2)
    np.testing.assert_array_equal(pts.numpy(), want_pts)
    d2 = d2.numpy()
    n_valid = valid.sum(1)
    np.testing.assert_array_equal((d2 < 1e29).sum(1), np.minimum(n_valid, k))
    assert (n_valid[::5] < k).all() and (n_valid[::11] == 0).all()
    np.testing.assert_array_equal(pts.numpy()[::11], cand[::11, :k])
    assert ((d2[:, 1:] == d2[:, :-1]) & (d2[:, 1:] < 1e29)).sum() > 10
