"""2-NN matching (ops/distance.py) against a NumPy brute-force oracle, for
both L1 strategies: "exact" (every pair) and "l2pre" (matmul candidate
prefilter + exact-L1 rescore)."""
import numpy as np
import pytest

from computervisionimagestich2_tpu.ops import distance

BIG = distance.BIG


def oracle_two_nearest(qry, ref, qv, rv):
    """Brute-force L1 2-NN in float64: (d1, d2, i1), invalid references
    never win, invalid queries get BIG."""
    d = np.abs(qry[:, None, :].astype(np.float64)
               - ref[None, :, :].astype(np.float64)).sum(-1)
    d[:, ~rv] = np.inf
    i1 = np.argmin(d, axis=1)
    d1 = d[np.arange(len(qry)), i1]
    d2 = np.sort(d, axis=1)[:, 1]
    d1 = np.where(qv, d1, BIG)
    d2 = np.where(qv, d2, BIG)
    return d1, d2, i1


def clustered(rng, nq, nr, f=128, noise=0.05, live=None):
    """Queries that are noisy copies of reference rows (so nearest
    neighbours are unambiguous, as for real SIFT matches) plus unrelated
    queries."""
    ref = np.abs(rng.normal(size=(nr, f))).astype(np.float32)
    pick = rng.integers(0, live or nr, nq)
    qry = ref[pick] + rng.normal(size=(nq, f)).astype(np.float32) * noise
    qry[nq // 2:] = np.abs(rng.normal(size=(nq - nq // 2, f)))
    return qry.astype(np.float32), ref


METHODS = ["exact", "l2pre"]


@pytest.mark.parametrize("method", METHODS)
def test_two_nearest_matches_oracle(rng, method):
    qry, ref = clustered(rng, 200, 300)
    qv = np.ones(200, bool)
    rv = np.ones(300, bool)
    rv[100:120] = False
    d1, d2, i1 = (np.asarray(a) for a in distance.two_nearest(
        qry, ref, qv, rv, "l1", method, 32))
    e1, e2, ei = oracle_two_nearest(qry, ref, qv, rv)
    # l2pre's distances are the best among its m L2 candidates: the
    # nearest is exact for the unambiguous (noisy-copy) half, and both
    # distances are upper bounds everywhere
    n_exact = 200 if method == "exact" else 100
    np.testing.assert_allclose(d1[:n_exact], e1[:n_exact], rtol=1e-5)
    np.testing.assert_array_equal(i1[:n_exact], ei[:n_exact])
    if method == "exact":
        np.testing.assert_allclose(d2, e2, rtol=1e-5)
    assert np.all(d1 >= e1 * (1 - 1e-5)) and np.all(d2 >= e2 * (1 - 1e-5))


@pytest.mark.parametrize("method", METHODS)
def test_two_nearest_invalid_queries(rng, method):
    qry, ref = clustered(rng, 128, 256, f=64)
    qv = np.zeros(128, bool)
    qv[:10] = True
    rv = np.ones(256, bool)
    d1, d2, i1 = distance.two_nearest(qry, ref, qv, rv, "l1", method, 16)
    assert np.all(np.asarray(d1)[10:] >= BIG)
    assert np.all(np.asarray(d2)[10:] >= BIG)
    e1, _, ei = oracle_two_nearest(qry, ref, qv, rv)
    np.testing.assert_array_equal(np.asarray(i1)[:10], ei[:10])
    ok, _ = distance.ratio_match(qry, ref, qv, rv, 0.5, "l1", method, 16)
    assert not np.asarray(ok)[10:].any()


@pytest.mark.parametrize("method", METHODS)
def test_two_nearest_live_prefix(rng, method):
    """Prefix-compacted masks (the sift_extract contract): only the live
    prefix of references may win, dead queries report BIG."""
    qry, ref = clustered(rng, 256, 512, live=200)
    qv = np.arange(256) < 130
    rv = np.arange(512) < 200
    d1, d2, i1 = (np.asarray(a) for a in distance.two_nearest(
        qry, ref, qv, rv, "l1", method, 32))
    e1, e2, ei = oracle_two_nearest(qry, ref, qv, rv)
    assert np.all(i1[:130] < 200)
    # the first 128 queries are noisy copies of live references, which
    # both strategies resolve exactly; the rest only "exact" must
    sure = qv & ((np.arange(256) < 128) | (method == "exact"))
    np.testing.assert_allclose(d1[sure], e1[sure], rtol=1e-5)
    np.testing.assert_array_equal(i1[sure], ei[sure])
    assert np.all(d1[130:] >= BIG)


def test_xla_bidir_matches_two_directed_calls(rng):
    """two_nearest_bidir equals the two directed two_nearest calls (both
    L1 and L2, odd shapes) up to f32 reduction-order ulps (XLA may
    reassociate the feature reduce differently for the two matrix
    orientations); indices must agree wherever the nearest distance is
    not an ulp-tie."""
    nb, na, f = 90, 70, 32
    qry = rng.normal(size=(nb, f)).astype(np.float32)
    ref = rng.normal(size=(na, f)).astype(np.float32)
    qv = np.arange(nb) < 75
    rv = np.arange(na) < 60
    for metric in ("l1", "l2"):
        fwd, bwd = distance.two_nearest_bidir(qry, ref, qv, rv, metric)
        ref_f = distance.two_nearest(qry, ref, qv, rv, metric)
        ref_b = distance.two_nearest(ref, qry, rv, qv, metric)
        for got, want in ((fwd, ref_f), (bwd, ref_b)):
            d1g, d2g = np.asarray(got[0]), np.asarray(got[1])
            d1w, d2w = np.asarray(want[0]), np.asarray(want[1])
            np.testing.assert_allclose(d1g, d1w, rtol=1e-5)
            np.testing.assert_allclose(d2g, d2w, rtol=1e-5)
            live = d1w < 1e37
            clear = live & (d2w > d1w * (1 + 1e-4))  # not an ulp-tie
            np.testing.assert_array_equal(np.asarray(got[2])[clear],
                                          np.asarray(want[2])[clear])


def test_pair_match_counts_match_oracle(rng):
    """all_pairs_match_counts over the whole i<j triangle equals the
    oracle's Lowe-ratio counts in both directions."""
    import dataclasses

    from computervisionimagestich2_tpu.config import DEFAULT_CONFIG
    from computervisionimagestich2_tpu.models.registration import (
        all_pairs_match_counts)

    n, cap, f = 4, 256, 128
    desc = rng.random(size=(n, cap, f)).astype(np.float32)
    # clustered descriptors so some ratio tests actually pass
    desc[1, :50] = desc[0, 10:60] + rng.normal(size=(50, f)) * 1e-3
    desc[3, :40] = desc[2, 5:45] + rng.normal(size=(40, f)) * 1e-3
    lives = [200, 130, 256, 77]
    valid = np.stack([np.arange(cap) < nv for nv in lives])
    cfg = dataclasses.replace(DEFAULT_CONFIG)
    got = np.asarray(all_pairs_match_counts(desc, valid, cfg))
    for i in range(n):
        for j in range(n):
            if i == j:
                assert got[i, j] == 0
                continue
            d1, d2, _ = oracle_two_nearest(desc[j], desc[i], valid[j],
                                           valid[i])
            want = int(((d1 / d2 < 0.5) & valid[j] & (d2 < BIG)).sum())
            assert got[i, j] == want, (i, j, got[i, j], want)
