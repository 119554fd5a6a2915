"""Place recognition of the port against the JAX package: the vocabulary, the
keyframe database, the covisibility matrix and `LoopCloser.detect`.

Small sizes (the shipped 4096-word codebook or a seeded one, 16-32
keyframes); every input comes from a numpy seed and goes through both
packages.  Word ids, BoW counts, refined codebooks, covisibility counts and
candidate lists must be identical; TF-IDF scores agree within 1e-5 relative
(the port folds the IDF weights into the query vector and sums in another
order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity_helpers as H
from orbslam3_tpu.features.extractor import FeatureFrame as JFF
from orbslam3_tpu.pipeline import loop_closing as jloop
from orbslam3_tpu.place import keyframe_db as jkdb
from orbslam3_tpu.place import vocab as jvocab
from orbslam3_tpu.slam_map import state as jstate
from orbslam3_tpu_torch.pipeline import loop_closing as tloop
from orbslam3_tpu_torch.place import keyframe_db as tkdb
from orbslam3_tpu_torch.place import vocab as tvocab
from orbslam3_tpu_torch.slam_map import convert
from orbslam3_tpu_torch.slam_map import state as tstate

torch.set_num_threads(2)

V = 4096


def _descs(rng, n, codebook=None, flips=6):
    """n descriptors: random ones, or anchors of `codebook` with a few bits
    flipped (so that words repeat and the argmin is not a lottery)."""
    if codebook is None:
        return rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)
    d = codebook[rng.integers(0, codebook.shape[0], n)].copy()
    for _ in range(flips):
        d[np.arange(n), rng.integers(0, 8, n)] ^= np.uint32(1) << rng.integers(0, 32, n).astype(np.uint32)
    return d


def _t(a):
    return convert._tensor(a, "cpu")


def test_codebooks_are_the_jax_package_s():
    np.testing.assert_array_equal(tvocab.seed_codebook(2048), jvocab.seed_codebook(2048))
    np.testing.assert_array_equal(tvocab.load_codebook(V), jvocab.load_codebook(V))
    np.testing.assert_array_equal(tvocab.load_codebook(V, prefer_trained=False),
                                  jvocab.seed_codebook(V))
    # no codebook of this size is shipped: the seeded one
    np.testing.assert_array_equal(tvocab.load_codebook(512), jvocab.load_codebook(512))
    cb = tvocab.codebook_tensor(tvocab.load_codebook(V))
    assert cb.dtype == torch.int32 and cb.shape == (V, 8)
    np.testing.assert_array_equal(cb.numpy().view(np.uint32), jvocab.load_codebook(V))


@pytest.mark.parametrize("near_anchors", [False, True])
def test_assign_words_and_bow_vector_match_jax(near_anchors):
    """Word ids identical; the BoW vector identical (counts are exact, one
    division)."""
    rng = np.random.default_rng(1)
    cb = jvocab.load_codebook(V)
    d = _descs(rng, 500, cb if near_anchors else None)
    valid = rng.random(500) > 0.2
    wj = np.asarray(jvocab.assign_words(jnp.asarray(d), jnp.asarray(cb)))
    cbt = convert.codebook_from_numpy(cb)
    wt = tvocab.assign_words(_t(d), cbt)
    np.testing.assert_array_equal(wt.numpy(), wj)
    # the unpacked codebook, made once, gives the same
    np.testing.assert_array_equal(
        tvocab.assign_words(_t(d), tvocab.unpack_codebook(cbt)).numpy(), wj)
    bj = np.asarray(jvocab.bow_vector(jnp.asarray(wj), jnp.asarray(valid), V))
    bt = tvocab.bow_vector(wt, torch.from_numpy(valid), V).numpy()
    np.testing.assert_array_equal(bt, bj)
    if near_anchors:
        assert np.unique(wj).size < 500          # words repeat: the scatter adds


def test_assign_words_sends_a_distance_tie_to_the_lowest_word():
    """Two identical anchors, and a descriptor exactly between two anchors:
    the lower word wins in both packages."""
    rng = np.random.default_rng(2)
    cb = jvocab.seed_codebook(256).copy()
    cb[40] = cb[17]                               # duplicates: distance 0 twice
    cb[200] = cb[90]
    cb[200, 0] ^= np.uint32(0b11)                 # anchors 90 and 200 differ in 2 bits
    d = np.stack([cb[17], cb[40], cb[90] ^ np.array([1, 0, 0, 0, 0, 0, 0, 0], np.uint32)])
    wj = np.asarray(jvocab.assign_words(jnp.asarray(d), jnp.asarray(cb)))
    wt = tvocab.assign_words(_t(d), convert.codebook_from_numpy(cb)).numpy()
    np.testing.assert_array_equal(wt, wj)
    np.testing.assert_array_equal(wt, [17, 17, 90])


def test_assign_words_chunked_matches_jax():
    rng = np.random.default_rng(3)
    cb = jvocab.seed_codebook(512)
    d = _descs(rng, 700)
    wj = np.asarray(jvocab.assign_words_chunked(jnp.asarray(d), jnp.asarray(cb), chunk=256))
    wt = tvocab.assign_words_chunked(_t(d), convert.codebook_from_numpy(cb), chunk=256)
    assert wt.shape == (700,)
    np.testing.assert_array_equal(wt.numpy(), wj)


def test_kmeans_refine_matches_jax():
    """Identical refined codebooks: counts and bit sums are exact integers."""
    rng = np.random.default_rng(4)
    cb = jvocab.seed_codebook(512)
    d = _descs(rng, 3000, cb, flips=40)
    valid = rng.random(3000) > 0.1
    rj = np.asarray(jvocab.kmeans_refine(jnp.asarray(cb), jnp.asarray(d), jnp.asarray(valid),
                                         iters=2))
    rt = tvocab.kmeans_refine(convert.codebook_from_numpy(cb), _t(d), torch.from_numpy(valid),
                              iters=2)
    np.testing.assert_array_equal(rt.numpy().view(np.uint32), rj)
    assert (rj != cb).any() and (rj == cb).all(axis=1).any()   # some moved, some kept


def _filled_dbs(rng, K=16, n_kf=10, twins=()):
    """A database of `n_kf` keyframes in both packages; keyframe b of each
    pair in `twins` gets keyframe a's BoW vector."""
    cb = jvocab.load_codebook(V)
    cbj, cbt = jnp.asarray(cb), convert.codebook_from_numpy(cb)
    dbj, dbt = jkdb.KeyframeDB.create(K, V), tkdb.KeyframeDB.create(K, V, "cpu")
    places = [_descs(rng, 300, cb) for _ in range(n_kf)]
    for a, b in twins:
        places[b] = places[a]
    for k, d in enumerate(places):
        d = d.copy()
        d[:100] = places[max(k - 1, 0)][:100]     # neighbours share words
        valid = np.ones(300, bool)
        bj = jvocab.bow_vector(jvocab.assign_words(jnp.asarray(d), cbj), jnp.asarray(valid), V)
        bt = tvocab.bow_vector(tvocab.assign_words(_t(d), cbt), torch.from_numpy(valid), V)
        dbj, dbt = jkdb.add(dbj, k, bj), tkdb.add(dbt, k, bt)
        places[k] = d
    return dbj, dbt, places, cbj, cbt


def _same_db(dbj, dbt):
    for name in ("tf", "has_word", "active"):
        np.testing.assert_array_equal(getattr(dbt, name).numpy(), np.asarray(getattr(dbj, name)),
                                      err_msg=name)


def test_keyframe_db_add_erase_clear_match_jax():
    rng = np.random.default_rng(5)
    dbj, dbt, *_ = _filled_dbs(rng)
    _same_db(dbj, dbt)
    assert dbt.nbytes == 16 * V * 5 + 16
    before = dbt
    dbj, dbt = jkdb.erase(dbj, 3), tkdb.erase(dbt, torch.tensor(3))
    _same_db(dbj, dbt)
    assert bool(before.active[3]) and not bool(dbt.active[3])   # the input is untouched
    _same_db(convert.db_from_numpy(H.fields(dbj)), dbt)
    _same_db(jkdb.clear(dbj), tkdb.clear(dbt))


@pytest.mark.parametrize("with_exclude", [False, True])
def test_query_matches_jax(with_exclude):
    """Scores within 1e-5 relative, masked keyframes at -1 on both sides,
    common-word counts identical."""
    rng = np.random.default_rng(6)
    dbj, dbt, places, cbj, cbt = _filled_dbs(rng)
    dbj, dbt = jkdb.erase(dbj, 2), tkdb.erase(dbt, 2)
    d = places[4].copy()
    d[150:] = _descs(rng, 150)
    valid = rng.random(300) > 0.1
    bj = jvocab.bow_vector(jvocab.assign_words(jnp.asarray(d), cbj), jnp.asarray(valid), V)
    bt = tvocab.bow_vector(tvocab.assign_words(_t(d), cbt), torch.from_numpy(valid), V)
    excl = np.zeros(16, bool)
    excl[[5, 6]] = with_exclude
    sj, cj = jkdb.query(dbj, bj, jnp.asarray(excl) if with_exclude else None)
    st, ct = tkdb.query(dbt, bt, torch.from_numpy(excl) if with_exclude else None)
    sj = np.asarray(sj)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(st.numpy() < 0, sj < 0)
    np.testing.assert_allclose(st.numpy(), sj, rtol=1e-5)
    assert sj[2] == -1 and (sj[10:] == -1).all() and int(np.argmax(sj)) == 4
    np.testing.assert_allclose(tkdb.idf_weights(dbt).numpy(), np.asarray(jkdb.idf_weights(dbj)),
                               rtol=1e-6)


def test_detect_candidates_matches_jax_with_a_tied_group_score():
    """The same candidates and scores within 1e-5 relative; keyframes 1 and 7
    hold the same BoW vector and are covisible with nothing, so their group
    scores tie exactly and the lower index must come first (T2)."""
    rng = np.random.default_rng(7)
    dbj, dbt, places, cbj, cbt = _filled_dbs(rng, n_kf=12, twins=[(1, 7)])
    # re-register both with one and the same vector
    d1 = places[1]
    ones = np.ones(300, bool)
    bj1 = jvocab.bow_vector(jvocab.assign_words(jnp.asarray(d1), cbj), jnp.asarray(ones), V)
    bt1 = tvocab.bow_vector(tvocab.assign_words(_t(d1), cbt), torch.from_numpy(ones), V)
    for k in (1, 7):
        dbj, dbt = jkdb.add(dbj, k, bj1), tkdb.add(dbt, k, bt1)
    covis = np.zeros((16, 16), bool)
    covis[3, 4] = covis[4, 3] = covis[4, 5] = covis[5, 4] = True
    excl = np.zeros(16, bool)
    excl[10:] = True
    ci, cs = jkdb.detect_candidates(dbj, bj1, jnp.asarray(excl), jnp.asarray(covis), n_best=3)
    ti, ts = tkdb.detect_candidates(dbt, bt1, torch.from_numpy(excl), torch.from_numpy(covis),
                                    n_best=3)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ci))
    np.testing.assert_allclose(ts.numpy(), np.asarray(cs), rtol=1e-5)
    assert list(ti.numpy()[:2]) == [1, 7] and ts[0] == ts[1]


def _random_incidence_maps(rng, cap_j, cap_t, n_kf):
    """An empty map in both packages with a random incidence, some dead
    points and one dead keyframe."""
    P, K = cap_t.n_pt, cap_t.n_kf
    mask = np.zeros((P, K), bool)
    for k in range(n_kf):
        lo = (P // (n_kf + 4)) * k
        mask[lo:lo + P // 6, k] = rng.random(min(P // 6, P - lo)) > 0.3
    pt_valid = rng.random(P) > 0.1
    kf_valid = np.arange(K) < n_kf
    kf_valid[2] = False
    mj = jstate.empty_map(cap_j)._replace(
        pt_kf_mask=jnp.asarray(mask), pt_valid=jnp.asarray(pt_valid),
        kf_valid=jnp.asarray(kf_valid), n_kf=jnp.asarray(n_kf, jnp.int32))
    mt = tstate.empty_map(cap_t)._replace(
        pt_kf_mask=torch.from_numpy(mask), pt_valid=torch.from_numpy(pt_valid),
        kf_valid=torch.from_numpy(kf_valid), n_kf=torch.tensor(n_kf, dtype=torch.int32))
    return mj, mt


@pytest.mark.parametrize("dense", [True, False])
def test_covisibility_matrix_matches_jax(dense):
    """Exact: the counts are integers.  Dense, and chunked with a last block
    that is not full."""
    rng = np.random.default_rng(8)
    cap = dict(n_kf=16, n_pt=3000, n_obs=64)
    mj, mt = _random_incidence_maps(rng, jstate.MapCapacity(**cap), tstate.MapCapacity(**cap), 12)
    kw = {} if dense else dict(chunk=512, dense_max_entries=1024)
    Wj = np.asarray(jstate.covisibility_matrix(mj, **kw))
    Wt = tstate.covisibility_matrix(mt, **kw)
    np.testing.assert_array_equal(Wt.numpy(), Wj)
    assert Wj.max() > 100 and (Wj[2] == 0).all()
    # a row of it is covisibility_weights, but for the diagonal
    row = tstate.covisibility_weights(mt, 5).numpy()
    np.testing.assert_array_equal(np.delete(row, 5), np.delete(Wj[5], 5).astype(np.int32))


def test_loop_closer_detect_matches_jax_over_a_keyframe_sequence():
    """28 keyframes: 20 along a path, then 8 that revisit the places of
    keyframes 2-9 with new map points.  Both `LoopCloser`s (4096 words) see
    every keyframe from the 12th on: `detect`, then `add_keyframe`.  The
    accepted candidates, the consistency groups and their counts must be
    identical at every keyframe, and the revisit must be accepted once the
    chain is long enough.  Compared as sets: the members of a covisibility
    clique all get the same group score in exact arithmetic (each one's own
    score plus all the others'), so their order among the top 3 hangs on the
    last float bit of sums taken in another order (seen here: 0.00209279731
    against 0.00209279708)."""
    rng = np.random.default_rng(9)
    K, P, N = 32, 4096, 256
    cb = jvocab.load_codebook(V)
    n_kf = 28
    place = list(range(20)) + list(range(2, 10))
    fam = _descs(rng, 20 * 64 + N, cb)             # place p: descriptors [64 p, 64 p + N)
    mask = np.zeros((P, K), bool)
    for k in range(n_kf):                         # keyframe k sees points [100 k, 100 k + 400)
        mask[100 * k:100 * k + 400, k] = True
    cap = dict(n_kf=K, n_pt=P, n_obs=64)
    mj = jstate.empty_map(jstate.MapCapacity(**cap))._replace(
        pt_kf_mask=jnp.asarray(mask), pt_valid=jnp.ones(P, bool),
        kf_valid=jnp.asarray(np.arange(K) < n_kf), n_kf=jnp.asarray(n_kf, jnp.int32))
    mt = tstate.empty_map(tstate.MapCapacity(**cap))._replace(
        pt_kf_mask=torch.from_numpy(mask), pt_valid=torch.ones(P, dtype=torch.bool),
        kf_valid=torch.from_numpy(np.arange(K) < n_kf),
        n_kf=torch.tensor(n_kf, dtype=torch.int32))
    lcj = jloop.LoopCloser(jloop.LoopConfig(n_words=V), K)
    lct = tloop.LoopCloser(tloop.LoopConfig(n_words=V), K, "cpu")
    np.testing.assert_array_equal(lct.codebook.numpy().view(np.uint32), np.asarray(lcj.codebook))
    accepted_any = []
    for k in range(n_kf):
        d = fam[64 * place[k]:64 * place[k] + N].copy()
        d[np.arange(N), rng.integers(0, 8, N)] ^= np.uint32(1) << rng.integers(0, 32, N).astype(np.uint32)
        f = dict(xy=np.zeros((N, 2), np.float32), response=np.ones(N, np.float32),
                 octave=np.zeros(N, np.int32), angle=np.zeros(N, np.float32), desc=d,
                 valid=rng.random(N) > 0.05)
        ffj = JFF(**{n: jnp.asarray(v) for n, v in f.items()})
        fft = convert.frame_from_numpy(f)
        if k >= 12:
            aj = lcj.detect(mj, k, ffj)
            at = lct.detect(mt, k, fft)
            assert sorted(at) == sorted(aj), k
            assert len(lct.consistent_groups) == len(lcj.consistent_groups), k
            key = lambda g: (g[0].tobytes(), g[1])
            for (gt, ct), (gj, cj) in zip(sorted(lct.consistent_groups, key=key),
                                          sorted(lcj.consistent_groups, key=key)):
                assert ct == cj
                np.testing.assert_array_equal(gt, gj)
            accepted_any += at
        lcj.add_keyframe(mj, k, ffj)
        lct.add_keyframe(mt, torch.tensor(k), fft)
    _same_db(lcj.db, lct.db)
    assert accepted_any and set(accepted_any) <= set(range(0, 12))


def test_refine_vocab_reencodes_the_database_as_jax_does():
    rng = np.random.default_rng(10)
    K, N = 8, 200
    lcj = jloop.LoopCloser(jloop.LoopConfig(n_words=512, vocab="seed"), K)
    lct = tloop.LoopCloser(tloop.LoopConfig(n_words=512, vocab="seed"), K, "cpu")
    feats_j, feats_t = {}, {}
    for k in range(4):
        f = dict(xy=np.zeros((N, 2), np.float32), response=np.ones(N, np.float32),
                 octave=np.zeros(N, np.int32), angle=np.zeros(N, np.float32),
                 desc=_descs(rng, N), valid=rng.random(N) > 0.1)
        feats_j[k] = JFF(**{n: jnp.asarray(v) for n, v in f.items()})
        feats_t[k] = convert.frame_from_numpy(f)
        lcj.add_keyframe(None, k, feats_j[k])
        lct.add_keyframe(None, k, feats_t[k])
    lcj.refine_vocab(feats_j, iters=2)
    lct.refine_vocab(feats_t, iters=2)
    np.testing.assert_array_equal(lct.codebook.numpy().view(np.uint32), np.asarray(lcj.codebook))
    _same_db(lcj.db, lct.db)
    # the unpacked copy follows the codebook
    wj = np.asarray(lcj._bow(feats_j[0].desc, feats_j[0].valid)[1])
    np.testing.assert_array_equal(lct._bow(feats_t[0].desc, feats_t[0].valid)[1].numpy(), wj)
