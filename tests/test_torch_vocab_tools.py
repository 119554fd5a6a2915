"""The port's vocabulary tools against `tools/train_vocab.py` and
`tools/vocab_recall_curve.py`.

`train_vocab --stage kmeans` on one descriptor file: the port's codebook and
its word-entropy line equal JAX's `_finish` (JAX's `np.save` into its own
package is caught and written nowhere); the port writes nothing under
`orbslam3_tpu/`.  The recall table's rows from the same descriptors through
both packages (`RECALL_PLACES=8`, sizes 4 and 8, vocabulary 4096): the same
recall@1 and recall@3, margins within 1e-6 (the port scores tf . (bow idf^2),
JAX (tf idf) . (bow idf): the same sums in another float32 order).  Each
tool's `main` on the CPU at a cut size prints the JAX tool's lines, and
refuses a card that is not there.
"""

import importlib.util
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam3_tpu.place import keyframe_db as jkdb
from orbslam3_tpu.place import vocab as jvocab
from orbslam3_tpu.utils import synth_render as jsr
from orbslam3_tpu_torch.features import extractor as tx
from orbslam3_tpu_torch.ops import orb_patches
from orbslam3_tpu_torch.tools import train_vocab, vocab_recall_curve

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(REPO, "orbslam3_tpu")


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _listing(root):
    return {os.path.join(d, f): os.stat(os.path.join(d, f)).st_mtime_ns
            for d, _, fs in os.walk(root) if "__pycache__" not in d for f in fs}


@pytest.fixture(scope="module")
def desc_file(tmp_path_factory):
    """Two views' descriptors, written by the port's `--stage extract` in
    JAX's layout (uint32)."""
    path = str(tmp_path_factory.mktemp("vocab") / "descs.npz")
    before = _listing(JAX_PKG)
    assert train_vocab.main(["--stage", "extract", "--n-views", "2", "--desc-file", path,
                             "--device", "cpu"]) is None
    assert _listing(JAX_PKG) == before
    return path


def test_extract_stage_writes_jax_layout(desc_file, capsys):
    d = np.load(desc_file)
    assert d["desc"].dtype == np.uint32 and d["desc"].shape == (1600, 8)
    assert d["valid"].dtype == bool and int(d["valid"].sum()) > 1000


def test_kmeans_stage_matches_jax_finish(desc_file, tmp_path, capsys, monkeypatch):
    n_words = 256
    out = str(tmp_path / "cb.npy")
    before = _listing(JAX_PKG)
    cb = train_vocab.main(["--stage", "kmeans", "--n-words", str(n_words), "--desc-file",
                           desc_file, "--out", out, "--device", "cpu"])
    line_t = capsys.readouterr().out.splitlines()[-1]
    assert _listing(JAX_PKG) == before
    np.testing.assert_array_equal(np.load(out), cb)
    assert cb.dtype == np.uint32 and cb.shape == (n_words, 8)

    saved = {}
    monkeypatch.setattr(np, "save", lambda path, arr: saved.update(path=path, arr=arr))
    data = np.load(desc_file)
    _jax_tool("train_vocab")._finish(n_words, jnp.asarray(data["desc"]),
                                     jnp.asarray(data["valid"]), jvocab, jnp)
    line_j = capsys.readouterr().out.splitlines()[-1]
    monkeypatch.undo()
    assert saved["path"].endswith(os.path.join("orbslam3_tpu", "data", "vocab_256.npy"))
    np.testing.assert_array_equal(cb, np.asarray(saved["arr"]))
    tail = lambda s: s.split("; ", 1)[1]
    assert tail(line_t) == tail(line_j), (line_t, line_j)
    assert re.fullmatch(r"word entropy \d+\.\d\d bits \(max 8\.00\), used \d+ words",
                        tail(line_t))


def test_train_vocab_all_stages_at_a_cut_size(capsys):
    """The whole tool at 2 views and 64 words with the default `--out`: the
    codebook goes to the port's build directory, never under the JAX
    package's data."""
    before = _listing(JAX_PKG)
    cb = train_vocab.main(["--n-views", "2", "--n-words", "64", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert _listing(JAX_PKG) == before
    assert lines[0] == "device: cpu"
    assert lines[1] == "view 0: 800 descriptors"
    assert lines[2].startswith("total descriptors: ")
    path = re.match(r"saved (.+); word entropy", lines[3]).group(1)
    try:
        assert os.path.abspath(path) == os.path.join(REPO, "orbslam3_tpu_torch", "build",
                                                     "vocab_64.npy")
        np.testing.assert_array_equal(np.load(path), cb)
    finally:
        os.remove(path)


def _images_fed(monkeypatch, fn) -> list:
    """The images that fn() hands the port's `extract`, each extracted at a
    cut size (64 features, 2 levels)."""
    imgs = []
    real = tx.extract

    def spy(img, p):
        imgs.append(img.numpy().copy())
        return real(img, tx.OrbParams(n_features=64, n_levels=2))

    monkeypatch.setattr(tx, "extract", spy)
    fn()
    monkeypatch.setattr(tx, "extract", real)
    return imgs


def test_train_vocab_renders_the_jax_tools_views(monkeypatch):
    """The views of `tools/train_vocab.py:45-73`, rendered by the JAX
    package (its `render_plane` puts the default mesas in the scene): the
    port's extraction stage gets the same images, bit for bit."""
    n_views = 3
    rng = np.random.default_rng(0)
    K4 = np.asarray([458.654, 457.296, 367.215, 248.375], np.float32)
    ref = []
    for i in range(n_views):
        if i % 12 == 0:
            tex = jsr.block_texture(rng, block=int(rng.integers(5, 12)))
        R_cw, t_cw = jsr.look_down_pose(
            float(rng.uniform(0, 8)), float(rng.uniform(0, 8)),
            float(rng.uniform(3, 7)), yaw=float(rng.uniform(0, 6.28)),
            tilt=float(rng.uniform(-0.25, 0.25)))
        img = jsr.render_plane(R_cw, t_cw, K4, (480, 752), tex)
        img += rng.normal(0, 2.0, img.shape).astype(np.float32)
        ref.append(np.clip(img, 0, 255))
    got = _images_fed(monkeypatch, lambda: train_vocab.extract_descriptors(n_views, 0, "cpu"))
    assert len(got) == n_views
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


def test_recall_curve_renders_the_jax_tools_places(monkeypatch):
    """The nominal and stressed views of `tools/vocab_recall_curve.py:45-89`
    (the default mesas in the scene) at 3 places: the port's
    `make_descriptors` extracts the same images, bit for bit."""
    n_places, n_pool = 3, 8
    rng = np.random.default_rng(11)
    K4 = np.asarray([458.654, 457.296, 367.215, 248.375], np.float32)
    hw = (480, 752)
    pool = []
    for _ in range(max(n_pool // 4, 1)):
        pool.append(jsr.block_texture(rng, block=int(rng.integers(6, 11))))
        pool.append(jsr.voronoi_texture(rng, n_seeds=int(rng.integers(200, 420))))
        pool.append(jsr.stripe_texture(rng))
        pool.append(jsr.blob_texture(rng))
    ref = []
    for k in range(n_places):
        tex = pool[k % len(pool)]
        x, y = float(rng.uniform(0, 14)), float(rng.uniform(0, 14))
        z = float(rng.uniform(4, 6))
        yaw = float(rng.uniform(0, 6.28))
        img = jsr.render_plane(*jsr.look_down_pose(x, y, z, yaw=yaw), K4, hw, tex)
        ref.append(np.clip(img + rng.normal(0, 1.5, img.shape), 0, 255).astype(np.uint8))
        img_q = jsr.render_plane(
            *jsr.look_down_pose(x + float(rng.uniform(-0.2, 0.2)),
                                y + float(rng.uniform(-0.2, 0.2)),
                                z * float(rng.uniform(0.97, 1.03)),
                                yaw=yaw + float(rng.uniform(-0.1, 0.1))),
            K4, hw, tex)
        img_q = jsr.photometric_stress(
            img_q, exposure=float(rng.uniform(0.7, 1.3)),
            gamma=float(rng.uniform(0.9, 1.12)), vignette=0.3, noise=4.0, rng=rng)
        ref.append(np.clip(img_q, 0, 255).astype(np.uint8))
    got = _images_fed(monkeypatch,
                      lambda: vocab_recall_curve.make_descriptors(n_places, n_pool, "cpu"))
    assert len(got) == 2 * n_places
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


def jax_recall_rows(desc, vocabs, sizes):
    """The JAX tool's rows (vocab_recall_curve.py:108-137) from the given
    descriptors."""
    rows = []
    for V in vocabs:
        cb = jnp.asarray(jvocab.load_codebook(V, prefer_trained=True))

        def bow(d, v, cb=cb, V=V):
            return jvocab.bow_vector(jvocab.assign_words(d, cb), v, V)

        u32 = lambda d: jnp.asarray(np.ascontiguousarray(d).view(np.uint32))
        bows_db = [bow(u32(d), jnp.asarray(v)) for d, v in zip(desc["db_desc"], desc["db_valid"])]
        bows_q = [bow(u32(d), jnp.asarray(v)) for d, v in zip(desc["q_desc"], desc["q_valid"])]
        for M in sizes:
            db = jkdb.KeyframeDB.create(M, V)
            for k in range(M):
                db = jkdb.add(db, k, bows_db[k])
            r1 = r3 = 0
            margins = []
            for k in range(M):
                scores, _ = jkdb.query(db, bows_q[k])
                s = np.asarray(scores)
                order = np.argsort(-s)
                rank = int(np.where(order == k)[0][0])
                r1 += rank == 0
                r3 += rank < 3
                imp = np.delete(s, k)
                margins.append(float(s[k] - imp.max()))
            rows.append((V, M, r1 / M, r3 / M, np.mean(margins)))
    return rows


@pytest.fixture(scope="module")
def places():
    """8 places' descriptors, through the port's `make_descriptors` on the
    CPU (JAX's pool size at 8 places)."""
    return vocab_recall_curve.make_descriptors(8, 8, "cpu")


def test_recall_rows_from_the_same_descriptors_match_jax(places):
    got = vocab_recall_curve.recall_rows(places, (4096,), (4, 8), "cpu", echo=False)
    ref = jax_recall_rows(places, (4096,), (4, 8))
    assert [r[:4] for r in got] == [r[:4] for r in ref]
    np.testing.assert_allclose([r[4] for r in got], [r[4] for r in ref], atol=1e-6, rtol=0)


def test_make_descriptors_shapes(places):
    assert places["db_desc"].shape == places["q_desc"].shape == (8, 800, 8)
    assert places["db_desc"].dtype == np.int32 and places["db_valid"].dtype == bool
    assert int(places["q_valid"].sum()) > 8 * 400


def test_recall_curve_main_at_a_cut_size(capsys, monkeypatch):
    monkeypatch.setenv("RECALL_PLACES", "3")
    monkeypatch.setenv("RECALL_SIZES", "2,3")
    monkeypatch.setenv("RECALL_VOCABS", "4096")
    monkeypatch.setenv("RECALL_POOL", "4")
    keep = {}
    orb_patches.reset_counters()
    rows = vocab_recall_curve.main(["--device", "cpu"], keep=keep)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "devices: cpu"
    assert lines[1].startswith("place 0/3 (")
    assert lines[2:4] == ["| vocab | map size | recall@1 | recall@3 | margin |",
                          "|---|---|---|---|---|"]
    assert len(rows) == 2 and [r[:2] for r in rows] == [(4096, 2), (4096, 3)]
    for line, r in zip(lines[4:], rows):
        assert line == f"| 4096 | {r[1]} | {r[2]:.3f} | {r[3]:.3f} | {r[4]:+.4f} |"
    assert keep["db_desc"].shape == (3, 800, 8)
    assert set(orb_patches.launch_counts().values()) == {0}      # CPU: the twins


def test_recall_settings_default_to_jax(monkeypatch):
    for k in ("RECALL_PLACES", "RECALL_SIZES", "RECALL_VOCABS", "RECALL_POOL"):
        monkeypatch.delenv(k, raising=False)
    st = vocab_recall_curve.settings()
    assert st == dict(places=256, sizes=(32, 64, 128, 256), vocabs=(4096, 32768), pool=8)


@pytest.mark.parametrize("tool", [train_vocab, vocab_recall_curve])
def test_tool_refuses_the_card_without_one(tool, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit):
        tool.main([])
    assert "pass --device cpu" in capsys.readouterr().err


@pytest.mark.slow
def test_recall_descriptors_match_the_jax_tool_at_256_places(monkeypatch, capsys):
    """The recall tables' gap, measured: the JAX tool's `main` (its
    extraction spied, no vocabulary) and the port's `make_descriptors` at the
    default 256 places on the CPU, frame by frame.  The images must be equal
    (the mesas), every level the same keypoints, level-0 angles bit-equal,
    and the rows from the two descriptor sets equal.  What is left comes from
    test_torch_extract_levels.py's two causes, and each is checked as such:
    a frame with level-0 keypoints of other bits must have blurred pixels
    that round the other way while the two blurs stay within 1e-4 of each
    other (a few float32 steps at 255: the blur's float order), and above
    level 0 the angles stay within 0.1 degrees (the resize's, T1); bin
    flips and other bits at most 2e-4 of the keypoints (measured: 2 flips
    and 39 keypoints of 400,488, 52 pixels, the blurs 6.1e-5 apart, angles
    0.068 degrees).
    Prints the counts before it asserts."""
    from orbslam3_tpu.features import extractor as jx
    from orbslam3_tpu.ops import image as jimage
    from orbslam3_tpu_torch.ops import brief
    from orbslam3_tpu_torch.ops import image as timage

    for k in ("RECALL_PLACES", "RECALL_SIZES", "RECALL_VOCABS", "RECALL_POOL"):
        monkeypatch.delenv(k, raising=False)
    J = _jax_tool("vocab_recall_curve")
    rec_j, rec_t = [], []
    real_j, real_t = jx.extract_jit, tx.extract

    def spy_j(img, p):
        ff = real_j(img, p)
        g = jax.device_get(ff)
        rec_j.append((np.asarray(img), g.xy, g.octave, np.asarray(g.angle),
                      np.asarray(g.desc).view(np.int32), g.valid))
        return ff

    def spy_t(img, p):
        ff = real_t(img, p)
        rec_t.append((img.numpy(), *(x.numpy() for x in (ff.xy, ff.octave, ff.angle, ff.desc,
                                                           ff.valid))))
        return ff

    monkeypatch.setattr(jx, "extract_jit", spy_j)
    J.main(cpu=True, vocabs=())
    monkeypatch.setattr(tx, "extract", spy_t)
    desc_t = vocab_recall_curve.make_descriptors(256, 8, "cpu")
    assert len(rec_j) == len(rec_t) == 512
    imgs = kps = flips = bits = bits0 = n_kp = 0
    ang0 = ang = 0.0
    ties = []      # per frame with level-0 keypoints of other bits: (pixels, max |blur diff|)
    for (ij, xj, oj, aj, dj, vj), (it, xt, ot, at, dt, vt) in zip(rec_j, rec_t):
        imgs += not np.array_equal(ij, it)
        n_kp += int(vj.sum())
        for lv in range(4):
            kj = {tuple(xj[i].tolist()): i for i in np.nonzero((oj == lv) & vj)[0]}
            kt = {tuple(xt[i].tolist()): i for i in np.nonzero((ot == lv) & vt)[0]}
            kps += len(set(kj) ^ set(kt))
            common = sorted(set(kj) & set(kt))
            if not common:
                continue
            a, b = np.array([kj[c] for c in common]), np.array([kt[c] for c in common])
            flip = (brief.angle_bins(torch.from_numpy(aj[a])) !=
                    brief.angle_bins(torch.from_numpy(at[b]))).numpy()
            other = int((np.unpackbits((dj[a] ^ dt[b]).view(np.uint8), axis=1).sum(1)[~flip]
                         > 0).sum())
            d = np.abs(aj[a] - at[b])
            d = float(np.minimum(d, 360.0 - d).max())
            flips, bits = flips + int(flip.sum()), bits + other
            if lv > 0:
                ang = max(ang, d)
                continue
            ang0 = max(ang0, d)
            if other:
                bits0 += other
                x = ij.astype(np.float32)
                bj = np.asarray(jimage.gaussian_blur(jnp.asarray(x)))
                bt = timage.gaussian_blur(torch.from_numpy(x)).numpy()
                away = np.round(bj) != np.round(bt)
                ties.append((int(away.sum()), float(np.abs(bj - bt).max())))
    desc_j = {f"{k}_{f}": np.stack([np.asarray(r[i]) for r in rec_j[j::2]])
              for j, k in enumerate(("db", "q")) for f, i in (("desc", 4), ("valid", 5))}
    rows_j, rows_t = (vocab_recall_curve.recall_rows(d, (4096, 32768), (32, 64, 128, 256), "cpu",
                                                     echo=False) for d in (desc_j, desc_t))
    gap = max(abs(x - y) for rj, rt in zip(rows_j, rows_t) for x, y in zip(rj[2:4], rt[2:4]))
    margin = max(abs(rj[4] - rt[4]) for rj, rt in zip(rows_j, rows_t))
    with capsys.disabled():
        print(f"\nrecall descriptors, 512 frames, {n_kp} keypoints: {imgs} images differ; "
              f"{kps} keypoints not in both; {flips} in another angle bin; {bits} with other "
              f"bits at the same bin ({bits0} on level 0, in {len(ties)} frames whose blurs "
              f"round {sum(t[0] for t in ties)} pixels the other way, the two blurs within "
              f"{max((t[1] for t in ties), default=0.0):.3g}); max angle diff on level 0 "
              f"{ang0:.4g} deg, above it {ang:.4g} deg; recall rows' largest recall gap "
              f"{gap:.4g}, margin gap {margin:.3g}")
    assert imgs == 0 and kps == 0 and ang0 == 0.0 and gap == 0.0
    assert all(n > 0 and apart <= 1e-4 for n, apart in ties)
    assert ang <= 0.1 and flips + bits <= 2e-4 * n_kp
