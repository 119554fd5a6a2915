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

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam3_tpu.place import keyframe_db as jkdb
from orbslam3_tpu.place import vocab as jvocab
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
