"""Keyframe database: place recognition over bag-of-words vectors.

Counterpart of `orbslam3_tpu/place/keyframe_db.py` (parity target: reference
KeyFrameDatabase, src/KeyFrameDatabase.cc: add / erase / clear :38-97 and the
candidate detectors, DetectNBestCandidates :602 and
DetectRelocalizationCandidates :731).  The reference's inverted file (word ->
keyframes) sparsifies scoring on a CPU; here the database is a dense (K, V)
term-frequency matrix and a query is one matrix-vector product over all
keyframes.  IDF weights are recomputed from the document frequencies at
every query.

`add`, `erase` and `clear` return a new database and leave their input
untouched, as in JAX (an archived database stays what it was).  The keyframe
index may be a Python int or a 0-d device tensor.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..slam_map.state import _set_at


class KeyframeDB(NamedTuple):
    tf: torch.Tensor        # (K, V) L1-normalized term frequencies
    has_word: torch.Tensor  # (K, V) bool, word presence per keyframe
    active: torch.Tensor    # (K,) bool, keyframe registered

    @staticmethod
    def create(n_kf: int, n_words: int, device) -> "KeyframeDB":
        return KeyframeDB(
            tf=torch.zeros((n_kf, n_words), dtype=torch.float32, device=device),
            has_word=torch.zeros((n_kf, n_words), dtype=torch.bool, device=device),
            active=torch.zeros(n_kf, dtype=torch.bool, device=device))

    @property
    def nbytes(self) -> int:
        return sum(x.numel() * x.element_size() for x in self)


def add(db: KeyframeDB, kf_idx, bow: torch.Tensor) -> KeyframeDB:
    """Register a keyframe's BoW vector (reference KeyFrameDatabase::add)."""
    return KeyframeDB(tf=_set_at(db.tf, kf_idx, bow),
                      has_word=_set_at(db.has_word, kf_idx, bow > 0),
                      active=_set_at(db.active, kf_idx, True))


def erase(db: KeyframeDB, kf_idx) -> KeyframeDB:
    return KeyframeDB(tf=_set_at(db.tf, kf_idx, 0.0),
                      has_word=_set_at(db.has_word, kf_idx, False),
                      active=_set_at(db.active, kf_idx, False))


def clear(db: KeyframeDB) -> KeyframeDB:
    return KeyframeDB.create(db.tf.shape[0], db.tf.shape[1], db.tf.device)


def idf_weights(db: KeyframeDB) -> torch.Tensor:
    """(V,) inverse document frequency: log(N / n_docs_with_word + 1)."""
    n_docs = torch.clamp_min(torch.sum(db.active.to(torch.float32)), 1.0)
    dfreq = torch.sum(db.has_word & db.active[:, None], dim=0, dtype=torch.float32)
    return torch.log(n_docs / torch.clamp_min(dfreq, 1.0) + 1.0)


def query(db: KeyframeDB, bow: torch.Tensor, exclude: torch.Tensor | None = None,
          min_common_words: int = 5):
    """Score all keyframes against a query BoW vector.

    Returns (scores (K,), n_common_words (K,) int32).  `exclude`: (K,) bool of
    keyframes to mask (callers pass the query's covisibility group).  The
    score is the TF-IDF weighted dot product sum_v tf[k, v] idf[v]^2 bow[v]
    (the same monotone family as DBoW2's L1 score); a keyframe also needs
    `min_common_words` shared words.  A masked keyframe scores -1.

    The weights are folded into the query vector, so the product reads the
    (K, V) matrix once and builds no weighted copy of it; the only (K, V)
    temporaries are the boolean masks of `idf_weights` and of the common-word
    count, one at a time."""
    idf = idf_weights(db)
    scores = db.tf @ (bow * idf * idf)
    common = torch.sum(db.has_word & (bow > 0)[None, :], dim=1, dtype=torch.int32)
    ok = db.active & (common >= min_common_words)
    if exclude is not None:
        ok = ok & ~exclude
    return torch.where(ok, scores, -1.0), common


def detect_candidates(db: KeyframeDB, bow: torch.Tensor, exclude: torch.Tensor,
                      covis: torch.Tensor, n_best: int = 3):
    """DetectNBestCandidates parity: score each keyframe, accumulate the
    scores over its covisibility group (covis: (K, K) bool adjacency) and
    return the top-n group-leading keyframes, the lower index first on a tie
    (as `lax.top_k`).

    Returns (cand_idx (n_best,) int32, cand_score (n_best,)), -1 padded.
    """
    scores, common = query(db, bow, exclude)
    # relative common-word gate (reference: minCommonWords = 0.8 * max)
    ok = scores >= 0
    max_common = torch.max(torch.where(ok, common, 0))
    ok = ok & (common >= (0.8 * max_common).to(common.dtype))
    s = torch.where(ok, scores, 0.0)
    grp = s + covis.to(torch.float32) @ s
    grp = torch.where(ok, grp, -1.0)
    top_s, top_i = torch.sort(grp, descending=True, stable=True)
    top_s, top_i = top_s[:n_best], top_i[:n_best].to(torch.int32)
    return torch.where(top_s > 0, top_i, -1), top_s
