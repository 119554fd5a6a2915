"""Loop closing: the place-recognition half (vocabulary, keyframe database,
candidate detection with covisibility consistency).

Counterpart of `LoopConfig` and of `LoopCloser.__init__`, `_bow`,
`_covis_row`, `_detect_jit`, `add_keyframe`, `refine_vocab` and `detect` of
`orbslam3_tpu/pipeline/loop_closing.py` (parity target: upstream ORB-SLAM3
LoopClosing: candidate detection through the keyframe database with
covisibility exclusion and temporal consistency, reference
KeyFrameDatabase::DetectNBestCandidates, src/KeyFrameDatabase.cc:602, and
LoopClosing::DetectLoop).  `System` builds a `LoopCloser` for relocalization
too: the keyframe database backs both.

The geometric half (Sim3 between the current and the loop keyframe, the
essential-graph correction) is not ported yet: `try_close`, `_correct_loop`
and `build_essential_graph` raise, and `System` refuses
`enable_loop_closing`.

The codebook is unpacked into float bits once per `LoopCloser` (65536 words:
64 MiB) and again only when `refine_vocab` changes it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..place import keyframe_db as kdb
from ..place import vocab as vocab_mod
from ..slam_map import state as mapstate

_NOT_PORTED = "the Sim3 loop correction is not ported yet (ROADMAP queue 1 item 7)"


def build_essential_graph(m: mapstate.MapState, min_covis: int = 100,
                          n_covis_edges: int = 256):
    raise NotImplementedError(_NOT_PORTED)


@dataclasses.dataclass(frozen=True)
class LoopConfig:
    # 65536 words, the JAX package's default: its recall study over 1024
    # aliased places chose it over 32768
    n_words: int = 65536
    vocab: str = "trained"          # "trained" (data/vocab_*.npy) | "seed"
    min_common_words: int = 5
    consistency_needed: int = 3     # consecutive consistent detections
    min_sim3_matches: int = 20
    min_sim3_inliers: int = 20
    min_kf_gap: int = 12            # candidate must be this many keyframes old
    pose_graph_iters: int = 20


class LoopCloser:
    """Host-side place-recognition module attached to a System; its tensors
    live on `device`."""

    def __init__(self, cfg: LoopConfig, n_kf_capacity: int, device):
        self.cfg = cfg
        self.device = torch.device(device)
        self._set_codebook(vocab_mod.codebook_tensor(
            vocab_mod.load_codebook(cfg.n_words, prefer_trained=(cfg.vocab == "trained")),
            self.device))
        self.db = kdb.KeyframeDB.create(n_kf_capacity, cfg.n_words, self.device)
        # consistency chains: list of ((K,) bool covisibility-group mask,
        # count) (reference LoopClosing::DetectLoop mvConsistentGroups)
        self.consistent_groups: list[tuple[np.ndarray, int]] = []
        self.n_loops_closed = 0

    def _set_codebook(self, codebook: torch.Tensor) -> None:
        self.codebook = codebook
        self._unpacked = vocab_mod.unpack_codebook(codebook)

    def _bow(self, desc, valid):
        """(BoW vector (V,), word ids (N,)) of one frame's descriptors."""
        w = vocab_mod.assign_words(desc, self._unpacked)
        return vocab_mod.bow_vector(w, valid, self.cfg.n_words), w

    def _covis_row(self, m: mapstate.MapState, kf_idx):
        return mapstate.covisibility_weights(m, kf_idx)

    def _detect_jit(self, m: mapstate.MapState, db: kdb.KeyframeDB, bow, kf_idx):
        """DetectNBestCandidates with the covisibility adjacency that the
        group consistency needs.  Returns (cand (3,), score (3,), covis
        (K, K) bool)."""
        K = m.kf_R.shape[0]
        W = mapstate.covisibility_matrix(m)
        ids = torch.arange(K, device=W.device)
        covis = (W >= 15.0) & (ids[:, None] != ids[None, :]) & \
            m.kf_valid[:, None] & m.kf_valid[None, :]
        exclude = mapstate._row(covis, kf_idx) | (ids > kf_idx - self.cfg.min_kf_gap)
        cand, score = kdb.detect_candidates(db, bow, exclude, covis, n_best=3)
        return cand, score, covis

    # ------------------------------------------------------------- keyframe
    def add_keyframe(self, m, kf_idx, ff) -> None:
        """Register keyframe `kf_idx` (a Python int or a 0-d device tensor)
        with the BoW vector of its features.  No host read."""
        bow, _ = self._bow(ff.desc, ff.valid)
        self.db = kdb.add(self.db, kf_idx, bow)

    # -------------------------------------------------------- online vocab
    def refine_vocab(self, kf_features: dict, iters: int = 4) -> None:
        """Online codebook refinement (the analogue of DBoW2's offline
        k-means training, on the session's own imagery): k-majority refine
        the codebook over every given keyframe's descriptors ({keyframe
        index: FeatureFrame}), then re-encode the database so that stored
        BoW vectors and later queries live in the same word space.  A
        map-sized operation, for between sessions."""
        if not kf_features:
            return
        desc = torch.cat([f.desc for f in kf_features.values()])
        valid = torch.cat([f.valid for f in kf_features.values()])
        self._set_codebook(vocab_mod.kmeans_refine(self.codebook, desc, valid, iters=iters))
        self.db = kdb.clear(self.db)
        for k, f in kf_features.items():
            self.add_keyframe(None, k, f)
        self.consistent_groups = []

    # ------------------------------------------------------------ detection
    def detect(self, m: mapstate.MapState, kf_idx: int, ff) -> list:
        """The consistency-accepted loop-candidate keyframe indices, the
        best-scored first (empty when none).

        Candidates come from DetectNBestCandidates (covisibility-group
        accumulated TF-IDF scores); acceptance needs the reference's
        covisibility-consistency chains (LoopClosing::DetectLoop): a
        candidate's covisibility group must intersect a group detected at
        each of the last `consistency_needed` keyframes.  Every accepted
        candidate is returned, because the geometric check then tries each."""
        bow, _ = self._bow(ff.desc, ff.valid)
        cand_idx, _, covis = self._detect_jit(m, self.db, bow, kf_idx)
        cand_np = cand_idx.cpu().numpy()
        covis_np = covis.cpu().numpy()
        accepted: list[int] = []
        new_groups: list[tuple[np.ndarray, int]] = []
        prev_masks = np.stack([g for g, _ in self.consistent_groups]) \
            if self.consistent_groups else None
        prev_counts = np.asarray([c for _, c in self.consistent_groups], np.int64)
        for cand in cand_np:
            cand = int(cand)
            if cand < 0:
                continue
            group = covis_np[cand].copy()
            group[cand] = True
            count = 0
            if prev_masks is not None:
                overlap = (prev_masks & group).any(axis=1)
                if overlap.any():
                    count = int(prev_counts[overlap].max()) + 1
            new_groups.append((group, count))
            # `count` is the reference's nCurrentConsistency (prior count +
            # 1); with the default 3 a loop needs 4 consecutive consistent
            # detections, as upstream
            if count >= self.cfg.consistency_needed:
                accepted.append(cand)
        self.consistent_groups = new_groups
        return accepted

    # ------------------------------------------------------------- closure
    def try_close(self, system, ff, kf_idx: int) -> bool:
        raise NotImplementedError(_NOT_PORTED)

    def _correct_loop(self, system, kf_idx: int, cand: int, res) -> None:
        raise NotImplementedError(_NOT_PORTED)
