"""Visual vocabulary for place recognition.

Counterpart of `orbslam3_tpu/place/vocab.py` (behavioural parity target:
DBoW2 ORB vocabulary + TF-IDF scoring, reference
Thirdparty/DBoW2/include/DBoW2/TemplatedVocabulary.h:135-171).  A flat
codebook of `n_words` anchor descriptors; a descriptor's word is the Hamming
argmin over all anchors, one (N x 256) @ (256 x V) product over the unpacked
bits.  Anchors are either the trained codebooks shipped with the JAX package
(`orbslam3_tpu/data/vocab_*.npy`, read by path) or pseudo-random seeds, and
`kmeans_refine` refines them (binary k-means: k-majority over the assigned
descriptors).

Codebooks are uint32 arrays on disk and in numpy; on a device they are int32
bit patterns, as descriptors are (`codebook_tensor`).  The argmin runs over
|b| - 2 a.b, which differs from the Hamming distance |a| + |b| - 2 a.b by a
constant per row: every value is an integer of magnitude <= 512, exact in
float32 whatever the summation order, so ties are exact ties and go to the
lowest word, as `jnp.argmin` sends them.
"""

from __future__ import annotations

import functools
import os
from typing import NamedTuple

import numpy as np
import torch

from .. import DATA_DIR
from ..ops import brief


@functools.lru_cache(maxsize=None)
def seed_codebook(n_words: int = 2048, seed: int = 7) -> np.ndarray:
    """(V, 8) uint32 random anchor descriptors."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2 ** 32, (n_words, 8), dtype=np.uint32)


def load_codebook(n_words: int = 4096, prefer_trained: bool = True) -> np.ndarray:
    """The pretrained (V, 8) uint32 codebook of this size (the analogue of
    loading ORBvoc.txt, reference src/System.cc:75-88), or the pseudo-random
    seed codebook when none is shipped."""
    if prefer_trained:
        path = os.path.join(DATA_DIR, f"vocab_{n_words}.npy")
        if os.path.exists(path):
            cb = np.load(path)
            if cb.shape == (n_words, 8):
                return cb.astype(np.uint32)
    return seed_codebook(n_words)


def codebook_tensor(codebook, device="cpu") -> torch.Tensor:
    """A numpy uint32 (or int32) codebook as an int32 tensor of bit patterns."""
    cb = np.ascontiguousarray(codebook)
    return torch.from_numpy(cb.view(np.int32).copy()).to(device)


class UnpackedCodebook(NamedTuple):
    """A codebook's bits as floats, made once and used by every assignment
    (65536 words: 64 MiB)."""
    bits: torch.Tensor    # (V, 256) float32 {0, 1}
    count: torch.Tensor   # (V,) float32 set bits per anchor


def unpack_codebook(codebook: torch.Tensor) -> UnpackedCodebook:
    bits = brief.unpack_bits(codebook)
    return UnpackedCodebook(bits=bits, count=torch.sum(bits, dim=1))


def assign_words(desc: torch.Tensor, codebook) -> torch.Tensor:
    """(N, 8) int32 descriptors -> (N,) int32 word ids (Hamming argmin, the
    lowest word on a tie).  `codebook`: (V, 8) int32 or an `UnpackedCodebook`.
    One (N, V) float32 temporary."""
    cb = codebook if isinstance(codebook, UnpackedCodebook) else unpack_codebook(codebook)
    d = torch.addmm(cb.count[None, :], brief.unpack_bits(desc), cb.bits.T, alpha=-2.0)
    return torch.argmin(d, dim=1).to(torch.int32)


def assign_words_chunked(desc: torch.Tensor, codebook, chunk: int = 2048) -> torch.Tensor:
    """`assign_words` for training-scale N: one (chunk, V) block at a time."""
    cb = codebook if isinstance(codebook, UnpackedCodebook) else unpack_codebook(codebook)
    return torch.cat([assign_words(desc[lo:lo + chunk], cb)
                      for lo in range(0, max(desc.shape[0], 1), chunk)])


def bow_vector(words: torch.Tensor, valid: torch.Tensor, n_words: int) -> torch.Tensor:
    """L1-normalized term-frequency vector (V,) (DBoW2 TF / L1-norm).  The
    addends are 0 or 1, so the sums are exact whatever order a repeated word's
    additions take."""
    tf = torch.zeros(n_words, dtype=torch.float32, device=words.device)
    tf = tf.index_add(0, words.long(), valid.to(torch.float32))
    return tf / torch.clamp_min(torch.sum(tf), 1.0)


def kmeans_refine(codebook: torch.Tensor, desc: torch.Tensor, valid: torch.Tensor,
                  iters: int = 2) -> torch.Tensor:
    """Binary k-means (k-majority) refinement of the (V, 8) int32 codebook over
    a batch of descriptors: the online analogue of DBoW2's offline training.
    An anchor that no descriptor was assigned to stays."""
    V = codebook.shape[0]
    bits = brief.unpack_bits(desc)                       # (N, 256) {0, 1}
    w = valid.to(torch.float32)
    for _ in range(iters):
        words = assign_words_chunked(desc, codebook).long()
        cnt = torch.zeros(V, dtype=torch.float32, device=desc.device).index_add(0, words, w)
        ssum = torch.zeros((V, 256), dtype=torch.float32, device=desc.device)
        ssum = ssum.index_add(0, words, bits * w[:, None])
        packed = brief.pack_bits(ssum > 0.5 * cnt[:, None])
        codebook = torch.where((cnt > 0)[:, None], packed, codebook)
    return codebook
