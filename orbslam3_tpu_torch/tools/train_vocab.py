"""Train the place-recognition codebook: binary k-means over real ORB
descriptors from synthetic textured worlds.

    python -m orbslam3_tpu_torch.tools.train_vocab [--n-words 4096] [--n-views 48]
        [--seed 0] [--stage all|extract|kmeans] [--desc-file F] [--out F]
        [--device cuda|cpu]

The port of `tools/train_vocab.py`, with the same views, seeds, four texture
families, `OrbParams(800, 4)`, `place/vocab.kmeans_refine(iters=8)` from
`seed_codebook(n_words)`, and the word-entropy line.  The reference ships a
1M-leaf DBoW2 tree trained offline on real imagery
(Thirdparty/DBoW2/include/DBoW2/TemplatedVocabulary.h:135); this trainer
renders `--n-views` random textured-plane views, extracts their ORB
descriptors with the port's front end on `--device` (the `orb_describe`
kernel on a card) and refines the seed codebook with k-majority iterations.
`--stage extract` stops after the descriptors and writes them to
`--desc-file` (uint32, JAX's file layout); `--stage kmeans` reads that file
and runs the refinement alone.

Where the port differs: `--device` (default the first card; it refuses to
run without one unless asked for the CPU) where JAX has `--tpu`; the
descriptor file is `--desc-file` (default
`orbslam3_tpu_torch/build/vocab_train_descs.npz`), where JAX's is fixed under
/tmp; and the codebook goes to `--out` (default
`orbslam3_tpu_torch/build/vocab_<n_words>.npy`, uint32).  JAX's tool
overwrites its own package's `orbslam3_tpu/data/vocab_<n>.npy`; the port
only reads those files (`place/vocab.load_codebook`) and never writes
there.  `main` returns the codebook (None for `--stage extract`).
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from . import add_device_arg, device_name, device_of
from .. import REPO_ROOT

BUILD = os.path.join(REPO_ROOT, "orbslam3_tpu_torch", "build")
K4 = np.asarray([458.654, 457.296, 367.215, 248.375], np.float32)
HW = (480, 752)


def extract_descriptors(n_views: int, seed: int, dev):
    """(desc (n_views * 800, 8) int32, valid (n_views * 800,) bool) numpy, the
    views rendered and extracted in JAX's order."""
    import torch
    from ..features.extractor import OrbParams, extract
    from ..utils import synth_render as sr

    rng = np.random.default_rng(seed)
    p = OrbParams(n_features=800, n_levels=4)
    descs, valids = [], []
    for i in range(n_views):
        if i % 12 == 0:
            # rotate through all four texture families so that the codebook
            # generalizes (DBoW2's vocabulary is trained on diverse imagery)
            fam = (i // 12) % 4
            if fam == 0:
                tex = sr.block_texture(rng, block=int(rng.integers(5, 12)))
            elif fam == 1:
                tex = sr.voronoi_texture(rng, n_seeds=int(rng.integers(180, 500)))
            elif fam == 2:
                tex = sr.stripe_texture(rng)
            else:
                tex = sr.blob_texture(rng)
        R_cw, t_cw = sr.look_down_pose(
            float(rng.uniform(0, 8)), float(rng.uniform(0, 8)),
            float(rng.uniform(3, 7)), yaw=float(rng.uniform(0, 6.28)),
            tilt=float(rng.uniform(-0.25, 0.25)))
        img = sr.render_plane(R_cw, t_cw, K4, HW, tex)
        img += rng.normal(0, 2.0, img.shape).astype(np.float32)
        ff = extract(torch.from_numpy(np.clip(img, 0, 255)).to(dev), p)
        descs.append(ff.desc.cpu().numpy())
        valids.append(ff.valid.cpu().numpy())
        if i % 20 == 0:
            print(f"view {i}: {int(valids[-1].sum())} descriptors", flush=True)
    return np.concatenate(descs), np.concatenate(valids)


def refine(n_words: int, desc, valid, dev):
    """The codebook (uint32 numpy) refined from the seed over the
    descriptors, and (entropy bits, words used) of its word usage."""
    import torch
    from ..place import vocab as vocab_mod

    d = torch.from_numpy(np.ascontiguousarray(desc).view(np.int32)).to(dev)
    v = torch.from_numpy(np.asarray(valid, bool)).to(dev)
    cb = vocab_mod.codebook_tensor(vocab_mod.seed_codebook(n_words), dev)
    cb = vocab_mod.kmeans_refine(cb, d, v, iters=8)
    # word-usage entropy as a sanity metric
    words = vocab_mod.assign_words_chunked(d, cb).cpu().numpy()[np.asarray(valid, bool)]
    hist = np.bincount(words, minlength=n_words).astype(np.float64)
    pmf = hist / hist.sum()
    ent = -(pmf[pmf > 0] * np.log2(pmf[pmf > 0])).sum()
    return cb.cpu().numpy().view(np.uint32), float(ent), int(np.sum(hist > 0))


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m orbslam3_tpu_torch.tools.train_vocab")
    ap.add_argument("--n-words", type=int, default=4096)
    ap.add_argument("--n-views", type=int, default=48)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--stage", default="all", choices=["all", "extract", "kmeans"])
    ap.add_argument("--desc-file", default=os.path.join(BUILD, "vocab_train_descs.npz"),
                    help="descriptors written by --stage extract, read by --stage kmeans")
    ap.add_argument("--out", default=None,
                    help="codebook file (default orbslam3_tpu_torch/build/vocab_<n>.npy)")
    add_device_arg(ap)
    a = ap.parse_args(argv)
    dev = device_of(ap, a.device)
    print("device:", device_name(dev), flush=True)

    if a.stage == "kmeans":
        # the k-majority refinement alone, on descriptors of --stage extract
        data = np.load(a.desc_file)
        desc, valid = data["desc"], data["valid"]
    else:
        desc, valid = extract_descriptors(a.n_views, a.seed, dev)
        print(f"total descriptors: {int(valid.sum())}")
        if a.stage == "extract":
            os.makedirs(os.path.dirname(os.path.abspath(a.desc_file)), exist_ok=True)
            np.savez(a.desc_file, desc=desc.view(np.uint32), valid=valid)
            print(f"descriptors -> {a.desc_file}")
            return None
    cb, ent, used = refine(a.n_words, desc, valid, dev)
    out = a.out or os.path.join(BUILD, f"vocab_{a.n_words}.npy")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    np.save(out, cb)
    print(f"saved {out}; word entropy {ent:.2f} bits "
          f"(max {np.log2(a.n_words):.2f}), used {used} words")
    return cb


if __name__ == "__main__":
    main()
