"""Place-recognition recall against map size and vocabulary size.

    python -m orbslam3_tpu_torch.tools.vocab_recall_curve [--device cuda|cpu]

The port of `tools/vocab_recall_curve.py`, with the same places, texture
pool, stress, environment variables and table.  At a 256-keyframe capacity
with aliased textures the TF-IDF discrimination of the vocabulary is the
binding constraint on loop precision; this tool measures it.

Protocol: `RECALL_PLACES` (default 256) aliased places (distinct look-down
positions drawing from a small pool of `RECALL_POOL` texture instances
across four families, so that different places share local appearance),
one nominal render per place registered in the keyframe database, one
stressed re-render per place (exposure, gamma, noise, a small pose offset)
as the query.  For each map size M of `RECALL_SIZES` (default
32,64,128,256) and each vocabulary of `RECALL_VOCABS` (default 4096,32768,
read through `place/vocab.load_codebook`, the trained codebooks of
`orbslam3_tpu/data/`), prints recall@1 and recall@3 (the share of queries
whose true place ranks first / within the top 3 database scores) and the
mean margin between the true place's score and the best impostor's.

The tool is split in two, so that tests can feed both packages the same
descriptors: `make_descriptors` renders the places and extracts them on
`--device` (the `orb_describe` kernel on a card), and `recall_rows` turns
descriptors into the table's rows.  Where the port differs: `--device`
(default the first card; it refuses to run without one unless asked for the
CPU) where JAX has `--cpu`; the environment is read when `main` runs, not
when the module is imported.  `main(argv, keep=)` returns the rows and
leaves the descriptors in `keep` when given a dict.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from . import add_device_arg, device_name, device_of

K4 = np.asarray([458.654, 457.296, 367.215, 248.375], np.float32)
HW = (480, 752)


def settings() -> dict:
    """RECALL_PLACES, RECALL_SIZES, RECALL_VOCABS and RECALL_POOL, with JAX's
    defaults."""
    places = int(os.environ.get("RECALL_PLACES", 256))
    return dict(
        places=places,
        sizes=tuple(int(x) for x in os.environ.get("RECALL_SIZES", "32,64,128,256").split(",")),
        vocabs=tuple(int(v) for v in os.environ.get("RECALL_VOCABS", "4096,32768").split(",")),
        # the default pool keeps the aliasing density (32 places per texture
        # instance) constant as the database grows, so that the curve
        # measures database-size confusability, not a harder aliasing ratio
        pool=int(os.environ.get("RECALL_POOL", max(places // 32, 8))))


def make_descriptors(n_places: int, n_pool: int, dev) -> dict:
    """Each place's nominal and stressed views, extracted on `dev`: numpy
    `db_desc`, `q_desc` (P, 800, 8) int32 and `db_valid`, `q_valid` (P, 800)
    bool."""
    import torch
    from ..features.extractor import OrbParams, extract
    from ..utils import synth_render as sr

    rng = np.random.default_rng(11)
    p = OrbParams(n_features=800, n_levels=4)
    # texture pool: n_pool / 4 instances x 4 families (block, voronoi,
    # stripe, blob: cross-family impostors), reused by all places
    pool = []
    for _ in range(max(n_pool // 4, 1)):
        pool.append(sr.block_texture(rng, block=int(rng.integers(6, 11))))
        pool.append(sr.voronoi_texture(rng, n_seeds=int(rng.integers(200, 420))))
        pool.append(sr.stripe_texture(rng))
        pool.append(sr.blob_texture(rng))

    def ext(img):
        ff = extract(torch.from_numpy(np.clip(img, 0, 255).astype(np.uint8)).to(dev), p)
        return ff.desc.cpu().numpy(), ff.valid.cpu().numpy()

    t0 = time.time()
    out = {k: [] for k in ("db_desc", "db_valid", "q_desc", "q_valid")}
    for k in range(n_places):
        tex = pool[k % len(pool)]
        x, y = float(rng.uniform(0, 14)), float(rng.uniform(0, 14))
        z = float(rng.uniform(4, 6))
        yaw = float(rng.uniform(0, 6.28))
        img = sr.render_plane(*sr.look_down_pose(x, y, z, yaw=yaw), K4, HW, tex)
        d, v = ext(img + rng.normal(0, 1.5, img.shape))
        out["db_desc"].append(d)
        out["db_valid"].append(v)
        # stressed revisit: small pose offset + photometric shift
        img_q = sr.render_plane(
            *sr.look_down_pose(x + float(rng.uniform(-0.2, 0.2)),
                               y + float(rng.uniform(-0.2, 0.2)),
                               z * float(rng.uniform(0.97, 1.03)),
                               yaw=yaw + float(rng.uniform(-0.1, 0.1))),
            K4, HW, tex)
        img_q = sr.photometric_stress(
            img_q, exposure=float(rng.uniform(0.7, 1.3)),
            gamma=float(rng.uniform(0.9, 1.12)), vignette=0.3,
            noise=4.0, rng=rng)
        d, v = ext(img_q)
        out["q_desc"].append(d)
        out["q_valid"].append(v)
        if k % 64 == 0:
            print(f"place {k}/{n_places} ({time.time() - t0:.0f}s)", flush=True)
    return {k: np.stack(v) for k, v in out.items()}


def recall_rows(desc: dict, vocabs, sizes, dev, echo: bool = True) -> list:
    """Rows (vocab, map size, recall@1, recall@3, mean margin) from
    `make_descriptors`' output, scored on `dev`; printed as they come when
    `echo`."""
    import torch
    from ..place import keyframe_db as kdb
    from ..place import vocab as vocab_mod

    on = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    rows = []
    for V in vocabs:
        cb = vocab_mod.unpack_codebook(
            vocab_mod.codebook_tensor(vocab_mod.load_codebook(V, prefer_trained=True), dev))

        def bow(d, v):
            return vocab_mod.bow_vector(vocab_mod.assign_words(on(d), cb), on(v), V)

        bows_db = [bow(d, v) for d, v in zip(desc["db_desc"], desc["db_valid"])]
        bows_q = [bow(d, v) for d, v in zip(desc["q_desc"], desc["q_valid"])]
        for M in sizes:
            db = kdb.KeyframeDB.create(M, V, dev)
            for k in range(M):
                db = kdb.add(db, k, bows_db[k])
            r1 = r3 = 0
            margins = []
            for k in range(M):
                scores, _ = kdb.query(db, bows_q[k])
                s = scores.cpu().numpy()
                order = np.argsort(-s)
                rank = int(np.where(order == k)[0][0])
                r1 += rank == 0
                r3 += rank < 3
                imp = np.delete(s, k)
                margins.append(float(s[k] - imp.max()))
            rows.append((V, M, r1 / M, r3 / M, float(np.mean(margins))))
            if echo:
                print(f"| {V} | {M} | {r1 / M:.3f} | {r3 / M:.3f} | "
                      f"{np.mean(margins):+.4f} |", flush=True)
    return rows


def main(argv=None, keep: dict | None = None) -> list:
    ap = argparse.ArgumentParser(prog="python -m orbslam3_tpu_torch.tools.vocab_recall_curve")
    add_device_arg(ap)
    a = ap.parse_args(argv)
    dev = device_of(ap, a.device)
    print("devices:", device_name(dev), flush=True)
    st = settings()
    desc = make_descriptors(st["places"], st["pool"], dev)
    if keep is not None:
        keep.update(desc)
    print("| vocab | map size | recall@1 | recall@3 | margin |")
    print("|---|---|---|---|---|")
    return recall_rows(desc, st["vocabs"], st["sizes"], dev)


if __name__ == "__main__":
    main()
