"""The native ingest without libpng: the library built with no `png.h`,
fed frames that PIL decodes, against the libpng build and the JAX
package's `NativeIngest`; the plain stages (`io/ingest_ref.py`) against the
C++; the host decoder's refusals.

Here g++ finds `png.h`, so both libraries build: `native_ingest.load("pil")`
is the one a host without libpng headers builds.  Frames and failure
counts are compared bit for bit on every PNG layout decode_png_gray reads
whole (8-bit gray, 16-bit gray, gray+alpha, RGB, RGBA, palette; gAMA and
sRGB on color), with the stages off and on.
"""

import os
import sys
import threading

import numpy as np
import pytest
import torch
from PIL import Image, PngImagePlugin

from orbslam3_tpu.io import euroc as jeuroc
from orbslam3_tpu.io import native_ingest as jni
from orbslam3_tpu.io import pump as jpump
from orbslam3_tpu_torch.io import euroc as teuroc
from orbslam3_tpu_torch.io import ingest_ref
from orbslam3_tpu_torch.io import native_ingest as tni
from orbslam3_tpu_torch.io import pump as tpump
from test_torch_io import STARTS, _frames_key, _ingest_cases, _within, _write_tree

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 40, 56


@pytest.fixture(scope="module")
def libs():
    return {"pil": tni.load("pil"), "libpng": tni.load("libpng")}


def _ingest(lib, paths, *args, **kw):
    """(frames, failed count, decoder) of `paths` through `lib`."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tni, "_LIB", lib)
        it = tni.NativeIngest(paths, *args, **kw)
        frames = _within(60, lambda: list(it))
        failed = it.failed
        it.close()
    return frames, failed, it.decoder


def _jax(paths, *args, **kw):
    it = jni.NativeIngest(paths, *args, **kw)
    frames = _within(60, lambda: list(it))
    failed = it.failed
    it.close()
    return frames, failed


def _save(path, img, mode=None, chunks=()):
    info = PngImagePlugin.PngInfo()
    for name, data in chunks:
        info.add(name, data)
    Image.fromarray(img, mode).save(path, pnginfo=info)
    return str(path)


def _gama(fixed):
    return [(b"gAMA", int(fixed).to_bytes(4, "big"))]


def _layouts(d):
    """One small PNG of every layout the pool takes whole, from a seed."""
    rng = np.random.default_rng(7)
    rgb = rng.integers(0, 256, (H, W, 3)).astype(np.uint8)
    rgb[:6] = rgb[:6, :, :1]           # gray pixels take libpng's r == g == b branch
    rgba = rng.integers(0, 256, (H, W, 4)).astype(np.uint8)
    out = {
        "gray8": _save(d / "gray8.png", rng.integers(0, 256, (H, W)).astype(np.uint8)),
        "gray16": _save(d / "gray16.png", rng.integers(0, 65536, (H, W)).astype(np.uint16)),
        "gray_alpha": _save(d / "ga.png", rng.integers(0, 256, (H, W, 2)).astype(np.uint8), "LA"),
        "gray8_gama": _save(d / "gray8g.png", rng.integers(0, 256, (H, W)).astype(np.uint8),
                            chunks=_gama(45455)),
        "rgb": _save(d / "rgb.png", rgb),
        "rgba": _save(d / "rgba.png", rgba),
        "rgb_gama_045": _save(d / "rgbg.png", rgb, chunks=_gama(45455)),
        "rgb_gama_22": _save(d / "rgbg22.png", rgb, chunks=_gama(220000)),
        "rgb_gama_flat": _save(d / "rgbg1.png", rgb, chunks=_gama(97000)),
        "rgba_gama": _save(d / "rgbag.png", rgba, chunks=_gama(50000)),
        "rgb_srgb": _save(d / "srgb.png", rgb, chunks=[(b"sRGB", b"\x00")]),
    }
    Image.fromarray(rgb).quantize(200).save(d / "pal8.png")
    Image.fromarray(rgb).quantize(12).save(d / "pal4.png")      # a 4-bit palette
    out["palette8"], out["palette4"] = str(d / "pal8.png"), str(d / "pal4.png")
    return {k: str(v) for k, v in out.items()}


LAYOUTS = ["gray8", "gray16", "gray_alpha", "gray8_gama", "rgb", "rgba", "rgb_gama_045",
           "rgb_gama_22", "rgb_gama_flat", "rgba_gama", "rgb_srgb", "palette8", "palette4"]


def _stages(kind):
    """(positional, keyword) arguments of NativeIngest for H x W sources:
    no stage, or a remap (a shifted, scaled grid) then a resize then CLAHE."""
    if kind == "none":
        return ((H, W),), dict(src_hw=(H, W))
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    remap = np.stack([xs * 0.93 + 1.7, ys * 0.91 + 1.3], -1)
    return ((H, W),), dict(remap=remap, src_hw=(H, W), resize_hw=(28, 36), clahe_clip=3.0,
                           clahe_grid=4)


@pytest.mark.parametrize("stages", ["none", "remap_resize_clahe"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_pil_fed_pool_bit_equal_to_libpng_and_jax(tmp_path, libs, layout, stages):
    path = _layouts(tmp_path)[layout]
    args, kw = _stages(stages)
    got, f_pil, dec = _ingest(libs["pil"], [path], *args, n_threads=2, **kw)
    ref, f_png, dec_png = _ingest(libs["libpng"], [path], *args, n_threads=2, **kw)
    want, f_jax = _jax([path], *args, n_threads=2, **kw)
    assert (dec, dec_png) == ("pil", "libpng")
    assert f_pil == f_png == f_jax == 0
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[0], want[0])
    if stages == "none" and layout.startswith(("rgb", "palette")):
        # the conversion is libpng's (0.2126 / 0.7152 / 0.0722, gamma), not PIL's "L"
        pil_l = np.asarray(Image.open(path).convert("L"), np.float32)
        assert np.any(got[0] != pil_l)


def test_gamma_moves_the_gray_of_color_pixels(tmp_path, libs):
    """gAMA and sRGB change libpng's gray of a color pixel (the tables are
    built), a gamma within 5% of 1 does not, and gray pixels keep theirs."""
    p = _layouts(tmp_path)
    args, kw = _stages("none")
    out = {k: _ingest(libs["pil"], [p[k]], *args, **kw)[0][0]
           for k in ("rgb", "rgb_gama_045", "rgb_gama_22", "rgb_gama_flat", "rgb_srgb")}
    assert np.any(out["rgb_gama_045"] != out["rgb"]) and np.any(out["rgb_gama_22"] != out["rgb"])
    np.testing.assert_array_equal(out["rgb_gama_flat"], out["rgb"])
    np.testing.assert_array_equal(out["rgb_srgb"], out["rgb_gama_045"])
    np.testing.assert_array_equal(out["rgb_gama_045"][:6], out["rgb"][:6])


@pytest.mark.parametrize("case", ["resize_clahe", "remap_resize", "size_mismatch",
                                  "euroc_undistort_clahe"])
def test_pil_fed_pool_on_the_io_cases(tmp_path, libs, case):
    """test_torch_io.py's cases (test_io.py's pipelines and EuRoC's
    undistortion + CLAHE at full size) through the library without libpng:
    JAX's frames and failure count."""
    paths, args, kw = _ingest_cases(tmp_path)[case]
    got, failed, _ = _ingest(libs["pil"], paths, *args, n_threads=2, **kw)
    want, f_jax = _jax(paths, *args, n_threads=2, **kw)
    assert failed == f_jax == (1 if case == "size_mismatch" else 0)
    assert len(got) == len(want) == len(paths)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_failed_frames_are_counted_alike(tmp_path, libs):
    """A truncated file, a file of another size, one PIL cannot identify and
    a missing one are failed frames (zeros) in both libraries and in JAX's;
    the frames around them are decoded."""
    rng = np.random.default_rng(3)
    good = [_save(tmp_path / f"g{i}.png", rng.integers(0, 256, (H, W)).astype(np.uint8))
            for i in range(3)]
    raw = open(good[0], "rb").read()
    (tmp_path / "trunc.png").write_bytes(raw[: len(raw) // 2])
    (tmp_path / "junk.png").write_bytes(b"not a png at all")
    big = _save(tmp_path / "big.png", rng.integers(0, 256, (H + 8, W)).astype(np.uint8))
    paths = [good[0], str(tmp_path / "trunc.png"), good[1], big, str(tmp_path / "junk.png"),
             str(tmp_path / "missing.png"), good[2]]
    for stages in ("none", "remap_resize_clahe"):
        args, kw = _stages(stages)
        got, f_pil, _ = _ingest(libs["pil"], paths, *args, n_threads=3, **kw)
        ref, f_png, _ = _ingest(libs["libpng"], paths, *args, n_threads=3, **kw)
        want, f_jax = _jax(paths, *args, n_threads=3, **kw)
        # "big" is rejected by the size checks without a remap; with one the
        # remap reads it like any source, as in JAX's
        assert f_pil == f_png == f_jax == (4 if stages == "none" else 3)
        for a, b, c in zip(got, ref, want):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)
        assert not np.any(got[1]) and not np.any(got[4]) and not np.any(got[5])
        assert np.any(got[0]) and np.any(got[6])


def test_pil_fed_pool_outside_libpngs_whole_layouts(tmp_path, libs):
    """Where decode_png_gray does not read a layout whole, the pool says
    what it does: a 1-bit file (libpng reads its packed bytes) is a failed
    frame; 16-bit color, which PIL hands as 8-bit samples, is within one
    graylevel of libpng's without a gamma."""
    rng = np.random.default_rng(5)
    one = str(tmp_path / "one.png")
    Image.fromarray(rng.integers(0, 2, (H, W)).astype(bool)).save(one)
    args, kw = _stages("none")
    frames, failed, _ = _ingest(libs["pil"], [one], *args, **kw)
    assert failed == 1 and not np.any(frames[0])
    wide = _png16_rgb(tmp_path / "rgb16.png", rng.integers(0, 65536, (H, W, 3)))
    got, f_pil, _ = _ingest(libs["pil"], [wide], *args, **kw)
    ref, f_png, _ = _ingest(libs["libpng"], [wide], *args, **kw)
    assert f_pil == f_png == 0
    assert np.abs(got[0] - ref[0]).max() <= 1


def _png16_rgb(path, rgb16):
    """A 16-bit RGB PNG written by hand (PIL writes no 16-bit color)."""
    import struct
    import zlib

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    h, w = rgb16.shape[:2]
    rows = rgb16.astype(">u2").reshape(h, -1).view(np.uint8)
    body = b"".join(b"\x00" + r.tobytes() for r in rows)
    data = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 16, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(body)) + chunk(b"IEND", b""))
    path.write_bytes(data)
    return str(path)


@pytest.mark.parametrize("start", sorted(STARTS))
def test_pump_euroc_through_the_pil_fed_pool_matches_jax(tmp_path, libs, start, monkeypatch):
    """test_torch_io.py's mini tree through the pump with CLAHE 2.0: the
    library without libpng gives JAX's frames and IMU batches."""
    root = _write_tree(str(tmp_path), STARTS[start] or 1_000_000_000, gt=False)
    monkeypatch.setattr(tni, "_LIB", libs["pil"])
    ft = _within(60, lambda: list(tpump.pump_euroc(teuroc.EurocSequence(root),
                                                   clahe_clip=2.0, n_threads=2)))
    fj = _within(60, lambda: list(jpump.pump_euroc(jeuroc.EurocSequence(root),
                                                   clahe_clip=2.0, n_threads=2)))
    assert len(ft) == 5 and all(f.image.shape == (48, 64) for f in ft)
    assert _frames_key(ft) == _frames_key(fj)


def test_host_decoder_refuses_clahe_and_a_resize(tmp_path, monkeypatch):
    """Where no library builds, the host path raises on a CLAHE or a resize
    it cannot do, and still decodes what it can."""
    root = _write_tree(str(tmp_path), 1_000_000_000, gt=False)
    monkeypatch.setattr(tni, "_LIB", None)
    monkeypatch.setattr(tni, "_ERROR", "native ingest library unavailable: g++ did not run")
    seq = teuroc.EurocSequence(root)
    with pytest.raises(ValueError, match="no CLAHE and no resize: clahe_clip=2.0"):
        next(tpump.pump_euroc(seq, clahe_clip=2.0))
    with pytest.raises(ValueError, match=r"\(48, 64\) -> \(24, 32\)"):
        next(tpump.pump_euroc(seq, hw=(24, 32)))
    frames = _within(60, lambda: list(tpump.pump_euroc(seq, hw=(48, 64))))
    assert len(frames) == 5
    np.testing.assert_array_equal(frames[2].image, seq.load_image(seq.images[2]))


def test_ingest_ref_within_the_oracle_tolerances(tmp_path, libs):
    """The plain stages against the C++ under test_io.py's tolerances:
    resize + CLAHE within 1.5 graylevels (0.1 on average), remap + resize
    within 1e-3 away from the last row and column and 0.3 there; at full
    size (EuRoC's undistortion, CLAHE 3.0 on an 8x8 grid) the same CLAHE
    bounds away from the bin edges (`ingest_ref.clahe_gaps`)."""
    paths, args, kw = _ingest_cases(tmp_path)["resize_clahe"]
    (got,), _, _ = _ingest(libs["pil"], paths, *args, **kw)
    src = np.asarray(Image.open(paths[0]), np.float32)
    want = ingest_ref.pipeline(src, resize_hw=(48, 64), clahe_clip=3.0, clahe_grid=4)
    assert np.abs(got - want).max() < 1.5 and np.abs(got - want).mean() < 0.1
    paths, args, kw = _ingest_cases(tmp_path)["remap_resize"]
    (got,), _, _ = _ingest(libs["pil"], paths, *args, **kw)
    src = np.asarray(Image.open(paths[0]), np.float32)
    want = ingest_ref.pipeline(src, kw["remap"], resize_hw=(32, 40))
    assert np.abs(got[:-1, :-1] - want[:-1, :-1]).max() < 1e-3
    assert np.abs(got - want).max() < 0.3
    from orbslam3_tpu_torch.utils import euroc_scene
    root = euroc_scene.write_tree(str(tmp_path / "seq"), 2)
    seq = teuroc.EurocSequence(root)
    cam = teuroc.EUROC_CAM0
    umap = teuroc.undistort_map(cam["params"], cam["distortion"], cam["resolution"])
    frames, _, _ = _ingest(libs["pil"], [r.path for r in seq.images], cam["resolution"], umap,
                           src_hw=cam["resolution"], clahe_clip=3.0)
    for img, rec in zip(frames, seq.images):
        gaps = ingest_ref.clahe_gaps(img, seq.load_image(rec), umap, clahe_clip=3.0)
        assert gaps["max_off_edge"] < 1.5 and gaps["mean"] < 0.1, gaps


def test_library_names_and_builds(libs, monkeypatch):
    """Each decoder's library has its own name under the port's build
    directory, keyed by its flags; the one without libpng exports no
    libpng entry point and takes no frame twice or out of range; the
    build picks libpng where png.h is found."""
    pil, png = tni.build("pil"), tni.build("libpng")
    build = os.path.join(REPO, "orbslam3_tpu_torch", "build") + os.sep
    assert str(pil).startswith(build) and str(png).startswith(build)
    assert pil.name.startswith("ingest_pil_") and png.name.startswith("ingest_libpng_")
    assert libs["pil"].ingest_has_libpng() == 0 and libs["libpng"].ingest_has_libpng() == 1
    with pytest.raises(AttributeError):
        libs["pil"].ingest_create2
    assert tni.has_png_h()
    monkeypatch.setattr(tni, "has_png_h", lambda: False)
    assert tni.build() == pil
    lib = libs["pil"]
    h = lib.ingest_create_pushed(2, None, H, W, H, W, H, W, 0.0, 8, 1, 2)
    try:
        px = np.zeros((H, W), np.uint8)
        assert lib.ingest_push(h, 2, px.ctypes.data, H, W, 1, 8, 0) == 0
        assert lib.ingest_push(h, 0, px.ctypes.data, H, W, 1, 8, 0) == 1
        assert lib.ingest_push(h, 0, px.ctypes.data, H, W, 1, 8, 0) == 0
    finally:
        lib.ingest_destroy(h)


def test_pil_fed_pool_in_order_under_contention(tmp_path, libs):
    """More workers than cores, a queue of 2 and a short switch interval:
    every frame arrives once, in order, equal to the libpng build's; a
    stream closed early stops."""
    rng = np.random.default_rng(11)
    paths = [_save(tmp_path / f"s{i}.png", rng.integers(0, 256, (H, W)).astype(np.uint8))
             for i in range(48)]
    args, kw = _stages("remap_resize_clahe")
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        got, failed, _ = _ingest(libs["pil"], paths, *args, n_threads=16, queue_cap=2, **kw)
    finally:
        sys.setswitchinterval(old)
    ref, _, _ = _ingest(libs["libpng"], paths, *args, n_threads=2, **kw)
    assert failed == 0 and len(got) == len(paths)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tni, "_LIB", libs["pil"])
        it = tni.NativeIngest(paths, *args, n_threads=4, queue_cap=3, **kw)
        first = _within(30, lambda: [next(it), next(it)])
        _within(30, it.close)
    np.testing.assert_array_equal(first[1], ref[1])
    assert not any(t.name.startswith("ingest-pil") for t in threading.enumerate())


def test_the_build_without_libpng_is_taken_where_the_libpng_build_fails(tmp_path, libs,
                                                                         monkeypatch):
    """Headers without a libpng that links: the libpng build fails, the
    build without libpng is loaded in its place and `build_error()` keeps
    why; where both fail, both reasons are reported."""
    real = tni.build

    def libpng_broken(decoder=None):
        if decoder == "libpng":
            raise RuntimeError("g++ failed (1): /usr/bin/ld: cannot find -lpng")
        return real(decoder)

    monkeypatch.setattr(tni, "_LIB", None)
    monkeypatch.setattr(tni, "_ERROR", None)
    monkeypatch.setattr(tni, "_PASSED_OVER", None)
    monkeypatch.setattr(tni, "has_png_h", lambda: True)
    monkeypatch.setattr(tni, "build", libpng_broken)
    assert tni.available() and tni.decoder() == "pil"
    assert tni.build_error() == "the libpng build: g++ failed (1): /usr/bin/ld: cannot find -lpng"
    rng = np.random.default_rng(3)
    paths = [_save(tmp_path / f"f{i}.png", rng.integers(0, 256, (H, W)).astype(np.uint8))
             for i in range(2)]
    args, kw = _stages("remap_resize_clahe")
    it = tni.NativeIngest(paths, *args, n_threads=2, **kw)
    got = _within(30, lambda: list(it))
    it.close()
    assert it.decoder == "pil"
    for a, b in zip(got, _jax(paths, *args, n_threads=2, **kw)[0]):
        np.testing.assert_array_equal(a, b)

    def both_broken(decoder=None):
        raise RuntimeError(f"g++ failed (1): {decoder}")

    monkeypatch.setattr(tni, "_LIB", None)
    monkeypatch.setattr(tni, "_PASSED_OVER", None)
    monkeypatch.setattr(tni, "build", both_broken)
    assert not tni.available() and tni.decoder() is None
    assert tni.build_error() == ("native ingest library unavailable: the libpng build: g++ "
                                 "failed (1): libpng; the pil build: g++ failed (1): pil")


def test_runner_clahe_hands_the_system_jax_tools_frames(tmp_path, libs, monkeypatch, capsys):
    """`run_euroc --dataset tumvi --mode stereo-inertial --clahe 2.0` on the
    library without libpng (the card's host's): the rectified, equalized
    pairs that reach `track_stereo` equal, bit for bit, the pairs JAX's
    tools/run_euroc.py hands its System at the same clip (the run stops at
    the last frame's call)."""
    from orbslam3_tpu.pipeline import stereo_inertial_system as jsis
    from orbslam3_tpu_torch.pipeline import stereo_inertial_system as tsis
    from orbslam3_tpu_torch.tools import run_euroc
    from orbslam3_tpu_torch.utils import tumvi_scene
    from test_torch_euroc_tool import TUMVI_ARGS, _jax_tool
    n = 3
    root = tumvi_scene.write_tree(str(tmp_path / "tv"), n)
    seen = {"jax": [], "port": []}

    class Stop(Exception):
        pass

    def spy(name):
        def track_stereo(self, left, right, ts):
            seen[name].append((np.asarray(left), np.asarray(right), ts))
            if len(seen[name]) == n:
                raise Stop
            return 0, None
        return track_stereo

    monkeypatch.setattr(jsis.StereoInertialSystem, "track_stereo", spy("jax"))
    monkeypatch.setattr(tsis.StereoInertialSystem, "track_stereo", spy("port"))
    argv = [root, *TUMVI_ARGS, "--clahe", "2.0"]
    with pytest.raises(Stop):
        _jax_tool(argv, capsys)
    capsys.readouterr()
    monkeypatch.setattr(tni, "_LIB", libs["pil"])
    with pytest.raises(Stop):
        run_euroc.main(argv + ["--device", "cpu"])
    assert capsys.readouterr().out.splitlines()[0] == "ingest: native (pil)"
    assert len(seen["port"]) == len(seen["jax"]) == n
    for (tl, tr, tt), (jl, jr, jt) in zip(seen["port"], seen["jax"]):
        assert tl.shape == tr.shape == (512, 512) and tt == jt
        np.testing.assert_array_equal(tl, jl)
        np.testing.assert_array_equal(tr, jr)
    # the clip was applied: the frames are not the plain rectified ones
    from orbslam3_tpu_torch import config as presets
    *_, map0, _ = presets.tumvi_stereo_inertial()
    seq = teuroc.EurocSequence(root)
    plain = teuroc.apply_undistort(seq.load_image(seq.images[0]), map0)
    assert np.abs(seen["port"][0][0] - plain).mean() > 1.0
