"""Sensor synchronization pump: image + IMU (+ GNSS) queues feeding the
tracker in timestamp order.

The port of `orbslam3_tpu/io/pump.py` (NumPy only).  Parity target: the
reference's ROS 2 grabber threads (ros2_ws/src/mono-inertial/include/
image_grabber.hpp:113-225 `SyncWithImu`): images (optionally paired with a
GNSS fix) and IMU samples arrive on independent callbacks into
mutex-guarded queues; a pump loop pops the oldest image, shifts its
timestamp by the cam-IMU time offset, collects every IMU sample with
t <= t_image, and calls TrackMonocular(im, t, imu_batch, has_gnss,
gnss_pos).

Here the queues are thread-safe producers (`feed_image` / `feed_imu` /
`feed_gnss` can be called from any thread, e.g. the native ingest worker
pool or a live driver) and `sync()` is a generator yielding `SyncedFrame`s
with exactly the reference's batching semantics.  For dataset playback,
`pump_euroc` wires a EurocSequence through it.  Timestamps stay Python
floats (float64) throughout.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass
class SyncedFrame:
    ts: float                    # image timestamp shifted into IMU clock
    image: np.ndarray            # (H, W) float32 grayscale
    imu: list                    # [(t, gyro(3,), acc(3,)), ...], t <= ts
    gnss: Optional[np.ndarray]   # (3,) position fix or None
    index: int


class SensorPump:
    """Thread-safe image/IMU/GNSS queues + the reference's sync loop."""

    def __init__(self, timeshift_cam_imu: float = 0.0,
                 max_queue: int = 64):
        self._mu = threading.Condition()
        self._imgs: collections.deque = collections.deque()
        self._imu: collections.deque = collections.deque()
        self._gnss: collections.deque = collections.deque()
        self._done = False
        self.timeshift = timeshift_cam_imu
        self.max_queue = max_queue
        self._n = 0

    # ------------------------------------------------------------ producers
    def feed_image(self, ts: float, image: np.ndarray,
                   gnss: Optional[np.ndarray] = None) -> None:
        with self._mu:
            while len(self._imgs) >= self.max_queue and not self._done:
                self._mu.wait(timeout=0.1)
            self._imgs.append((ts, image, gnss, self._n))
            self._n += 1
            self._mu.notify_all()

    def feed_imu(self, ts: float, gyro: np.ndarray, acc: np.ndarray) -> None:
        with self._mu:
            self._imu.append((ts, np.asarray(gyro, np.float32),
                              np.asarray(acc, np.float32)))
            self._mu.notify_all()

    def feed_gnss(self, ts: float, pos: np.ndarray) -> None:
        """Standalone GNSS stream (when fixes are not image-paired): the
        pump attaches the latest fix within `gnss_window` of the frame."""
        with self._mu:
            self._gnss.append((ts, np.asarray(pos, np.float32)))
            self._mu.notify_all()

    def finish(self) -> None:
        with self._mu:
            self._done = True
            self._mu.notify_all()

    # ------------------------------------------------------------- consumer
    def sync(self, require_imu: bool = True,
             gnss_window: float = 0.05) -> Iterator[SyncedFrame]:
        """Yield frames in order, each with its IMU batch (all samples with
        t <= shifted image ts — image_grabber.hpp:165-185).  With
        `require_imu`, a frame waits until an IMU sample NEWER than it
        exists (so the batch is complete), like the reference's
        imuBuf-front check."""
        while True:
            with self._mu:
                while True:
                    if self._imgs:
                        t_im = self._imgs[0][0] + self.timeshift
                        if not require_imu:
                            break
                        # batch complete once a newer IMU sample arrived
                        if self._imu and self._imu[-1][0] > t_im:
                            break
                    if self._done and (not self._imgs or
                                       (require_imu and not self._imu)):
                        return
                    if self._done and self._imgs:
                        break
                    self._mu.wait(timeout=0.1)
                ts_raw, img, gnss, idx = self._imgs.popleft()
                t_im = ts_raw + self.timeshift
                batch = []
                while self._imu and self._imu[0][0] <= t_im:
                    batch.append(self._imu.popleft())
                if gnss is None and self._gnss:
                    # drop fixes superseded by a newer one still <= t_im,
                    # then attach the nearest in-window fix (the candidate
                    # just before or just after the frame)
                    while len(self._gnss) > 1 and \
                            self._gnss[1][0] <= t_im:
                        self._gnss.popleft()
                    best = None
                    for tg, pg in list(self._gnss)[:2]:
                        d = abs(tg - t_im)
                        if d <= gnss_window and (best is None or
                                                 d < best[0]):
                            best = (d, pg)
                    if best is not None:
                        gnss = best[1]
                self._mu.notify_all()
            yield SyncedFrame(ts=t_im, image=img, imu=batch, gnss=gnss,
                              index=idx)


def pump_euroc(seq, hw: tuple[int, int] | None = None,
               remap: np.ndarray | None = None,
               timeshift_cam_imu: float = 0.0,
               clahe_clip: float = 0.0,
               n_threads: int = 4) -> Iterator[SyncedFrame]:
    """Dataset playback through the pump: images decoded by the native
    ingest pool (PNG -> remap -> CLAHE off the GIL) when it builds, else on
    the host (`load_image` + `apply_undistort`, no CLAHE; the caller reads
    `native_ingest.available()` to say which), IMU from the CSV, batched
    exactly like the live path.  A failure of the producer thread is
    raised here once the frames it fed are consumed."""
    from . import native_ingest

    recs = seq.images
    pump = SensorPump(timeshift_cam_imu=timeshift_cam_imu)
    for r in seq.imu:
        pump.feed_imu(r.ts, r.gyro, r.acc)

    src_hw = seq.load_image(recs[0]).shape if recs else (0, 0)
    out_hw = hw if hw is not None else src_hw
    paths = [r.path for r in recs]

    failed = []

    def produce():
        try:
            if native_ingest.available():
                rm_hw = remap.shape[:2] if remap is not None else out_hw
                src = native_ingest.NativeIngest(
                    paths, rm_hw, remap=remap, src_hw=src_hw,
                    resize_hw=out_hw, clahe_clip=clahe_clip,
                    n_threads=n_threads)
                for rec, img in zip(recs, src):
                    pump.feed_image(rec.ts, img)
            else:
                from . import euroc
                for rec in recs:
                    img = seq.load_image(rec)
                    if remap is not None:
                        img = euroc.apply_undistort(img, remap)
                    pump.feed_image(rec.ts, img)
        except BaseException as e:      # handed to the consumer below
            failed.append(e)
        finally:
            pump.finish()

    th = threading.Thread(target=produce, daemon=True)
    th.start()
    yield from pump.sync()
    th.join()
    if failed:
        # the JAX package's consumer waits forever when its producer dies
        raise RuntimeError("pump_euroc: the image producer failed") from failed[0]
