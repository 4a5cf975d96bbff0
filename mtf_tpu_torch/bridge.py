"""Shared-memory frame bridge: SharedImageWriter / SharedImageReader (port
of `mtf_tpu/bridge.py`).

Re-designs the reference ROS bridge's transport
(`ROS/src/mtf_bridge/` — `SharedImageWriter` publishes
frames into a shared buffer, `SharedImageReader` consumes them in the
tracker node, `sample_tracker_node.cpp`). ROS itself is out of scope; the
functional piece — zero-copy frame hand-off between an acquisition
process and a tracker process — maps onto `multiprocessing.shared_memory`
with a tiny header (frame id + dims) and a ring of slots.

    # producer process
    w = SharedImageWriter("cam0", h, w_, c, n_slots=4)
    w.write(frame)

    # consumer process
    r = SharedImageReader("cam0")
    frame_id, frame = r.read_latest()

The writer owns the segment and unlinks it on `close()`; a reader only
attaches, so a reader process that exits leaves it to the writer and to
the next reader.
"""
from __future__ import annotations

import struct
import sys
import time
from multiprocessing import resource_tracker, shared_memory

import numpy as np

_HEADER_FMT = "qiiii"  # latest_id, h, w, c, n_slots
_HEADER_SIZE = struct.calcsize(_HEADER_FMT)


class SharedImageWriter:
    def __init__(self, name: str, h: int, w: int, c: int = 1,
                 n_slots: int = 4):
        self.h, self.w, self.c, self.n_slots = h, w, c, n_slots
        frame_bytes = h * w * c * 4
        size = _HEADER_SIZE + n_slots * frame_bytes
        try:
            self.shm = shared_memory.SharedMemory(
                name=f"mtf_{name}", create=True, size=size)
        except FileExistsError:
            self.shm = shared_memory.SharedMemory(name=f"mtf_{name}")
        self._frame_bytes = frame_bytes
        self._write_header(-1)

    def _write_header(self, latest_id: int):
        struct.pack_into(_HEADER_FMT, self.shm.buf, 0, latest_id,
                         self.h, self.w, self.c, self.n_slots)

    def write(self, frame) -> int:
        a = np.ascontiguousarray(np.asarray(frame, np.float32)
                                 .reshape(self.h, self.w, self.c))
        latest = struct.unpack_from(_HEADER_FMT, self.shm.buf, 0)[0]
        new_id = latest + 1
        slot = new_id % self.n_slots
        off = _HEADER_SIZE + slot * self._frame_bytes
        self.shm.buf[off:off + self._frame_bytes] = a.tobytes()
        self._write_header(new_id)
        return new_id

    def close(self, unlink: bool = True):
        self.shm.close()
        if unlink:
            try:
                self.shm.unlink()
            except FileNotFoundError:
                pass


def _attach(name: str) -> shared_memory.SharedMemory:
    """Attach to the writer's segment without owning it. Up to Python
    3.12 attaching registers the segment with this process's resource
    tracker, which unlinks it when the process exits, under the writer
    and any later reader; 3.13 and later take `track=False`."""
    if sys.version_info >= (3, 13):
        return shared_memory.SharedMemory(name=name, track=False)
    shm = shared_memory.SharedMemory(name=name)
    resource_tracker.unregister(shm._name, "shared_memory")
    return shm


class SharedImageReader:
    def __init__(self, name: str, timeout: float = 5.0):
        t0 = time.time()
        while True:
            try:
                self.shm = _attach(f"mtf_{name}")
                break
            except FileNotFoundError:
                if time.time() - t0 > timeout:
                    raise
                time.sleep(0.01)
        _, self.h, self.w, self.c, self.n_slots = struct.unpack_from(
            _HEADER_FMT, self.shm.buf, 0)
        self._frame_bytes = self.h * self.w * self.c * 4
        self._last_seen = -1

    def read_latest(self):
        """-> (frame_id, frame (H, W, C) float32) of the newest frame,
        or (None, None) if nothing was published yet."""
        latest = struct.unpack_from(_HEADER_FMT, self.shm.buf, 0)[0]
        if latest < 0:
            return None, None
        slot = latest % self.n_slots
        off = _HEADER_SIZE + slot * self._frame_bytes
        a = np.frombuffer(self.shm.buf, np.float32,
                          count=self.h * self.w * self.c, offset=off)
        self._last_seen = latest
        return latest, a.reshape(self.h, self.w, self.c).copy()

    def wait_next(self, timeout: float = 5.0):
        """Block until a frame newer than the last read arrives."""
        t0 = time.time()
        while True:
            latest = struct.unpack_from(_HEADER_FMT, self.shm.buf, 0)[0]
            if latest > self._last_seen:
                return self.read_latest()
            if time.time() - t0 > timeout:
                raise TimeoutError("no new frame")
            time.sleep(0.001)

    def close(self):
        self.shm.close()
