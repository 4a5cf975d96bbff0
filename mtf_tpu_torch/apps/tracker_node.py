"""Tracker node over the shared-memory frame bridge (port of
`mtf_tpu/apps/tracker_node.py`).

The `sample_tracker_node.cpp` analog of the reference ROS bridge: a
process that consumes the frames a `SharedImageWriter` publishes (any
acquisition process), runs one tracker, and publishes each frame's
corners as JSON lines on stdout and, with `--out`, a corners file. The
tracker runs on the card unless `--device` names another device; each
frame goes from the shared buffer to the card once.

Usage:
    # acquisition process (any producer)
    python - <<'PY'
    from mtf_tpu_torch.bridge import SharedImageWriter
    ...
    PY

    # tracker node
    python -m mtf_tpu_torch.apps.tracker_node --bridge cam0 \
        --corners 110,70,210,70,210,170,110,170 \
        sm esm am ncc ssm 8
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--bridge", required=True,
                   help="shared-memory bridge name (SharedImageWriter)")
    p.add_argument("--corners", required=True,
                   help="x1,y1,...,x4,y4 init region on the first frame")
    p.add_argument("--n_frames", type=int, default=-1,
                   help="stop after N frames (-1: until producer stops)")
    p.add_argument("--timeout", type=float, default=5.0,
                   help="seconds to wait for the next frame before exit")
    p.add_argument("--out", help="also write a reference-format corners file")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; cpu for a CPU "
                        "run)")
    args, extra = p.parse_known_args(argv)

    from mtf_tpu_torch import _device, create_tracker
    from mtf_tpu_torch.bridge import SharedImageReader
    from mtf_tpu_torch.utils.config import parse_arg_pairs

    dev = _device.resolve(args.device)
    cfg = parse_arg_pairs(extra)
    sm = str(cfg.pop("sm", "esm"))
    am = str(cfg.pop("am", "ncc"))
    ssm = str(cfg.pop("ssm", "8"))
    ilm = cfg.pop("ilm", None)
    ilm = None if ilm in (None, "0", 0, "none") else str(ilm)
    tracker = create_tracker(sm, am, ssm, ilm, device=dev, **cfg)

    def on_card(frame):
        if frame.ndim == 3 and frame.shape[-1] == 1:
            frame = frame[..., 0]
        return torch.as_tensor(frame, device=dev)

    corners = np.asarray([float(v) for v in args.corners.split(",")],
                         np.float32).reshape(1, 4, 2)
    reader = SharedImageReader(args.bridge, timeout=args.timeout)
    frame_id, frame = reader.read_latest()
    state = tracker.initialize(on_card(frame), corners)
    # readiness handshake: producers wait for this before streaming (the
    # ROS analog is the subscriber registration)
    print(json.dumps({"event": "initialized", "frame": int(frame_id)}),
          flush=True)

    tracked = []
    t = 0
    while args.n_frames < 0 or t < args.n_frames:
        try:
            frame_id, frame = reader.wait_next(timeout=args.timeout)
        except TimeoutError:
            break
        state = tracker.update(state, on_card(frame))
        c = tracker.corners(state)[0].T.cpu().numpy()          # (4, 2)
        tracked.append(c)
        print(json.dumps({"frame": int(frame_id),
                          "corners": c.reshape(-1).round(3).tolist()}),
              flush=True)
        t += 1
    reader.close()
    if args.out and tracked:
        from mtf_tpu_torch.utils.gt import write_corners_file
        write_corners_file(args.out, np.stack(tracked))
    return t


if __name__ == "__main__":
    sys.exit(0 if main() >= 0 else 1)
