"""SimpleTrackingDemo analog: the shortest end-to-end use of the port
(port of `examples/simple_tracking_demo.py`).

Reference: `Examples/cpp/SimpleTrackingDemo.cc`. Tracks a synthetic
sequence (or the frames of `source`) with ESM + NCC + homography on the
card unless `--device` names another device:

    python -m mtf_tpu_torch.examples.simple_tracking_demo [source] \
        [--device cpu]
"""
import argparse

import numpy as np
import torch

# each frame's mean corner error (px) on the synthetic sequence, for a
# caller that runs `main` in-process
LAST_ERRORS: list = []


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("source", nargs="?",
                   help="frames dir or video (synthetic if omitted)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; cpu for a CPU "
                        "run)")
    args = p.parse_args(argv)

    from mtf_tpu_torch import _device, create_tracker
    from mtf_tpu_torch.ssm import get_ssm
    from mtf_tpu_torch.utils import synth

    dev = _device.resolve(args.device)
    if args.source:
        from mtf_tpu_torch.video_capture import VideoCapture
        cap = VideoCapture(args.source)
        ok, f0 = cap.read()
        assert ok, "empty source"
        h, w = f0.squeeze().shape[:2]
        s = min(h, w) / 4
        corners = np.asarray([[w/2-s, h/2-s], [w/2+s, h/2-s],
                              [w/2+s, h/2+s], [w/2-s, h/2+s]], np.float32)
        frames = [torch.as_tensor(f0.squeeze(), device=dev)]
        while True:
            ok, f = cap.read()
            if not ok:
                break
            frames.append(torch.as_tensor(f.squeeze(), device=dev))
        gt = None
    else:
        rng = np.random.default_rng(0)
        raw = np.cumsum(np.cumsum(rng.normal(0, 1, (240, 320)), 0), 1)
        img = ((raw - raw.min()) / (raw.max() - raw.min()) * 255.0).astype(
            np.float32)
        corners = np.asarray([[110, 80], [210, 80], [210, 160], [110, 160]],
                             np.float32)
        fr, gt = synth.synthetic_sequence(img, corners,
                                          get_ssm("8", device=dev),
                                          n_frames=10, sigma_scale=0.02)
        frames = [fr[i] for i in range(fr.shape[0])]

    trk = create_tracker("esm", "ncc", "8", device=dev)  # ESM + NCC + homography
    state = trk.initialize(frames[0], corners[None])
    LAST_ERRORS.clear()
    for t, frame in enumerate(frames[1:], 1):
        state = trk.update(state, frame)
        c = trk.corners(state)[0].T.cpu().numpy()
        line = f"frame {t}: corners {np.round(c[0], 1)} ..."
        if gt is not None:
            err = float(np.linalg.norm(c - gt[t], axis=-1).mean())
            LAST_ERRORS.append(err)
            line += f"  err={err:.3f}px"
        print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
