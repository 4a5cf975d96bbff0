"""CompositeTrackingDemo analog: cascade, pyramidal and parallel
trackers (port of `examples/composite_tracking_demo.py`).

Reference: `Examples/cpp/CompositeTrackingDemo.cc`. Three composites
track the same synthetic 8-DOF sequence and report each one's mean
corner distance:

  * `pyr`  — image-pyramid coarse-to-fine tracking
  * `casc` — particle filter -> FCLK cascade (stochastic seeding + refine)
  * `prl`  — parallel {ESM, FCLK} fused by mean corners

    python -m mtf_tpu_torch.examples.composite_tracking_demo [--device cpu]
"""
import argparse

import numpy as np

# {name: per-frame mean corner errors (px)} of the last run
LAST_ERRORS: dict = {}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; cpu for a CPU "
                        "run)")
    args = p.parse_args(argv)

    from mtf_tpu_torch import _device, create_tracker
    from mtf_tpu_torch.ssm import get_ssm
    from mtf_tpu_torch.utils import synth

    dev = _device.resolve(args.device)
    rng = np.random.default_rng(0)
    raw = np.cumsum(np.cumsum(rng.normal(0, 1, (240, 320)), 0), 1)
    img = ((raw - raw.min()) / (raw.max() - raw.min()) * 255.0).astype(
        np.float32)
    corners0 = np.array([[110, 80], [210, 80], [210, 160], [110, 160]],
                        np.float32)
    frames, gt = synth.synthetic_sequence(img, corners0,
                                          get_ssm("8", device=dev),
                                          n_frames=10, sigma_scale=0.02,
                                          seed=3)

    # the options as the JAX demo passes them (`base_sm` and `n_levels`
    # are read by neither factory)
    trackers = {
        "pyr(esm/ncc/8)": create_tracker(
            "pyr", "ncc", "8", device=dev, base_sm="esm", n_levels=3,
            max_iters=15),
        "casc(pf->fclk)": create_tracker(
            "casc", "ssd", "8", device=dev,
            members=[("pf", "ssd", "8"), ("fclk", "ssd", "8")]),
        "prl(esm|fclk)": create_tracker(
            "prl", "ncc", "8", device=dev,
            members=[("esm", "ncc", "8"), ("fclk", "ncc", "8")]),
    }

    LAST_ERRORS.clear()
    for name, trk in trackers.items():
        state = trk.initialize(frames[0], gt[0][None])
        errs = []
        for t in range(1, len(frames)):
            state = trk.update(state, frames[t])
            c = trk.corners(state)[0].T.cpu().numpy()
            errs.append(float(np.mean(np.linalg.norm(c - gt[t], axis=-1))))
        LAST_ERRORS[name] = errs
        print(f"{name:18s} mean MCD {np.mean(errs):6.3f} px   "
              f"max {np.max(errs):6.3f} px")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
