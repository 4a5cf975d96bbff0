"""WarpingDemo analog: each SSM's warp space (port of
`examples/warping_demo.py`).

Reference: `Examples/cpp/WarpingDemo.cc` — perturb an SSM's state and
show the warped patch. For each requested SSM: draw random state
perturbations (a generator seeded 0), resample the region under each
warp on the card unless `--device` names another device, and write a
contact sheet per SSM (drawn with OpenCV) under `log/warping_demo/` in
the current directory.

    python -m mtf_tpu_torch.examples.warping_demo [image] \
        [--ssms 2,4,6,8,sl3] [--device cpu]
"""
import argparse
import os

import numpy as np
import torch


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("image", nargs="?",
                   help="source image (synthetic if omitted)")
    p.add_argument("--ssms", default="2,4,6,8,sl3")
    p.add_argument("--n", type=int, default=8, help="samples per SSM")
    p.add_argument("--sigma", type=float, default=0.08)
    p.add_argument("--out_dir", default="log/warping_demo")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; cpu for a CPU "
                        "run)")
    args = p.parse_args(argv)

    from mtf_tpu_torch import _device
    from mtf_tpu_torch.ops import interp
    from mtf_tpu_torch.ops import warp as W
    from mtf_tpu_torch.sm.core import make_region
    from mtf_tpu_torch.ssm import get_ssm

    dev = _device.resolve(args.device)
    if args.image:
        from mtf_tpu_torch.utils.input import load_image
        img = np.asarray(load_image(args.image), np.float32)
    else:
        rng = np.random.default_rng(0)
        raw = np.cumsum(np.cumsum(rng.normal(0, 1, (240, 320)), 0), 1)
        img = ((raw - raw.min()) / (raw.max() - raw.min()) * 255.0).astype(
            np.float32)
    img = torch.as_tensor(img, device=dev)
    if img.dim() == 2:
        img = img[..., None]
    h, w = img.shape[:2]
    s = min(h, w) / 4.0
    corners = torch.tensor([[[w/2 - s, h/2 - s], [w/2 + s, h/2 - s],
                             [w/2 + s, h/2 + s], [w/2 - s, h/2 + s]]],
                           device=dev)
    res = 96
    region = make_region(corners, res, res)
    os.makedirs(args.out_dir, exist_ok=True)

    import cv2

    def render(ssm, state):
        pts = W.apply_warp(region.norm_mat,
                           ssm.warp_pts(state, region.base_pts))
        patch = interp.sample(img, pts, "linear")
        return patch[0, :, 0].reshape(res, res).cpu().numpy()

    def sheet(patches, title):
        """The patches side by side under a title bar, 4-px gaps (a
        contact sheet drawn with OpenCV, which both machines have)."""
        gap, bar = 4, 24
        out = np.full((bar + res + gap, len(patches) * (res + gap) + gap),
                      255, np.uint8)
        for i, ptc in enumerate(patches):
            x = gap + i * (res + gap)
            out[bar:bar + res, x:x + res] = np.clip(ptc, 0, 255).astype(
                np.uint8)
        cv2.putText(out, title, (gap, bar - 8), cv2.FONT_HERSHEY_SIMPLEX,
                    0.45, 0, 1, cv2.LINE_AA)
        return out

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    for name in args.ssms.split(","):
        ssm = get_ssm(name, device=dev)
        ident = ssm.identity((1,))
        patches = [render(ssm, ident)]
        for _ in range(args.n):
            dp = args.sigma * torch.randn((1, ssm.dof), generator=gen,
                                          device=dev)
            patches.append(render(ssm, ssm.compositional_update(ident, dp)))
        out = os.path.join(args.out_dir, f"warps_{name}.png")
        cv2.imwrite(out, sheet(patches, f"SSM {name} ({ssm.dof} DOF): "
                                        f"identity, then {args.n} random "
                                        f"warps"))
        print(f"{name}: {ssm.dof} DOF -> {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
