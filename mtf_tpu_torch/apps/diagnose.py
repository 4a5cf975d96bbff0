"""diagnoseMTF analog: the derivative diagnostics CLI (port of
`mtf_tpu/apps/diagnose.py`).

Reference: `Examples/cpp/diagnoseMTF.cc` (sweeps any AM x SSM pair and
writes the curve files). Runs on the card unless `--device` names
another device; `--validate` and `--validate_chain` exit 0 on OK.

Usage:
    python -m mtf_tpu_torch.apps.diagnose --am ncc --ssm 8 [--image path]
        [--span 0.1] [--validate] [--out_dir log]
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--am", default="ssd")
    p.add_argument("--ssm", default="8")
    p.add_argument("--ilm", default=None)
    p.add_argument("--image", help="image file (synthetic if omitted)")
    p.add_argument("--resx", type=int, default=25)
    p.add_argument("--resy", type=int, default=25)
    p.add_argument("--span", type=float, default=0.1)
    p.add_argument("--n_pts", type=int, default=21)
    p.add_argument("--validate", action="store_true")
    p.add_argument("--validate_chain", action="store_true",
                   help="validate the production LK Jacobian chain "
                        "(StdJac/ESMJac/GN-Hessian ADT analogs)")
    p.add_argument("--data_type", default="norm",
                   choices=["norm", "likelihood", "feat_norm"],
                   help="sweep quantity (ADT selector analog)")
    p.add_argument("--prec", type=float, default=1e-2)
    p.add_argument("--out_dir", default="log")
    p.add_argument("--plot", action="store_true",
                   help="render sweep curves to <out_dir>/<base>.png")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; cpu for a CPU "
                        "run)")
    args = p.parse_args(argv)

    from mtf_tpu_torch import _device
    from mtf_tpu_torch.am import AMParams, get_am
    from mtf_tpu_torch.diagnostics import Diagnostics, DiagnosticsReport
    from mtf_tpu_torch.ssm import get_ssm

    dev = _device.resolve(args.device)
    if args.image:
        from mtf_tpu_torch.utils.input import load_image
        img = load_image(args.image)
    else:
        rng = np.random.default_rng(0)
        raw = np.cumsum(np.cumsum(rng.normal(0, 1, (240, 320)), 0), 1)
        img = (raw - raw.min()) / (raw.max() - raw.min()) * 255.0
    img = torch.as_tensor(np.asarray(img, np.float32), device=dev)
    h, w = img.shape[:2]
    cx, cy, s = w / 2, h / 2, min(h, w) / 4
    corners = torch.tensor([[cx - s, cy - s], [cx + s, cy - s],
                            [cx + s, cy + s], [cx - s, cy + s]], device=dev)

    am = get_am(args.am, AMParams(resx=args.resx, resy=args.resy),
                ilm=args.ilm)
    diag = Diagnostics(am, get_ssm(args.ssm, device=dev))

    if args.validate_chain:
        res = diag.validate_chain(img, corners, prec=args.prec)
        print(f"{args.am} x {args.ssm} chain: " + "  ".join(
            f"{k}={v:.2e}" for k, v in res.items() if k != "ok")
            + f" -> {'OK' if res['ok'] else 'FAIL'}")
        return 0 if res["ok"] else 1
    if args.validate:
        rep = diag.validate(img, corners, prec=args.prec, span=args.span,
                            n_pts=args.n_pts)
        print(f"{rep.am} x {rep.ssm}: max |jac_ad - jac_fd| = "
              f"{rep.max_jac_err:.2e}, max |hess_ad - hess_fd| = "
              f"{rep.max_hess_err:.2e} -> {'OK' if rep.ok else 'FAIL'}")
        base = diag.write_curves(rep, args.out_dir)
        print(f"curves written to {args.out_dir}/{base}_dim*.txt")
        if args.plot:
            png = diag.plot_curves(rep, os.path.join(args.out_dir,
                                                     f"{base}.png"))
            print(f"plot written to {png}")
        return 0 if rep.ok else 1
    sweeps = diag.sweep(img, corners, args.span, args.n_pts,
                        data_type=args.data_type)
    for d, (xs, ys) in sweeps.items():
        print(f"dim {d}: f({xs[0]:+.3f})={ys[0]:.4f}  f(0)="
              f"{ys[len(ys) // 2]:.4f}  f({xs[-1]:+.3f})={ys[-1]:.4f}")
    if args.plot:
        rep = DiagnosticsReport(am=args.am, ssm=args.ssm, sweeps=sweeps)
        base = f"diag_{args.am.lower()}_{args.ssm}"
        png = diag.plot_curves(rep, os.path.join(args.out_dir,
                                                 f"{base}.png"))
        print(f"plot written to {png}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
