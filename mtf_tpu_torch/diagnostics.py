"""Diagnostics: derivative sweeps of any AM x SSM pair (port of
`mtf_tpu/diagnostics.py`).

Re-designs the reference's unit-test machinery (`Diagnostics/src/
Diagnostics.cc`, driven by `Examples/cpp/diagnoseMTF.cc:37,309-360`):
sweep the similarity along each state dimension, compare the analytic
Jacobian and Hessian against central finite differences in float32, and
report agreement within a precision. As in the JAX package, one
differentiable energy stands in for the reference's 13 hand-derived
analytic data types,

    E(dp) = f(am_state, sample(frame, warp(identity . dp, pts))),

differentiated by `torch.func` (`grad`, `hessian`, `jacfwd`) in place of
JAX's AD. The tensors live on the device of the SSM.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch
from torch.utils import _pytree as pytree

from mtf_tpu_torch.ops import interp
from mtf_tpu_torch.ops import warp as W


@dataclass
class DiagnosticsReport:
    am: str
    ssm: str
    sweeps: dict = field(default_factory=dict)     # dim -> (xs, f(xs))
    jac_analytic: np.ndarray | None = None
    jac_numeric: np.ndarray | None = None
    hess_analytic: np.ndarray | None = None
    hess_numeric: np.ndarray | None = None
    max_jac_err: float = 0.0
    max_hess_err: float = 0.0
    ok: bool = True


def _expand(tree, m: int):
    """Every tensor leaf of a one-tracker tree (leading axis 1) repeated
    to m trackers."""
    return pytree.tree_map(
        lambda x: x.expand((m,) + tuple(x.shape[1:]))
        if isinstance(x, torch.Tensor) and x.dim() >= 1 and x.shape[0] == 1
        else x, tree)


def _offset_dp(ssm, device) -> torch.Tensor:
    """The seeded off-optimum offset (1, S) both checks start from: at the
    init state the gradient is exactly zero (template == patch), and a
    finite-difference quotient there is pure truncation noise."""
    S = ssm.dof
    rng = np.random.default_rng(0)
    return torch.as_tensor(0.02 * rng.standard_normal(S) / np.sqrt(S),
                           dtype=torch.float32, device=device)[None]


class Diagnostics:
    """Sweep and validate one AM x SSM pair on one frame and region.

    `validation_prec` mirrors `enable_validation` / `validation_prec`
    (Diagnostics.cc:131-200)."""

    def __init__(self, am, ssm, resx: int | None = None,
                 resy: int | None = None, interp_kind: str = "cubic_bspl",
                 border: str = "replicate"):
        # the C2 cubic B-spline by default: finite-difference Hessians
        # converge only for a twice-differentiable interpolant
        self.am = am
        self.ssm = ssm
        self.resx = resx or am.prm.resx
        self.resy = resy or am.prm.resy
        self.interp_kind = interp_kind
        self.border = border

    @property
    def device(self) -> torch.device:
        return self.ssm.device

    def _frame(self, frame) -> torch.Tensor:
        return torch.as_tensor(frame, dtype=torch.float32, device=self.device)

    def _region(self, corners):
        from mtf_tpu_torch.sm.core import make_region
        c = torch.as_tensor(corners, dtype=torch.float32, device=self.device)
        return make_region(c.reshape(1, 4, 2), self.resx, self.resy)

    def _energy_fn(self, frame, corners, data_type: str = "norm"):
        """E(dp (M, S)) -> (M,), one value per state perturbation."""
        frame = self._frame(frame)
        region = self._region(corners)
        pts0 = W.apply_warp(region.norm_mat, region.base_pts)
        patch0 = interp.sample(frame, pts0, self.interp_kind, self.border)
        am_state = self.am.init(patch0)
        feat0 = (self.am.dist_feat(patch0) if data_type == "feat_norm"
                 else None)
        if data_type not in ("norm", "likelihood", "feat_norm"):
            raise ValueError(f"unknown data_type {data_type!r}")

        def E(dp):
            m = dp.shape[0]
            rg = _expand(region, m)
            pts_t = self.ssm.warp_pts_from(self.ssm.identity((m,)), dp,
                                           rg.base_pts)
            patch = interp.sample(frame, W.apply_warp(rg.norm_mat, pts_t),
                                  self.interp_kind, self.border)
            st = _expand(am_state, m)
            if data_type == "norm":
                return self.am.f(st, patch)
            if data_type == "likelihood":
                return self.am.likelihood(st, patch)
            return torch.linalg.vector_norm(self.am.dist_feat(patch) - feat0,
                                            dim=-1)

        return E

    def sweep(self, frame, corners, span: float = 0.1, n_pts: int = 21,
              dims=None, data_type: str = "norm") -> dict:
        """Curves along each state dim, the n_pts perturbations of one dim
        as one batch. `data_type` mirrors the reference's analytic-data-
        type selector (ADT, Diagnostics.h:32-39): `norm` = the similarity
        f, `likelihood` = the PF measurement density, `feat_norm` = the L2
        norm of the NN distance feature's difference from the
        template's."""
        E = self._energy_fn(frame, corners, data_type)
        dims = range(self.ssm.dof) if dims is None else dims
        out = {}
        xs = np.linspace(-span, span, n_pts).astype(np.float32)
        with torch.no_grad():
            for d in dims:
                dps = np.zeros((n_pts, self.ssm.dof), np.float32)
                dps[:, d] = xs
                out[d] = (xs, E(torch.as_tensor(
                    dps, device=self.device)).cpu().numpy())
        return out

    def validate(self, frame, corners, eps: float = 1e-3,
                 prec: float = 2.5e-2, hess_prec: float = 1e-1,
                 span: float = 0.1, n_pts: int = 11) -> DiagnosticsReport:
        """The AD Jacobian and Hessian against central finite differences
        (NDT::Jacobian / Hessian, Diagnostics.cc's sweep and compare), at
        a seeded offset from the init state."""
        E0 = self._energy_fn(frame, corners)
        S = self.ssm.dof
        dp0 = _offset_dp(self.ssm, self.device)

        def E(dp):
            return E0(dp0 + dp[None])[0]

        z = torch.zeros((S,), device=self.device)
        jac = torch.func.grad(E)(z).detach().cpu().numpy()
        hess = torch.func.hessian(E)(z).detach().cpu().numpy()
        gradE = torch.func.grad(E)

        def unit(i):
            e = torch.zeros((S,), device=self.device)
            e[i] = eps
            return e

        jac_fd = np.zeros(S, np.float64)
        hess_fd = np.zeros((S, S), np.float64)
        for i in range(S):
            e = unit(i)
            with torch.no_grad():
                jac_fd[i] = (float(E(e)) - float(E(-e))) / (2 * eps)
            hess_fd[:, i] = (gradE(e).detach().cpu().numpy().astype(np.float64)
                             - gradE(-e).detach().cpu().numpy()) / (2 * eps)

        scale_j = max(1.0, float(np.abs(jac_fd).max()))
        scale_h = max(1.0, float(np.abs(hess_fd).max()))
        max_jac_err = float(np.abs(jac - jac_fd).max()) / scale_j
        max_hess_err = float(np.abs(hess - hess_fd).max()) / scale_h
        return DiagnosticsReport(
            am=type(self.am).__name__, ssm=self.ssm.name,
            sweeps=self.sweep(frame, corners, span, n_pts),
            jac_analytic=jac, jac_numeric=jac_fd,
            hess_analytic=hess, hess_numeric=hess_fd,
            max_jac_err=max_jac_err, max_hess_err=max_hess_err,
            ok=(max_jac_err < prec and max_hess_err < hess_prec))

    def validate_chain(self, frame, corners, prec: float = 1e-2) -> dict:
        """The production Jacobian path of the LK update against AD of the
        energy (the reference's hand-derived StdJac / ESMJac / Hessian ADTs,
        Diagnostics.h:32-39):
          std_jac  : the chain gradient df/dpatch . (grad I . dW/dp)
                     (`LKBase._patch_and_jac`) against torch.func.grad
                     of the energy;
          esm_jac  : at the template, the mean of the template-side and
                     current Jacobians equals the current one;
          gn_hess  : the chain's Gauss-Newton Hessian against the AM's
                     helper on the same J, and its symmetry."""
        from mtf_tpu_torch.am.base import gn_hessian
        from mtf_tpu_torch.sm.core import SMParams
        from mtf_tpu_torch.sm.lk import SM_LK_REGISTRY

        am, ssm = self.am, self.ssm
        sm = SM_LK_REGISTRY["fclk"](am, ssm, SMParams(
            interp=self.interp_kind, border=self.border))
        frame = sm._frame(self._frame(frame))
        region = self._region(corners)
        pts0 = W.apply_warp(region.norm_mat, region.base_pts)
        am_state = am.init(interp.sample(frame, pts0, self.interp_kind,
                                         self.border))
        S, Q = ssm.dof, sm._q_dim
        s0 = ssm.compositional_update(ssm.identity((1,)),
                                      _offset_dp(ssm, self.device))
        p_am = am.ilm.identity_params((1,), device=self.device)

        def rel(a, b):
            return float(np.abs(a - b).max()) / max(1.0,
                                                     float(np.abs(b).max()))

        # the production chain at s0
        patch, J = sm._patch_and_jac(region, s0, p_am, frame, None)
        j_chain = (am.grad_corrected(am_state, patch).reshape(1, 1, -1)
                   @ J)[0, 0, :S].detach().cpu().numpy()
        # AD: d/ddp f(am_state, sample(warp(s0 . dp)))
        fn = sm._patch_fn(region, s0, p_am, frame, None)
        j_ad = torch.func.grad(lambda q: am.f_corrected(am_state, fn(q)).sum())(
            torch.zeros((1, Q), device=self.device))[0, :S].cpu().numpy()
        std_jac_err = rel(j_chain, j_ad)

        # ESM at the template: J0 == Jt, so their mean equals Jt
        _, Jt = sm._patch_and_jac(region, ssm.identity((1,)), p_am, frame,
                                  None)
        J0 = torch.func.jacfwd(sm._template_patch_fn(region, frame))(
            torch.zeros((1, Q), device=self.device)).reshape(-1, Q)
        Jt = Jt[0].detach().cpu().numpy()
        Jm = 0.5 * (J0.detach().cpu().numpy() + Jt)
        esm_jac_err = rel(Jm, Jt)

        # the GN Hessian: the chain's contraction against the AM helper
        H_chain = sm._hess_contract(am_state, patch, J)[0].detach().cpu() \
            .numpy()
        H_ref = gn_hessian(am, am_state, patch, J)[0].detach().cpu().numpy()
        gn_hess_err = rel(H_chain, H_ref)
        sym_err = rel(H_chain, H_chain.T)
        return {
            "std_jac_err": std_jac_err,
            "esm_jac_err": esm_jac_err,
            "gn_hess_err": gn_hess_err,
            "hess_sym_err": sym_err,
            "ok": bool(std_jac_err < prec and esm_jac_err < prec
                       and gn_hess_err < prec and sym_err < prec),
        }

    def write_curves(self, report: DiagnosticsReport, out_dir: str = "log"):
        """Write the sweep curves in the reference's data-file style
        (graphUtils / `diagnoseMTF` artifacts)."""
        import os
        os.makedirs(out_dir, exist_ok=True)
        base = f"diag_{report.am.lower()}_{report.ssm}"
        for d, (xs, ys) in report.sweeps.items():
            np.savetxt(os.path.join(out_dir, f"{base}_dim{d}.txt"),
                       np.stack([xs, ys], axis=1), fmt="%.6e")
        return base

    def plot_curves(self, report: DiagnosticsReport, out_path: str):
        """Render the per-dimension sweeps to one figure (the curves
        `diagnoseMTF` shows live)."""
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        dims = sorted(report.sweeps)
        ncol = min(4, max(1, len(dims)))
        nrow = (len(dims) + ncol - 1) // ncol
        fig, axes = plt.subplots(nrow, ncol, squeeze=False,
                                 figsize=(3.2 * ncol, 2.6 * nrow))
        for i, d in enumerate(dims):
            ax = axes[i // ncol][i % ncol]
            xs, ys = report.sweeps[d]
            ax.plot(xs, ys, lw=1.2)
            ax.axvline(0.0, color="0.7", lw=0.6)
            ax.set_title(f"dim {d}", fontsize=9)
            ax.tick_params(labelsize=7)
        for j in range(len(dims), nrow * ncol):
            axes[j // ncol][j % ncol].axis("off")
        fig.suptitle(f"{report.am} x {report.ssm} similarity sweeps",
                     fontsize=11)
        fig.tight_layout()
        fig.savefig(out_path, dpi=110)
        plt.close(fig)
        return out_path
