"""Fixed-matrix SSMs (port of `mtf_tpu/ssm/projective.py`): Translation,
IST, Isometry, AST, Similitude, ASRT, Affine, Homography, the Lie SSMs
(LieIsometry, LieAffine, LieHomography, SL3) and the corner-based CBH,
each a generator basis and a to/from-matrix pair over batched states
(..., S), with the JAX package's closed-form `fit_pts` where it has one.
Factory keys are the reference's (`SSM_REGISTRY`)."""
from __future__ import annotations

import numpy as np
import torch

from mtf_tpu_torch.ops import warp as W
from mtf_tpu_torch.ssm.base import SSM, AdditiveMatrixSSM, ExpSSM


def _g(rows) -> np.ndarray:
    return np.asarray(rows, np.float32)


G_TX = _g([[0, 0, 1], [0, 0, 0], [0, 0, 0]])
G_TY = _g([[0, 0, 0], [0, 0, 1], [0, 0, 0]])
G_ROT = _g([[0, -1, 0], [1, 0, 0], [0, 0, 0]])
G_SC = _g([[1, 0, 0], [0, 1, 0], [0, 0, 0]])
G_SX = _g([[1, 0, 0], [0, 0, 0], [0, 0, 0]])
G_SY = _g([[0, 0, 0], [0, 1, 0], [0, 0, 0]])
G_SH1 = _g([[0, 1, 0], [0, 0, 0], [0, 0, 0]])
G_SH2 = _g([[0, 0, 0], [1, 0, 0], [0, 0, 0]])
G_PX = _g([[0, 0, 0], [0, 0, 0], [1, 0, 0]])
G_PY = _g([[0, 0, 0], [0, 0, 0], [0, 1, 0]])


def _norm_h(mat: torch.Tensor) -> torch.Tensor:
    return mat / mat[..., 2:3, 2:3]


def _mat(a, b, tx, c, d, ty) -> torch.Tensor:
    """(..., 3, 3) warps [[a, b, tx], [c, d, ty], [0, 0, 1]]."""
    z, o = torch.zeros_like(a), torch.ones_like(a)
    return torch.stack([torch.stack([a, b, tx], -1),
                        torch.stack([c, d, ty], -1),
                        torch.stack([z, z, o], -1)], -2)


def _centred(src, dst, weights):
    """Normalised weights (..., N), weighted centroids (..., 2) and the
    centred points of a weighted fit (the JAX package's conventions:
    unit weights by default, the sum floored at 1e-12)."""
    w = torch.ones_like(src[..., 0]) if weights is None else weights
    wn = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-12)
    cs = (src * wn[..., None]).sum(-2)
    cd = (dst * wn[..., None]).sum(-2)
    return wn, cs, cd, src - cs[..., None, :], dst - cd[..., None, :]


def _isometry_matrix(state: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(state[..., 2]), torch.sin(state[..., 2])
    return _mat(c, -s, state[..., 0], s, c, state[..., 1])


def _isometry_fit(src, dst, weights) -> torch.Tensor:
    """Weighted Procrustes without scale -> (tx, ty, theta)."""
    wn, cs, cd, s0, d0 = _centred(src, dst, weights)
    dot = (wn * (s0 * d0).sum(-1)).sum(-1)
    crs = (wn * (s0[..., 0] * d0[..., 1] - s0[..., 1] * d0[..., 0])).sum(-1)
    th = torch.atan2(crs, dot)
    c, s = torch.cos(th), torch.sin(th)
    tx = cd[..., 0] - (c * cs[..., 0] - s * cs[..., 1])
    ty = cd[..., 1] - (s * cs[..., 0] + c * cs[..., 1])
    return torch.stack([tx, ty, th], -1)


class Translation(AdditiveMatrixSSM):
    """2-DOF (tx, ty)."""
    name, dof = "trans", 2

    def _generators(self):
        return np.stack([G_TX, G_TY])

    def from_matrix(self, mat):
        mat = _norm_h(mat)
        return torch.stack([mat[..., 0, 2], mat[..., 1, 2]], -1)

    def fit_pts(self, src, dst, weights=None):
        d = dst - src
        if weights is None:
            return d.mean(-2)
        wsum = torch.clamp(weights.sum(-1, keepdim=True), min=1e-12)
        return (d * weights[..., None]).sum(-2) / wsum


class IST(AdditiveMatrixSSM):
    """3-DOF isotropic scale + translation (tx, ty, s)."""
    name, dof = "ist", 3

    def _generators(self):
        return np.stack([G_TX, G_TY, G_SC])

    def from_matrix(self, mat):
        mat = _norm_h(mat)
        return torch.stack([mat[..., 0, 2], mat[..., 1, 2],
                            0.5 * (mat[..., 0, 0] + mat[..., 1, 1]) - 1.0],
                           -1)

    def fit_pts(self, src, dst, weights=None):
        wn, cs, cd, s0, d0 = _centred(src, dst, weights)
        k = (wn[..., None] * s0 * d0).sum((-2, -1)) / torch.clamp(
            (wn[..., None] * s0 * s0).sum((-2, -1)), min=1e-12)
        t = cd - k[..., None] * cs
        return torch.stack([t[..., 0], t[..., 1], k - 1.0], -1)


class Isometry(SSM):
    """3-DOF SE(2): (tx, ty, theta)."""
    name, dof = "iso", 3

    def _generators(self):
        return np.stack([G_TX, G_TY, G_ROT])

    def to_matrix(self, state):
        return _isometry_matrix(state)

    def from_matrix(self, mat):
        mat = _norm_h(mat)
        th = torch.atan2(mat[..., 1, 0] - mat[..., 0, 1],
                         mat[..., 0, 0] + mat[..., 1, 1])
        return torch.stack([mat[..., 0, 2], mat[..., 1, 2], th], -1)

    def fit_pts(self, src, dst, weights=None):
        return _isometry_fit(src, dst, weights)


class AST(AdditiveMatrixSSM):
    """4-DOF anisotropic scale + translation (tx, ty, sx, sy)."""
    name, dof = "ast", 4

    def _generators(self):
        return np.stack([G_TX, G_TY, G_SX, G_SY])

    def from_matrix(self, mat):
        mat = _norm_h(mat)
        return torch.stack([mat[..., 0, 2], mat[..., 1, 2],
                            mat[..., 0, 0] - 1.0, mat[..., 1, 1] - 1.0], -1)

    def fit_pts(self, src, dst, weights=None):
        # independent weighted 1D regressions per axis
        wn, cs, cd, s0, d0 = _centred(src, dst, weights)
        k = (wn[..., None] * s0 * d0).sum(-2) / torch.clamp(
            (wn[..., None] * s0 * s0).sum(-2), min=1e-12)    # (..., 2)
        t = cd - k * cs
        return torch.stack([t[..., 0], t[..., 1], k[..., 0] - 1.0,
                            k[..., 1] - 1.0], -1)


class Similitude(SSM):
    """4-DOF (tx, ty, s, theta): scale (1 + s), rotation theta."""
    name, dof = "sim", 4

    def _generators(self):
        return np.stack([G_TX, G_TY, G_SC, G_ROT])

    def to_matrix(self, state):
        k = 1.0 + state[..., 2]
        a, b = k * torch.cos(state[..., 3]), k * torch.sin(state[..., 3])
        return _mat(a, -b, state[..., 0], b, a, state[..., 1])

    def from_matrix(self, mat):
        mat = _norm_h(mat)
        a = 0.5 * (mat[..., 0, 0] + mat[..., 1, 1])
        b = 0.5 * (mat[..., 1, 0] - mat[..., 0, 1])
        return torch.stack([mat[..., 0, 2], mat[..., 1, 2],
                            torch.hypot(a, b) - 1.0, torch.atan2(b, a)], -1)


class ASRT(SSM):
    """5-DOF (tx, ty, sx, sy, theta): W = R(theta) diag(1 + sx, 1 + sy)
    + t."""
    name, dof = "asrt", 5

    def _generators(self):
        return np.stack([G_TX, G_TY, G_SX, G_SY, G_ROT])

    def to_matrix(self, state):
        c, s = torch.cos(state[..., 4]), torch.sin(state[..., 4])
        kx, ky = 1.0 + state[..., 2], 1.0 + state[..., 3]
        return _mat(c * kx, -s * ky, state[..., 0], s * kx, c * ky,
                    state[..., 1])

    def from_matrix(self, mat):
        mat = _norm_h(mat)
        th = torch.atan2(mat[..., 1, 0] - mat[..., 0, 1],
                         mat[..., 0, 0] + mat[..., 1, 1])
        c, s = torch.cos(th), torch.sin(th)
        kx = c * mat[..., 0, 0] + s * mat[..., 1, 0]
        ky = -s * mat[..., 0, 1] + c * mat[..., 1, 1]
        return torch.stack([mat[..., 0, 2], mat[..., 1, 2], kx - 1.0,
                            ky - 1.0, th], -1)


class Affine(AdditiveMatrixSSM):
    """6-DOF (tx, ty, a00-1, a01, a10, a11-1)."""
    name, dof = "aff", 6

    def _generators(self):
        return np.stack([G_TX, G_TY, G_SX, G_SH1, G_SH2, G_SY])

    def from_matrix(self, mat):
        mat = _norm_h(mat)
        return torch.stack([mat[..., 0, 2], mat[..., 1, 2],
                            mat[..., 0, 0] - 1.0, mat[..., 0, 1],
                            mat[..., 1, 0], mat[..., 1, 1] - 1.0], -1)


class Homography(AdditiveMatrixSSM):
    """8-DOF, W[2,2] pinned to 1 (tx, ty, h00-1, h01, h10, h11-1, h20, h21)."""
    name, dof = "hom", 8

    def _generators(self):
        return np.stack([G_TX, G_TY, G_SX, G_SH1, G_SH2, G_SY, G_PX, G_PY])

    def from_matrix(self, mat: torch.Tensor) -> torch.Tensor:
        mat = _norm_h(mat)
        return torch.stack([mat[..., 0, 2], mat[..., 1, 2],
                            mat[..., 0, 0] - 1.0, mat[..., 0, 1],
                            mat[..., 1, 0], mat[..., 1, 1] - 1.0,
                            mat[..., 2, 0], mat[..., 2, 1]], dim=-1)


class LieIsometry(ExpSSM):
    """3-DOF SE(2) through the exponential of se(2)."""
    name, dof = "liso", 3

    def _generators(self):
        return np.stack([G_TX, G_TY, G_ROT])

    def fit_pts(self, src, dst, weights=None):
        return self.from_matrix(_isometry_matrix(
            _isometry_fit(src, dst, weights)))


class LieAffine(ExpSSM):
    """6-DOF affine through the exponential of the affine algebra."""
    name, dof = "laff", 6

    def _generators(self):
        return np.stack([G_TX, G_TY, G_SX, G_SH1, G_SH2, G_SY])


class LieHomography(ExpSSM):
    """8-DOF homography through the exponential of sl(3); warps are
    normalised to determinant 1 before the log."""
    name, dof = "lhom", 8

    def _generators(self):
        sym_sh = _g([[0, 1, 0], [1, 0, 0], [0, 0, 0]])
        g_sc = _g([[1, 0, 0], [0, 1, 0], [0, 0, -2]])
        g_an = _g([[1, 0, 0], [0, -1, 0], [0, 0, 0]])
        return np.stack([G_TX, G_TY, G_ROT, g_sc, g_an, sym_sh, G_PX, G_PY])

    def _normalize(self, mat):
        det = torch.linalg.det(mat)
        cbrt = torch.sign(det) * torch.abs(det) ** (1.0 / 3.0)
        return mat / cbrt[..., None, None]


class SL3(LieHomography):
    """The SL(3) key: the same warp group as LieHomography."""
    name = "sl3"


class CBH(SSM):
    """8-DOF corner-based homography: the state is the displacement of the
    4 template-frame corners (dx0, dy0, ..., dx3, dy3). to_matrix is the
    closed-form homography from the unit square onto the displaced
    corners; the generator basis is its Jacobian at 0, by forward-mode
    autodiff (the JAX package's `jax.jacfwd`)."""
    name, dof = "cbh", 8

    def _generators(self):
        jac = torch.func.jacfwd(self.to_matrix)(torch.zeros(8))  # (3, 3, 8)
        return jac.permute(2, 0, 1).detach().numpy()

    def to_matrix(self, state):
        base = W.unit_square_corners(state.dtype, state.device)
        dst = base + state.reshape(state.shape[:-1] + (4, 2))
        return W.homography_from_unit_square(dst)

    def from_matrix(self, mat):
        base = W.unit_square_corners(mat.dtype, mat.device)
        return (W.apply_warp(mat, base.expand(mat.shape[:-2] + (4, 2)))
                - base).flatten(-2)


SSM_REGISTRY = {
    "trans": Translation, "2": Translation,
    "ist": IST, "3s": IST,
    "iso": Isometry, "3": Isometry,
    "liso": LieIsometry, "l3": LieIsometry,
    "ast": AST, "4s": AST,
    "sim": Similitude, "4": Similitude,
    "asrt": ASRT, "5": ASRT,
    "aff": Affine, "6": Affine,
    "laff": LieAffine, "l6": LieAffine,
    "hom": Homography, "8": Homography,
    "lhom": LieHomography, "l8": LieHomography,
    "sl3": SL3,
    "cbh": CBH, "c8": CBH,
}
