"""Fixed-matrix SSMs (port of `mtf_tpu/ssm/projective.py`; the 8-DOF
homography only in this slice)."""
from __future__ import annotations

import numpy as np
import torch

from mtf_tpu_torch.ssm.base import AdditiveMatrixSSM


def _g(rows) -> np.ndarray:
    return np.asarray(rows, np.float32)


G_TX = _g([[0, 0, 1], [0, 0, 0], [0, 0, 0]])
G_TY = _g([[0, 0, 0], [0, 0, 1], [0, 0, 0]])
G_SX = _g([[1, 0, 0], [0, 0, 0], [0, 0, 0]])
G_SY = _g([[0, 0, 0], [0, 1, 0], [0, 0, 0]])
G_SH1 = _g([[0, 1, 0], [0, 0, 0], [0, 0, 0]])
G_SH2 = _g([[0, 0, 0], [1, 0, 0], [0, 0, 0]])
G_PX = _g([[0, 0, 0], [0, 0, 0], [1, 0, 0]])
G_PY = _g([[0, 0, 0], [0, 0, 0], [0, 1, 0]])


def _norm_h(mat: torch.Tensor) -> torch.Tensor:
    return mat / mat[..., 2:3, 2:3]


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


SSM_REGISTRY = {"hom": Homography, "8": Homography}
