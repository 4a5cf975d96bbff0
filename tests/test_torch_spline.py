"""Port parity: the non-rigid SSMs (`mtf_tpu_torch/ssm/spline.py` against
`mtf_tpu/ssm/spline.py`) and the high-DOF solve they need
(`chol_solve_blocked`, `mtf_tpu/ops/linalg.py:80-166`).

Warped points and the warp Jacobians agree within 1e-5 px; the ridge
fits within 1e-3 of the fit's magnitude (TPS's bending system is ill
conditioned: its float32 inverse carries ~1e-4 relative rounding into the
fit in either package); solves within 1e-4 of the solution's norm.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtf_tpu.ops.linalg import chol_solve_blocked as jchol_blocked
from mtf_tpu.ssm import get_ssm as jget_ssm
from mtf_tpu_torch.ops.linalg import chol_solve_blocked, neg_def_solve
from mtf_tpu_torch.ssm import get_ssm as tget_ssm

SSMS = [("spline", {}), ("spline", {"interp_type": "biquadratic"}),
        ("spline", {"interp_type": "bicubic", "kx": 4, "ky": 3}),
        ("spl", {}), ("tps", {})]
IDS = ["spline", "spline-biquadratic", "spline-bicubic-4x3", "spl", "tps"]


def _inputs(dof, seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-0.6, 0.6, (3, 40, 2)).astype(np.float32)
    state = rng.normal(0, 0.05, (3, dof)).astype(np.float32)
    return pts, state


@pytest.mark.parametrize("key,kw", SSMS, ids=IDS)
def test_warp_and_jacobian_match_jax(key, kw):
    j, t = jget_ssm(key, **kw), tget_ssm(key, device="cpu", **kw)
    assert t.dof == j.dof and t.name == j.name
    pts, state = _inputs(j.dof)
    got = t.warp_pts(torch.tensor(state), torch.tensor(pts)).numpy()
    dw = t.dwdp_at(torch.tensor(state), torch.tensor(pts)).numpy()
    for i in range(3):
        want = j.warp_pts(jnp.asarray(state[i]), jnp.asarray(pts[i]))
        np.testing.assert_allclose(got[i], want, atol=1e-5, rtol=0)
        np.testing.assert_allclose(dw[i], j.dwdp_at(jnp.asarray(state[i]),
                                                    jnp.asarray(pts[i])),
                                   atol=1e-5, rtol=0)
    # the additive update algebra
    s2 = torch.tensor(state[::-1].copy())
    ts = torch.tensor(state)
    assert torch.equal(t.compositional_update(ts, s2), ts + s2)
    assert torch.equal(t.inverse_compositional_update(ts, s2), ts - s2)
    with pytest.raises(TypeError):
        t.to_matrix(ts)


@pytest.mark.parametrize("key,kw", SSMS, ids=IDS)
def test_fit_pts_matches_jax(key, kw):
    j, t = jget_ssm(key, **kw), tget_ssm(key, device="cpu", **kw)
    pts, _ = _inputs(j.dof, seed=1)
    rng = np.random.default_rng(2)
    dst = (pts + rng.normal(0, 0.02, pts.shape)).astype(np.float32)
    w = rng.uniform(0.2, 1.0, pts.shape[:2]).astype(np.float32)
    for weights in (None, w):
        got = t.fit_pts(torch.tensor(pts), torch.tensor(dst),
                        None if weights is None else torch.tensor(weights)
                        ).numpy()
        for i in range(3):
            want = np.asarray(j.fit_pts(
                jnp.asarray(pts[i]), jnp.asarray(dst[i]),
                None if weights is None else jnp.asarray(weights[i])))
            assert np.abs(got[i] - want).max() <= 1e-3 * np.abs(want).max()


@pytest.mark.parametrize("S", [16, 50])
def test_chol_solve_blocked_matches_jax(S):
    """Damped SPD systems, and a singular GN system (a state dim whose
    Jacobian column is 0, as a spline control point with no template
    point in its support: J^T J + the LK solve's 1e-7 ridge, whose pivot
    the clamped Cholesky keeps), give the JAX package's steps (its solve
    batched over both kinds of system in one call)."""
    rng = np.random.default_rng(S)
    M = rng.normal(size=(3, S, S)).astype(np.float32)
    A = (M @ M.transpose(0, 2, 1) + 0.1 * np.eye(S)).astype(np.float32)
    b = rng.normal(size=(3, S)).astype(np.float32)
    J = rng.normal(size=(3, 4 * S, S)).astype(np.float32)
    J[:, :, S // 3] = 0.0
    H = -(J.transpose(0, 2, 1) @ J) - 1e-7 * np.eye(S, dtype=np.float32)
    g = (J.transpose(0, 2, 1) @ rng.normal(size=(3, 4 * S, 1)))[..., 0]
    g = g.astype(np.float32)
    want = np.asarray(jchol_blocked(jnp.asarray(np.concatenate([A, -H])),
                                    jnp.asarray(np.concatenate([b, g]))))
    got = chol_solve_blocked(torch.tensor(A), torch.tensor(b)).numpy()
    assert np.abs(got - want[:3]).max() <= 1e-4 * np.abs(want[:3]).max()
    got = neg_def_solve(torch.tensor(H), torch.tensor(g)).numpy()
    assert np.isfinite(got).all() and (got[:, S // 3] == 0).all()
    assert np.abs(got - want[3:]).max() <= 1e-4 * np.abs(want[3:]).max()
