"""Pixel-sharded Gauss-Newton: intra-patch parallelism over a mesh axis
(port of `mtf_tpu/parallel/patch_shard.py`).

Each rank samples its N/n of the patch's points from the (replicated)
frame and builds their pixel Jacobian (the warp's forward-mode columns
chained with one value-and-gradient sample, as the LK generic path),
the O(N) part. Two reductions follow:

  * `local`, for the pointwise-residual AMs (SSD, SAD): the partial
    normal equations H_k = J_k^T J_k, g_k = J_k^T r_k are summed over
    the ranks (`all_reduce(SUM)`: S^2 + S floats a tracker), and the
    (S, S) solve runs replicated;
  * `gather`, exact for every AM, patch-global ones included (NCC's
    normalisation, MI's histograms, SSIM's moments): the patch blocks
    and Jacobian blocks are all-gathered and the AM's gradient and the
    Gauss-Newton Hessian in the self flavour (one Hessian-vector product
    per column, `sm/lk.hess_contract`) run replicated on the whole
    patch, as the single-device step computes them.

`mode="auto"` takes `local` for SSD and SAD, `gather` otherwise.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from mtf_tpu_torch.ops import interp
from mtf_tpu_torch.ops import warp as W
from mtf_tpu_torch.ops.linalg import neg_def_solve
from mtf_tpu_torch.parallel.mesh import all_reduce, axis_shard
from mtf_tpu_torch.sm.core import TrackerState
from mtf_tpu_torch.sm.lk import hess_contract

_POINTWISE_AMS = ("ssd", "sad")


def sharded_gn_step(sm, state: TrackerState, frame, mesh,
                    axis: str = "pixel", mode: str = "auto") -> TrackerState:
    """One forward-compositional Gauss-Newton step of the B trackers of
    `state` with the pixel axis sharded over `mesh[axis]`; `sm` supplies
    the AM, SSM and parameters. Returns the state after the step. `mode`:
    "local" | "gather" | "auto" (module docstring)."""
    am, ssm, prm = sm.am, sm.ssm, sm.prm
    S = ssm.dof
    sh = axis_shard(mesh, axis)
    base_pts = state.region.base_pts
    B, N = base_pts.shape[:2]
    if N % sh.size != 0:
        raise ValueError(f"patch size {N} not divisible by mesh axis "
                         f"{axis!r} size {sh.size}")
    if mode == "auto":
        mode = "local" if am.name in _POINTWISE_AMS else "gather"
    if mode not in ("local", "gather"):
        raise ValueError(f"unknown mode {mode!r}")
    frame = torch.as_tensor(frame, dtype=torch.float32, device=sm.device)
    rows = sh.rows(N)
    Ms = ssm.to_matrix(state.ssm_state)
    norm_mat = state.region.norm_mat
    pts_blk = base_pts[:, rows]

    def pts_of(dp):
        M = Ms @ ssm.to_matrix(dp)
        return W.apply_warp(norm_mat, W.apply_warp(M, pts_blk))

    zero = state.ssm_state.new_zeros(B, S)
    basis = torch.eye(S, dtype=zero.dtype, device=zero.device)[
        :, None, :].expand(S, B, S)
    Jpts = torch.func.vmap(lambda t: torch.func.jvp(pts_of, (zero,), (t,))[1],
                           out_dims=-1)(basis)               # (B, nb, 2, S)
    blk, grad = interp.sample_val_grad(frame, pts_of(zero), prm.interp,
                                       prm.border)           # (B, nb, C)
    J = torch.einsum("bncd,bnds->bncs", grad, Jpts)          # (B, nb, C, S)
    eye = torch.eye(S, dtype=J.dtype, device=J.device)
    if mode == "local":
        J = J.flatten(1, 2)
        templ = state.am_state.template.reshape(B, N, -1)[:, rows]
        r = (templ - blk).flatten(1)
        H = all_reduce(J.transpose(1, 2) @ J, dist.ReduceOp.SUM, sh.group)
        g = all_reduce((r[:, None] @ J)[:, 0], dist.ReduceOp.SUM, sh.group)
        dp = torch.linalg.solve(H + 1e-7 * eye, g)
    else:
        patch = sh.gather(blk, 1)                             # (B, N, C)
        J_full = sh.gather(J, 1).flatten(1, 2)                # (B, N·C, S)
        # the patch-global similarity math, replicated on the whole patch
        gI = am.grad_corrected(state.am_state, patch).flatten(1)
        j = (gI[:, None] @ J_full)[:, 0]
        # the Gauss-Newton Hessian in the self flavour (at a perfect
        # match: negative-definite for every AM)
        H = hess_contract(am, am.self_state(patch, state.am_state.p_am),
                          patch, J_full)
        dp = neg_def_solve(H - 1e-7 * eye, j)
    return state._replace(
        ssm_state=ssm.compositional_update(state.ssm_state, dp))
