"""One step of every sharded path on the current world (the port's
counterpart of the JAX package's multi-device dry run,
`__graft_entry__.dryrun_multichip`).

Every rank of an initialised world (`multihost.init_distributed`) calls

    dryrun()                 # on the card; device="cpu" under gloo

which steps, on tiny shapes and meshes as wide as the world:
tracker-fleet data parallelism, the particle-sharded PF with its
all-gathered resampling, the sample-sharded NN search, the patch- and
hypothesis-sharded grid inside RKLT, and the pixel-sharded Gauss-Newton
step with its summed normal equations. Each path's result must be
finite; each is returned as numpy, on the ranks of its mesh.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from mtf_tpu_torch._device import resolve


def toy_frame(h: int = 64, w: int = 80, seed: int = 0) -> np.ndarray:
    """A smooth random (h, w) float32 scene on 0-255."""
    rng = np.random.default_rng(seed)
    img = np.cumsum(np.cumsum(rng.normal(0, 1, (h, w)), 0), 1)
    return ((img - img.min()) / (img.max() - img.min()) * 255.0).astype(
        np.float32)


def _finite(name: str, x: torch.Tensor) -> np.ndarray:
    out = x.detach().cpu().numpy()
    if not np.isfinite(out).all():
        raise RuntimeError(f"dry run: {name} step produced non-finite "
                           "values")
    return out


def dryrun(device=None, width: int | None = None) -> dict:
    """One step of each sharded path, on meshes of `width` ranks (default
    the world's size; the other ranks skip each path): {"fleet": (n, 2, 4)
    corners of its n = width trackers, "pf", "nn", "rklt": (1, 2, 4)
    corners, "gn": the (1, 8) state after the step}."""
    from mtf_tpu_torch import create_tracker
    from mtf_tpu_torch.parallel import (ShardedGridTracker, ShardedNN,
                                        ShardedPF, TrackerFleet, make_mesh,
                                        sharded_gn_step)
    from mtf_tpu_torch.sm.composite import RKLT, RKLTParams
    from mtf_tpu_torch.sm.grid import GridParams
    from mtf_tpu_torch.sm.nn import NNParams
    from mtf_tpu_torch.sm.pf import PFParams

    device = resolve(device)
    n = width or dist.get_world_size()
    frame0, frame1 = toy_frame(), toy_frame(seed=1)
    corners = np.stack([
        np.asarray([[12 + 2 * i, 12], [44 + 2 * i, 12], [44 + 2 * i, 44],
                    [12 + 2 * i, 44]], np.float32) for i in range(n)])
    meshes = {ax: make_mesh({ax: n}, device.type)
              for ax in ("tracker", "particle", "sample", "patch")}
    if meshes["tracker"].get_coordinate() is None:
        return {}
    out = {}

    def sm_(key, am, ssm, **kw):
        return create_tracker(key, am, ssm, resx=8, resy=8, device=device,
                              **kw)

    # 1. data parallel: a fleet of n trackers, one per rank
    fleet = TrackerFleet(sm_("esm", "ncc", "8", max_iters=3),
                         meshes["tracker"])
    states = fleet.update(fleet.initialize(frame0, corners), frame1)
    out["fleet"] = _finite("fleet", fleet.corners(states))

    # 2. particle parallel: the PF with its particles sharded and the
    #    multi-distribution adaptive sampler
    base = sm_("fclk", "ssd", "2")
    spf = ShardedPF(base.am, base.ssm, base.prm, PFParams(
        n_particles=8 * n, seed=0, ssm_sigmas=((0.01, 0.01), (0.05, 0.05))),
        mesh=meshes["particle"])
    st = spf.update(spf.initialize(frame0, corners[:1]), frame1)
    out["pf"] = _finite("pf", spf.corners(st))

    # 3. sample parallel: the NN dataset sharded, per-rank argmin and the
    #    all-gathered (distance, index) candidates
    snn = ShardedNN(base.am, base.ssm, base.prm,
                    NNParams(n_samples=16 * n, seed=0),
                    mesh=meshes["sample"])
    st = snn.update(snn.initialize(frame0, corners[:1]), frame1)
    out["nn"] = _finite("nn", snn.corners(st))

    # 4. patch and hypothesis parallel: the sharded grid's RANSAC inside
    #    RKLT
    base8 = sm_("fclk", "ssd", "8")
    grid = ShardedGridTracker(
        base8.am, base8.ssm, base8.prm,
        GridParams(grid_res=4, patch_res=6, sub_iters=3, pyramid_levels=1,
                   n_hyps=8 * n, seed=0), mesh=meshes["patch"])
    rklt = RKLT(grid, sm_("esm", "ncc", "8", max_iters=3), RKLTParams())
    st = rklt.update(rklt.initialize(frame0, corners[:1]), frame1)
    out["rklt"] = _finite("rklt", rklt.corners(st))

    # 5. pixel parallel: the patch's pixels sharded, J^T J and J^T r
    #    summed over the ranks
    st = sharded_gn_step(base8, base8.initialize(frame0, corners[:1]),
                         frame1, meshes["particle"], axis="particle")
    out["gn"] = _finite("gn", st.ssm_state)
    return out
