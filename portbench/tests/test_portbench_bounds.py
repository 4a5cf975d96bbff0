"""The roofline shares: least time over device time, computed from the
frozen byte and operation counts, never above 100% of the chip's peak at
the cells' shapes."""
import numpy as np
import pytest
import torch

from portbench.lib import bounds, generator, registry
from portbench.lib import trace as tr
from portbench.reference import _plain as P

# device ms per launch on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md's
# kernel table, CUDA-graph replays): the chain kernel (K1, SSD, linear)
# at N = 169, 625, 2500 with B = 1280 and 144 px windows; K5 at Median
# Flow's shapes (B = 384, 100 patches of 64 points, 20 iterations), six
# launches an update
K1_MS = {169: 0.0082, 625: 0.0276, 2500: 0.0760}
K5_MF_MS = 1.1735 / 6


def _trace(least_ms, device_ms, name="lk_fused_chain_kernel<...>"):
    t = tr.TraceData(profiled_steps=2, probe_steps=2)
    t.device_ops = [(name, 0.0, device_ms * 1e3)] * 2
    t.bounds = {"m": [least_ms] * 2}
    return t


def test_share_is_least_over_device_time():
    assert tr.roofline_pct(_trace(1.0, 1.0), "m", ("lk_fused",)) == 100.0
    assert tr.roofline_pct(_trace(1.0, 4.0), "m", ("lk_fused",)) == 25.0
    assert tr.roofline_pct(_trace(1.0, 4.0), "m", ("grid_flow",)) is None
    assert tr.roofline_pct(tr.TraceData(profiled_steps=1), "m",
                           ("lk_fused",)) is None


def _chain_args(b, stride):
    """The chain kernel's operands at the cell's per-tracker shapes: 144 px
    windows around the mix's targets, the identity warp."""
    mix = registry.traffic("streams")
    c = torch.as_tensor(generator.targets(b, mix["targets"],
                                          generator.rng(3, 1)))
    norm = P.norm_frame(c)
    r = torch.linspace(-0.5, 0.5, 50)
    gy, gx = torch.meshgrid(r, r, indexing="ij")
    unit = torch.stack([gx.reshape(-1), gy.reshape(-1)], -1)
    sq = torch.tensor([[-0.5, -0.5], [0.5, -0.5], [0.5, 0.5], [-0.5, 0.5]])
    pts = P.apply(P.inv_norm(norm), P.apply(P.four_point(
        sq.expand(b, 4, 2), c), unit.expand(b, -1, -1)))
    idx = (torch.arange(0, 50, stride)[:, None] * 50
           + torch.arange(0, 50, stride)[None]).reshape(-1)
    ph = torch.cat([pts[:, idx], torch.ones(b, len(idx), 1)], -1)
    img = P.apply(norm, pts)
    x0 = P.crop_origin(img[..., 0], 144, 640, 4.0)
    y0 = P.crop_origin(img[..., 1], 144, 480, 4.0)
    m0 = norm.clone()
    m0[:, 0] -= x0[:, None] * m0[:, 2]
    m0[:, 1] -= y0[:, None] * m0[:, 2]
    win = torch.rand(b, 144, 144) * 255
    return (win, m0, P.generators("cpu"), ph.transpose(1, 2).contiguous(),
            torch.rand(b, len(idx)))


@pytest.mark.parametrize("stride,n", [(4, 169), (2, 625), (1, 2500)])
def test_chain_share_under_peak(stride, n):
    args = _chain_args(1280, stride)
    assert args[3].shape[-1] == n
    ms, kind, nbytes, flops = bounds.chain_bound_ms(*args)
    # the window pixels the taps cover, never more than the windows hold
    assert nbytes < 4 * (1280 * 144 * 144 + 1280 * 40 * n)
    assert ms <= K1_MS[n], (ms, kind)
    assert 100.0 * ms / K1_MS[n] <= 100.0


def test_k5_share_under_peak():
    b, p, n, it = 384, 100, 64, 20
    win = torch.rand(b, 160, 160)
    pts = torch.rand(b, 2, p * n) * 100 + 30
    disp = torch.rand(b, p, 2) * 0.01
    ms, kind, nbytes, flops = bounds.k5_bound_ms(
        disp, win, pts, torch.rand(b, p * n), torch.full((b,), 60.0), n, it)
    assert kind == "operations"
    assert flops == 60 * b * p * n * it
    assert np.isclose(ms, flops / bounds.F32_FLOPS_PER_S * 1e3)
    assert ms <= K5_MF_MS
