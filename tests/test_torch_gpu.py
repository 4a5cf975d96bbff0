"""CUDA-kernel tests of `mtf_tpu_torch`, and the JAX-free input helpers
the kernel tests share: the chain kernel's (SSD and NCC, each with and
without ESM's J0 operand, and multi-channel SSD; linear and cubic taps,
plain or blurred; at every state size), K6's (`lk_fused_gn_t`) and the
grid-flow kernel's (K5, and K5c with cubic taps).

The `gpu` tests skip where there is no CUDA device (the CUDA kernel has
no CPU mode). This file imports neither JAX nor the JAX package, so on a
machine with a card and without JAX it runs on its own:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q
"""
import numpy as np
import pytest
import torch

import chip_smoke as cs
from chip_smoke import oracle_operands
from mtf_tpu_torch.ops import interp
from mtf_tpu_torch.ops.kernels import grid_flow as gf
from mtf_tpu_torch.ops.kernels import lk_fused as tk
from mtf_tpu_torch.ssm import get_ssm
from mtf_tpu_torch.ssm.projective import Homography

HC = WC = 144
N_POINTS = [169, 625, 2500]
# (am, esm) of the kernel instantiations beyond K1
NEW_MODES = [("ncc", False), ("ssd", True), ("ncc", True)]
CUBIC_KINDS = ["cubic", "cubic_bspl"]
# (am, esm, channels) of every chain-kernel mode: the four single-channel
# modes and multi-channel SSD (3 channels)
ALL_MODES = [("ssd", False, 1)] + [m + (1,) for m in NEW_MODES] \
    + [("ssd", False, 3)]


def _window(rng, size=HC):
    img = np.cumsum(np.cumsum(rng.normal(0, 1, (size, size)), 0), 1)
    return ((img - img.min()) / (img.max() - img.min()) * 255.0).astype(
        np.float32)


def chain_inputs(n, b=3, seed=0, size=HC):
    """(window, M0, gens, ph, templ) numpy inputs of the chain kernel for
    b trackers on (size, size) windows (144 by default). Tracker 0 is a
    pure translation of integer base points (exactly integer x
    coordinates, where the dense linear x derivative is 0); the others
    are random near-identity homographies of a normalized grid. Every
    point stays well inside the window, and so inside the TPU kernel's
    128-row bands."""
    rng = np.random.default_rng(seed)
    side = int(round(np.sqrt(n)))
    gens = Homography(device="cpu")._generators()
    win = np.stack([_window(rng, size) for _ in range(b)])
    lin = np.linspace(-0.5, 0.5, side)
    g = np.stack(np.meshgrid(lin, lin), -1).reshape(-1, 2)
    ph = np.tile(np.concatenate([g.T, np.ones((1, n))])[None], (b, 1, 1))
    M0 = np.zeros((b, 3, 3), np.float32)
    sc = size / HC
    norm = np.array([[70.0 * sc, 0, size / 2], [0, 70.0 * sc, size / 2],
                     [0, 0, 1]])
    for i in range(1, b):
        state = rng.normal(0, 0.02, 8).astype(np.float32)
        M0[i] = norm @ (np.eye(3) + np.einsum("s,sij->ij", state, gens))
    k = np.arange(side, dtype=np.float64)
    gi = np.stack(np.meshgrid(k, k), -1).reshape(-1, 2)
    ph[0] = np.concatenate([gi.T, np.ones((1, n))])
    # x exactly integer, y on quarter pixels (both exact in float32): dx
    # is 0 by the dense convention, dy is not, so J stays informative
    t = round(40 * sc)
    M0[0] = [[1, 0, t], [0, 1, t + 0.25], [0, 0, 1]]
    templ = rng.uniform(0, 255, (b, n)).astype(np.float32)
    return win, M0, gens, ph.astype(np.float32), templ


def mode_inputs(n, am, esm, b=3, seed=0, size=HC):
    """`chain_inputs` plus the mode's operands: for NCC the template is
    centred and scaled to unit norm (the kernel's n0), and with ESM a
    random J0 (b, 8, n) on the scale of the pixel Jacobian rides along
    (None without ESM)."""
    win, M0, gens, ph, templ = chain_inputs(n, b, seed, size)
    if am == "ncc":
        c = templ - templ.mean(-1, keepdims=True)
        templ = (c / (np.linalg.norm(c, axis=-1, keepdims=True) + 1e-8)
                 ).astype(np.float32)
    j0 = None
    if esm:
        rng = np.random.default_rng(seed + 100)
        j0 = rng.normal(0, 30.0, (b, 8, n)).astype(np.float32)
    return (win, M0, gens, ph, templ), j0


def mc_inputs(n, c, b=3, seed=0, size=HC):
    """`chain_inputs` for the multi-channel mode: c correlated channels
    per window (the channel-0 window plus a smaller random surface each),
    stacked (b, c, size, size), and a template (b, c, n)."""
    win, M0, gens, ph, _ = chain_inputs(n, b, seed, size)
    rng = np.random.default_rng(seed + 200)
    chans = [win] + [win + 0.4 * np.stack([_window(rng, size)
                                            for _ in range(b)])
                     for _ in range(c - 1)]
    templ = rng.uniform(0, 255, (b, c, n)).astype(np.float32)
    return (np.stack(chans, 1).astype(np.float32), M0, gens, ph, templ)


def all_mode_inputs(n, am, esm, c, b=3, seed=0, size=HC):
    """Inputs of any chain-kernel mode: `mode_inputs`, or `mc_inputs`
    for c > 1 (no J0)."""
    if c > 1:
        return mc_inputs(n, c, b, seed, size), None
    return mode_inputs(n, am, esm, b, seed, size)


# an SSM key of each state size the chain kernel takes
SSM_OF_S = {2: "2", 3: "3s", 4: "4", 5: "5", 6: "6", 8: "8"}
NEW_S = [2, 3, 4, 5, 6]


def ssm_inputs(n, s, am="ssd", esm=False, c=1, b=3, seed=0, size=HC):
    """`all_mode_inputs` at state size s: the generators of the s-DOF SSM
    `SSM_OF_S[s]`, M0 of trackers 1.. through its warp at a random
    near-identity state (tracker 0 keeps its integer translation), and
    with ESM a J0 (b, s, n)."""
    arrays, j0 = all_mode_inputs(n, am, esm, c, b, seed, size)
    win, M0, _, ph, templ = arrays
    ssm = get_ssm(SSM_OF_S[s], device="cpu")
    rng = np.random.default_rng(seed + 300)
    sc = size / HC
    norm = np.array([[70.0 * sc, 0, size / 2], [0, 70.0 * sc, size / 2],
                     [0, 0, 1]], np.float32)
    state = torch.tensor(rng.normal(0, 0.02, (b, s)), dtype=torch.float32)
    M0 = M0.copy()
    M0[1:] = (norm @ ssm.to_matrix(state).numpy())[1:]
    if j0 is not None:
        j0 = rng.normal(0, 30.0, (b, s, n)).astype(np.float32)
    return (win, M0, ssm.generators.numpy(), ph, templ), j0


def gn_inputs(n, s, b=3, seed=0, hw=(180, 220), spread=100.0):
    """K6 numpy operands: b smooth (h, w) images, points (b, 2, n) in a
    `spread`-px square inside the image's middle, a random warp Jacobian
    (b, 2s, n) on the scale of an image-px one, a template (b, n)."""
    rng = np.random.default_rng(seed)
    h, w = hw
    img = np.stack([_window(rng, max(h, w))[:h, :w] for _ in range(b)])
    lo = rng.uniform(20, [w - spread - 20, h - spread - 20], (b, 2))
    pts = lo[:, :, None] + rng.uniform(0, spread, (b, 2, n))
    jac = rng.normal(0, 50.0, (b, 2 * s, n))
    templ = rng.uniform(0, 255, (b, n))
    return [np.ascontiguousarray(a, np.float32)
            for a in (img, pts, jac, templ)]


def k5_inputs(n, b=2, seed=5, hw=64, p=8, scale=20.0, zncc=True):
    """Grid-flow (K5) numpy operands and the planted shift: b smooth
    (hw, hw) windows; p patch centres in the window's middle, each with a
    side x side point lattice of template spacing 1/(side + 1) (the
    patch spans ~0.9 `scale` px); templates sampled from the window at
    the points moved by a shift of up to 1.5 px, standardised per patch
    with `zncc`. Every point and its taps stay inside the window. Returns
    (win (b, hw, hw), pts (b, 2, p*n), templ (b, p*n), scale (b,),
    shift (b, p, 2) px)."""
    rng = np.random.default_rng(seed)
    win = np.stack([_window(rng, hw) for _ in range(b)])
    side = int(round(np.sqrt(n)))
    o = np.linspace(-0.5, 0.5, side) * side / (side + 1) * scale
    off = np.stack(np.meshgrid(o, o), -1).reshape(-1, 2)
    ctr = rng.uniform(hw * 0.3, hw * 0.7, (b, p, 2))
    shift = rng.uniform(-1.5, 1.5, (b, p, 2))
    pts = (ctr[:, :, None] + off[None, None]).reshape(b, p * n, 2)
    moved = torch.tensor(pts + np.repeat(shift, n, axis=1),
                         dtype=torch.float32)
    val = interp.sample_windows(torch.tensor(win), moved[..., 0],
                                moved[..., 1]).numpy().reshape(b, p, n)
    templ = val
    if zncc:
        templ = (val - val.mean(-1, keepdims=True)) / (
            val.std(-1, keepdims=True) + 1e-6)
    return (win, np.ascontiguousarray(pts.transpose(0, 2, 1), np.float32),
            templ.reshape(b, -1).astype(np.float32),
            np.full((b,), scale, np.float32), shift)


def assert_raw_close(got, want, scales=None):
    """The kernel's raw sums `got` (a list of (B, ...) tensors) each within
    1e-4 of its norm of the plain form's `want`, per tracker; with the
    sums' rounding `scales` (S != 8), within 1e-4 of the norm plus
    `chip_smoke.ROUND_K` float32 epsilons of the scale
    (`chip_smoke.raw_verdict`)."""
    v = cs.raw_verdict(torch, list(got), list(want), scales)
    assert v["ok"], (v["err_raw"], v.get("factor"))


def assert_norm_close(got, want, rel):
    """g / JtJ are cancellation-heavy float32 reductions: compare on the
    scale of the vector/matrix, not elementwise."""
    got, want = np.asarray(got), np.asarray(want)
    err = float(np.max(np.abs(got - want)))
    assert err <= rel * np.linalg.norm(want), (err, np.linalg.norm(want))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _on(device, arrays):
    return [torch.tensor(np.asarray(a), device=device) for a in arrays]


@pytest.mark.gpu
@pytest.mark.parametrize("n", N_POINTS)
def test_cuda_k1_matches_plain(cuda_device, n):
    """The CUDA kernel against the plain form on the card: val within
    1e-3, g and JtJ within 1e-4 of their norms (summation order differs)."""
    args = _on(cuda_device, chain_inputs(n, b=16))
    before = tk.lk_fused_chain_raw.launches["ssd"]
    val, g, h = tk.lk_fused_chain(*args)
    torch.cuda.synchronize()
    assert tk.lk_fused_chain_raw.launches["ssd"] == before + 1
    v0, g0, h0 = tk.lk_fused_chain_ref(*args)
    assert float((val - v0).abs().max()) <= 1e-3
    for b in range(16):
        assert_norm_close(g[b].cpu(), g0[b].cpu(), 1e-4)
        assert_norm_close(h[b].cpu(), h0[b].cpu(), 1e-4)


@pytest.mark.gpu
def test_cuda_k1_rejects_bad_inputs(cuda_device):
    win, M0, gens, ph, templ = _on(cuda_device, chain_inputs(169, b=2))
    with pytest.raises(TypeError):
        tk.lk_fused_chain(win.double(), M0, gens, ph, templ)
    with pytest.raises(ValueError):
        tk.lk_fused_chain(win.transpose(1, 2), M0, gens, ph, templ)
    with pytest.raises(ValueError):
        tk.lk_fused_chain(win, M0, gens, ph[:, :, :100], templ)
    with pytest.raises(ValueError):
        tk.lk_fused_chain(win, M0.cpu(), gens, ph, templ)


@pytest.mark.gpu
@pytest.mark.parametrize("n", N_POINTS)
@pytest.mark.parametrize("am,esm", NEW_MODES)
def test_cuda_k2_k3_match_plain(cuda_device, am, esm, n):
    """The NCC-moment and ESM instantiations against the plain form on
    the card: val within 1e-3, every raw sum within 1e-4 of its norm."""
    arrays, j0 = mode_inputs(n, am, esm, b=16)
    args = _on(cuda_device, arrays)
    j0 = None if j0 is None else _on(cuda_device, [j0])[0]
    mode = tk.mode_name(am, esm)
    before = tk.lk_fused_chain_raw.launches[mode]
    got = tk.lk_fused_chain_raw(*args, am=am, j0=j0)
    torch.cuda.synchronize()
    assert tk.lk_fused_chain_raw.launches[mode] == before + 1
    want = tk.lk_fused_chain_ref(*args, am=am, j0=j0)
    assert float((got[0] - want[0]).abs().max()) <= 1e-3
    for a, w in zip(got[1:], want[1:]):
        for b in range(16):
            assert_norm_close(a[b].cpu(), w[b].cpu(), 1e-4)


@pytest.mark.gpu
def test_cuda_k3_rejects_bad_j0(cuda_device):
    arrays, j0 = mode_inputs(169, "ncc", True, b=2)
    args = _on(cuda_device, arrays)
    j0 = _on(cuda_device, [j0])[0]
    with pytest.raises(ValueError):
        tk.lk_fused_chain(*args, am="ncc", j0=j0[:, :, :100])
    with pytest.raises(ValueError):
        tk.lk_fused_chain(*args, am="ncc", j0=j0.transpose(1, 2))
    with pytest.raises(ValueError):
        tk.lk_fused_chain(*args, am="zncc")


@pytest.mark.gpu
@pytest.mark.parametrize("n", N_POINTS)
@pytest.mark.parametrize("c", [1, 2, 3, 4])
def test_cuda_k4_matches_plain(cuda_device, c, n):
    """The multi-channel SSD instantiation against the plain form on the
    card, C = 1-4 channels: val (B, C, N) within 1e-3, g and JtJ within
    1e-4 of their norms."""
    args = _on(cuda_device, mc_inputs(n, c, b=16))
    before = tk.lk_fused_chain_raw.launches["ssd_mc"]
    val, g, h = tk.lk_fused_chain(*args)
    torch.cuda.synchronize()
    assert tk.lk_fused_chain_raw.launches["ssd_mc"] == before + 1
    assert val.shape == (16, c, n)
    v0, g0, h0 = tk.lk_fused_chain_ref(*args)
    assert float((val - v0).abs().max()) <= 1e-3
    for b in range(16):
        assert_norm_close(g[b].cpu(), g0[b].cpu(), 1e-4)
        assert_norm_close(h[b].cpu(), h0[b].cpu(), 1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("n", N_POINTS)
@pytest.mark.parametrize("am,esm,c", ALL_MODES)
@pytest.mark.parametrize("kind", CUBIC_KINDS)
def test_cuda_k1c_matches_plain(cuda_device, kind, am, esm, c, n):
    """Every mode with cubic taps against the plain form on the card:
    val within 1e-3, every raw sum within 1e-4 of its norm."""
    arrays, j0 = all_mode_inputs(n, am, esm, c, b=16)
    args = _on(cuda_device, arrays)
    j0 = None if j0 is None else _on(cuda_device, [j0])[0]
    mode = tk.mode_name(am, esm, c > 1, kind)
    before = tk.lk_fused_chain_raw.launches[mode]
    got = tk.lk_fused_chain_raw(*args, am=am, j0=j0, kind=kind)
    torch.cuda.synchronize()
    assert tk.lk_fused_chain_raw.launches[mode] == before + 1
    want = tk.lk_fused_chain_ref(*args, am=am, j0=j0, kind=kind)
    assert float((got[0] - want[0]).abs().max()) <= 1e-3
    for a, w in zip(got[1:], want[1:]):
        for b in range(16):
            assert_norm_close(a[b].cpu(), w[b].cpu(), 1e-4)


@pytest.mark.gpu
def test_cuda_k4_rejects_bad_inputs(cuda_device):
    win, M0, gens, ph, templ = _on(cuda_device, mc_inputs(169, 3, b=2))
    with pytest.raises(ValueError):
        tk.lk_fused_chain(win, M0, gens, ph, templ[:, :2])
    with pytest.raises(ValueError):
        tk.lk_fused_chain(torch.cat([win, win[:, :2]], 1), M0, gens, ph,
                          torch.cat([templ, templ[:, :2]], 1))
    with pytest.raises(ValueError):
        tk.lk_fused_chain(win[:, :, :3, :3], M0, gens, ph, templ,
                          kind="cubic")


# per-level shapes of the grid's K5 calls: (points per patch, iterations,
# window), and n = 100 for the kernel's 4-points-per-lane instantiation
K5_CASES = [(16, 8, 96), (64, 1, 160), (100, 3, 64)]


@pytest.mark.gpu
@pytest.mark.parametrize("kind", gf.KINDS)
@pytest.mark.parametrize("n,iters,hw", K5_CASES)
def test_cuda_k5_matches_plain(cuda_device, n, iters, hw, kind):
    """The CUDA grid-flow kernel (K5 with linear taps, K5c with the cubic
    kinds) against the plain form on the card: disp within 1e-4 template
    units (summation order differs), one launch of `kind` per call."""
    args = _on(cuda_device, k5_inputs(n, b=8, hw=hw, p=30)[:4])
    before = dict(gf.grid_flow.launches)
    got = gf.grid_flow(*args, n, iters, kind=kind)
    torch.cuda.synchronize()
    assert gf.grid_flow.launches == {**before, kind: before[kind] + 1}
    want = gf.grid_flow_ref(*args, n, iters, kind=kind)
    assert float((got - want).abs().max()) <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 196, 400, 1024])
def test_cuda_k5c_every_points_per_lane(cuda_device, n):
    """K5c's instantiations at 1, 8, 16 and 32 points per lane (n = 1,
    196, 400, 1024; the grid's levels cover 1, 2 and 4) against the plain
    form, both cubic kinds."""
    args = _on(cuda_device, k5_inputs(n, b=2, hw=96, p=4, scale=40.0)[:4])
    for kind in ("cubic", "cubic_bspl"):
        got = gf.grid_flow(*args, n, 2, kind=kind)
        want = gf.grid_flow_ref(*args, n, 2, kind=kind)
        assert float((got - want).abs().max()) <= 1e-4, kind


@pytest.mark.gpu
def test_cuda_k5_rejects_bad_inputs(cuda_device):
    win, pts, templ, scale = _on(cuda_device, k5_inputs(16, b=2)[:4])
    with pytest.raises(TypeError):
        gf.grid_flow(win.double(), pts, templ, scale, 16, 2)
    with pytest.raises(ValueError):
        gf.grid_flow(win, pts[:, :, :100], templ, scale, 16, 2)
    with pytest.raises(ValueError):
        gf.grid_flow(win, pts, templ, scale, 24, 2)
    with pytest.raises(ValueError):
        gf.grid_flow(win, pts, templ, scale.cpu(), 16, 2)
    with pytest.raises(ValueError, match="unknown tap kind"):
        gf.grid_flow(win, pts, templ, scale, 16, 2, kind="cubic_mm")
    with pytest.raises(ValueError):
        gf.grid_flow(win[:, :3, :3].contiguous(), pts, templ, scale, 16, 2,
                     kind="cubic")


@pytest.mark.gpu
@pytest.mark.parametrize("am,esm,c", ALL_MODES)
@pytest.mark.parametrize("s", NEW_S)
def test_cuda_chain_every_s_matches_plain(cuda_device, s, am, esm, c):
    """Each mode at each new state size, with every tap kind, against the
    plain form on the card: val within 1e-3, every raw sum within 1e-4 of
    its norm (`assert_raw_close`, with the rounding floor where a sum
    cancels); one launch of its `:s<S>` instantiation per call."""
    for n in (169, 2500):
        arrays, j0 = ssm_inputs(n, s, am, esm, c, b=16)
        args = _on(cuda_device, arrays)
        j0 = None if j0 is None else _on(cuda_device, [j0])[0]
        for kind in gf.KINDS:
            mode = tk.mode_name(am, esm, c > 1, kind, s)
            before = tk.lk_fused_chain_raw.launches[mode]
            got = tk.lk_fused_chain_raw(*args, am=am, j0=j0, kind=kind)
            torch.cuda.synchronize()
            assert tk.lk_fused_chain_raw.launches[mode] == before + 1
            assert got[1].shape == (16, s)
            want = tk.lk_fused_chain_ref(*args, am=am, j0=j0, kind=kind)
            assert float((got[0] - want[0]).abs().max()) <= 1e-3
            assert_raw_close(got[1:], want[1:], cs.chain_sum_scales(
                torch, tk, args, am, j0, kind))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [16, 64])
def test_cuda_chain_at_sub_grid_shapes(cuda_device, n):
    """ssd:s2 at the sub-tracker grid's shapes: 8x8 templates (N = 64,
    and 16 in the stride-2 phase) in 32-px windows, 512 sub-trackers a
    launch, against the plain form on the card under the rules above."""
    arrays, _ = ssm_inputs(n, 2, b=512, size=32)
    args = _on(cuda_device, arrays)
    for kind in gf.KINDS:
        got = tk.lk_fused_chain_raw(*args, kind=kind)
        torch.cuda.synchronize()
        want = tk.lk_fused_chain_ref(*args, kind=kind)
        assert float((got[0] - want[0]).abs().max()) <= 1e-3, kind
        assert_raw_close(got[1:], want[1:], cs.chain_sum_scales(
            torch, tk, args, kind=kind))


@pytest.mark.gpu
@pytest.mark.parametrize("blur", [2, 3, 4])
@pytest.mark.parametrize("s", [8, 6])
def test_cuda_blurred_taps_match_plain(cuda_device, s, blur):
    """K4b: every mode and tap kind with the binomially blurred taps at
    blur 2-4, against the plain form on the card (same rules as the plain
    taps); one launch of its `+blur` instantiation per call."""
    for am, esm, c in ALL_MODES:
        arrays, j0 = ssm_inputs(625, s, am, esm, c, b=8)
        args = _on(cuda_device, arrays)
        j0 = None if j0 is None else _on(cuda_device, [j0])[0]
        for kind in gf.KINDS:
            mode = tk.mode_name(am, esm, c > 1, kind, s, blurred=True)
            before = tk.lk_fused_chain_raw.launches[mode]
            got = tk.lk_fused_chain_raw(*args, am=am, j0=j0, kind=kind,
                                        blur=blur)
            torch.cuda.synchronize()
            assert tk.lk_fused_chain_raw.launches[mode] == before + 1
            want = tk.lk_fused_chain_ref(*args, am=am, j0=j0, kind=kind,
                                         blur=blur)
            assert float((got[0] - want[0]).abs().max()) <= 1e-3, mode
            assert_raw_close(got[1:], want[1:], None if s == 8 else
                             cs.chain_sum_scales(torch, tk, args, am, j0,
                                                 kind, blur))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", gf.KINDS)
@pytest.mark.parametrize("s", tk.STATE_DIMS)
def test_cuda_k6_matches_plain(cuda_device, s, kind):
    """K6 against its plain form on the card, with and without a crop:
    val within 1e-3, g and JtJ within 1e-4 of their norms (with
    `assert_raw_close`'s rounding floor)."""
    args = _on(cuda_device, gn_inputs(2500, s, b=8))
    for crop in (None, 144):
        mode = tk.gn_mode_name(s, kind)
        before = tk.lk_fused_gn_t.launches[mode]
        val, g, h = tk.lk_fused_gn_t(*args, kind=kind, crop=crop)
        torch.cuda.synchronize()
        assert tk.lk_fused_gn_t.launches[mode] == before + 1
        v0, g0, h0 = tk.lk_fused_gn_t_ref(*args, kind=kind, crop=crop)
        assert float((val - v0).abs().max()) <= 1e-3
        assert_raw_close((g, h), (g0, h0), None if s == 8 else
                         cs.gn_sum_scales(torch, tk, args, kind, crop))


@pytest.mark.gpu
@pytest.mark.parametrize("key", ["2", "6", "8"])
@pytest.mark.parametrize("n", [1024, 4500])
def test_cuda_k1_vs_k6_oracle(cuda_device, n, key):
    """The chain kernel (CUDA) against K6 (CUDA) fed the jvp-built warp
    Jacobian: val within 1.0, g and JtJ within 1e-4 of their norms (the
    reference's tolerances, `tests/test_dense_interp.py:176-181`)."""
    img, M0, gens, ph, templ, ptsT, jacT = oracle_operands(
        torch, n, key, cuda_device)
    v1, g1, h1 = tk.lk_fused_gn_t(img[None], ptsT[None], jacT[None],
                                  templ[None])
    v2, g2, h2 = tk.lk_fused_chain(img[None], M0[None], gens, ph[None],
                                   templ[None])
    assert float((v1 - v2).abs().max()) <= 1.0
    assert_norm_close(g2[0].cpu(), g1[0].cpu(), 1e-4)
    assert_norm_close(h2[0].cpu(), h1[0].cpu(), 1e-4)


@pytest.mark.gpu
def test_cuda_k6_and_blur_reject_bad_inputs(cuda_device):
    img, pts, jac, templ = _on(cuda_device, gn_inputs(100, 6, b=2))
    with pytest.raises(ValueError, match="S = 7"):
        tk.lk_fused_gn_t(img, pts, torch.cat([jac, jac[:, :2]], 1), templ)
    with pytest.raises(ValueError):
        tk.lk_fused_gn_t(img, pts[:, :, :50], jac, templ)
    with pytest.raises(TypeError):
        tk.lk_fused_gn_t(img.double(), pts, jac, templ)
    arrays, _ = ssm_inputs(169, 6, b=2, size=16)
    args = _on(cuda_device, arrays)
    with pytest.raises(ValueError, match="taps"):
        tk.lk_fused_chain(*args, kind="cubic", blur=8)
    with pytest.raises(ValueError, match="blur"):
        tk.lk_fused_chain(*args, blur=9)
