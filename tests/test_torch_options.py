"""Port parity, the last options of the JAX factory: `border="constant"`
(the gather samplers read 0.0 beyond the frame), `crop_blocks` (tiled
dense sampling, each tile in its own window: the generic LK path),
`interp_bf16` (bfloat16 image values and tap weights, float32 sums: the
generic samplers, and the chain kernel's and K5's flag through their
plain forms) and `interp_precision` (full-float32 contractions, which the
port computes anyway).

The samplers against the JAX package's on the test scene (non-integer
values); the trackers from the same init within 0.05 px of the JAX
package's generic XLA path over two updates (a grid: 0.1 px for one
update, the port handed the JAX RANSAC draws), their corners off the
pixel grid (ROADMAP Queue 3, item 2). The trackers' JAX references are
computed in the spawned reference pool (`test_torch_multi.
start_references`) while the sampler tests run.
"""
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtf_tpu import create_tracker as jcreate
from mtf_tpu.ops import interp as jinterp
from mtf_tpu.parallel.fleet import TrackerFleet as JFleet
from mtf_tpu_torch import convert
from mtf_tpu_torch import create_tracker as tcreate
from mtf_tpu_torch.ops import interp
from mtf_tpu_torch.ops.interp import FrameStack
from test_torch_cf import reference
from test_torch_fleet import CORNER_TOL, CORNERS, _scene, jax_init
from test_torch_grid import jax_fit_indices, use_indices
from test_torch_multi import start_references

GRID_TOL = 0.1
KINDS = ("nearest", "linear", "cubic", "cubic_bspl")
OFF = (CORNERS + np.float32([0.31, 0.27])).astype(np.float32)
# trackers 0 and 2 moved left until a quarter of each template lies
# beyond the frame's left edge
EDGE = OFF.copy()
EDGE[0::2, :, 0] -= EDGE[0::2, :, 0].min(1, keepdims=True) + 15.0
LK = dict(resx=16, resy=16, max_iters=5, epsilon=0.0)
GRID = dict(resx=16, resy=16, grid_res=4, grid_patch_res=6,
            grid_sub_iters=(1, 4), grid_n_hyps=16, grid_coarse_stride=2)
CASES = {
    # (SM key, configuration, corners, updates)
    "fclk_constant": ("fclk", dict(LK, interp="linear", border="constant"),
                      EDGE, 2),
    "grid_constant": ("grid", dict(GRID, interp="linear", border="constant"),
                      EDGE, 1),
    "fclk_crop_blocks": ("fclk", dict(LK, interp="linear_mm", crop=24,
                                      crop_blocks=(2, 2)), OFF, 2),
    # 50x50: at 16x16 a bfloat16 weight's rounding, which turns a float32
    # ulp of a coordinate into a bfloat16 one, parts any two paths by
    # tenths of a pixel within 5 iterations (the JAX package's XLA path
    # and the port's generic one too); 2500 points average it out
    "fclk_bf16": ("fclk", dict(LK, interp="linear_mm", crop=144, resx=50,
                               resy=50, interp_bf16=True), OFF, 2),
    "grid_bf16": ("grid", dict(GRID, interp="linear_mm", crop=96,
                               interp_bf16=True), OFF, 1),
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """PyTorch on one thread beside XLA's compiles."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frames():
    f = _scene()
    return f, np.roll(f, (1, 2), (0, 1)), np.roll(f, (2, 3), (0, 1))


def jax_reference(name):
    """The JAX fleet's init and its corners after each update (numpy)."""
    key, cfg, corners, n = CASES[name]
    sm = jcreate(key, "ssd", "8", **cfg)
    fl = JFleet(sm)
    frames = _frames()
    st = jax_init(types.SimpleNamespace(sm=sm), frames[0], corners)
    out = {"state0": jax.tree.map(np.asarray, st), "corners": []}
    for f in frames[1:1 + n]:
        st = fl.update(st, jnp.asarray(f))
        out["corners"].append(np.asarray(fl.corners(st)))
    return out


REFERENCE_JOBS = [(jax_reference, n) for n in
                  ("grid_constant", "grid_bf16", "fclk_bf16",
                   "fclk_constant", "fclk_crop_blocks")]


@pytest.fixture(scope="module", autouse=True)
def _jax_refs(request, _one_torch_thread):
    start_references(request)


def _points(n=400, lo=-4.0, hi=(324.0, 244.0), seed=0):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(lo, hi[0], n), rng.uniform(lo, hi[1], n)],
                    -1).astype(np.float32)


# -- border="constant" --------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_constant_border_sampler_matches_jax(kind):
    """Each gather kind with the constant border on points across the
    frame's edges: values and derivatives as the JAX package's
    `sample_with_grad` (taps beyond the frame read 0.0, the one-sided
    linear derivative over those values), and not the replicate
    border's; per-tracker frames and a `FrameStack` read alike."""
    img, pts = _scene(), _points()
    jv, jg = jinterp.sample_with_grad(jnp.asarray(img), jnp.asarray(pts),
                                      kind, "constant")
    tv, tg = interp.sample_val_grad(torch.tensor(img), torch.tensor(pts)[None],
                                    kind, "constant")
    scale = np.abs(np.asarray(jv)).max()
    assert np.abs(tv[0].numpy() - np.asarray(jv)).max() <= 1e-5 * scale
    assert np.abs(tg[0].numpy() - np.asarray(jg)).max() <= 1e-5 * scale
    rv, _ = interp.sample_val_grad(torch.tensor(img), torch.tensor(pts)[None],
                                   kind, "replicate")
    assert np.abs(rv - tv).max() > 1.0
    stack = torch.tensor(np.stack([img, img[::-1].copy()]))[..., None]
    two = torch.tensor(np.stack([pts, pts[::-1].copy()]))
    sv, _ = interp.sample_val_grad(stack, two, kind, "constant")
    iv, _ = interp.sample_val_grad(FrameStack(stack, torch.tensor([1, 0])),
                                   two.flip(0), kind, "constant")
    assert torch.equal(sv[0], tv[0]) and torch.equal(iv[1], sv[0])


@pytest.mark.parametrize("name", ["fclk_constant", "grid_constant"])
def test_constant_border_trackers_match_jax(name):
    """fclk/ssd with linear gather taps and a grid tracker, two of three
    templates a quarter beyond the left edge: from the JAX init within
    0.05 px of the JAX fleet's updates (the grid: 0.1 px for one)."""
    _check_tracker(name)


def test_constant_border_dense_kinds_ignore_it():
    """The dense kinds clamp their coordinates (replicate) in both
    packages: `border` changes nothing there, so fclk on "linear_mm" with
    the constant border takes the chain kernel as the JAX package's
    `_fused_ok` does and updates as with the replicate border."""
    out = []
    for border in ("constant", "replicate"):
        sm = tcreate("fclk", "ssd", "8", device="cpu", interp="linear_mm",
                     crop=96, border=border, **LK)
        assert sm._fused_ok(types.SimpleNamespace(spi_mask=None),
                            torch.zeros(240, 320))
        out.append(sm.corners(sm.update(sm.initialize(_scene(), EDGE),
                                        _frames()[1])))
    assert torch.equal(out[0], out[1])


# -- crop_blocks --------------------------------------------------------------

@pytest.mark.parametrize("blocks", [(2, 2), (1, 5)])
def test_sample_dense_blocked_matches_jax(blocks):
    """The point grid split into row-major tiles, each sampled in its own
    window: values and gradients as the JAX package's, and on per-tracker
    frames each tracker's as alone."""
    img = _scene()
    ys, xs = np.meshgrid(np.linspace(60.3, 90.3, 10),
                         np.linspace(100.7, 140.7, 10), indexing="ij")
    pts = np.stack([xs.ravel(), ys.ravel()], -1).astype(np.float32)
    for kind in ("linear", "cubic"):
        jv, jg = jax.jit(jinterp.sample_dense_blocked, static_argnums=(
            2, 3, 4, 5))(jnp.asarray(img), jnp.asarray(pts), kind, 32,
                         (10, 10), blocks)
        tv, tg = interp.sample_dense_blocked(
            torch.tensor(img), torch.tensor(pts)[None], kind, crop=32,
            grid_shape=(10, 10), blocks=blocks)
        scale = np.abs(np.asarray(jv)).max()
        assert np.abs(tv[0].numpy() - np.asarray(jv)).max() <= 1e-5 * scale
        assert np.abs(tg[0].numpy() - np.asarray(jg)).max() <= 1e-5 * scale
    stack = torch.tensor(np.stack([img, img[::-1].copy()]))[..., None]
    two = torch.tensor(np.stack([pts, pts + 3.0]))
    bv, _ = interp.sample_dense_blocked(stack, two, "linear", 32, (10, 10),
                                        blocks)
    one, _ = interp.sample_dense_blocked(stack[1:], two[1:], "linear", 32,
                                         (10, 10), blocks)
    assert torch.equal(bv[1:], one)


def test_sample_dense_blocked_raises():
    """A grid the blocks do not divide raises ValueError, as in the JAX
    package, and so do points that are not the whole grid (a coarse
    phase's decimated grid, where the JAX package's reshape raises:
    ROADMAP Queue 3)."""
    img = torch.tensor(_scene())
    pts = torch.zeros(1, 100, 2) + 50.5
    with pytest.raises(ValueError, match="not divisible"):
        interp.sample_dense_blocked(img, pts, grid_shape=(10, 10),
                                    blocks=(3, 3))
    with pytest.raises(ValueError, match="not the 10x10 grid"):
        interp.sample_dense_blocked(img, pts[:, :64], grid_shape=(10, 10))
    sm = tcreate("fclk", "ssd", "8", device="cpu", interp="linear_mm",
                 crop=24, crop_blocks=(2, 2), coarse_pt_iters=((2, 2),),
                 **LK)
    with pytest.raises(ValueError, match="grid"):
        sm.update(sm.initialize(_scene(), OFF), _frames()[1])


def test_crop_blocks_tracker_matches_jax():
    """fclk/ssd/8 with crop_blocks (2, 2) takes the generic path (no chain
    kernel, no hoisted window), within 0.05 px of the JAX package's over
    two updates."""
    sm = tcreate("fclk", "ssd", "8", device="cpu",
                 **CASES["fclk_crop_blocks"][1])
    assert not sm._fused_ok(types.SimpleNamespace(spi_mask=None),
                            torch.zeros(240, 320))
    assert sm._crop(sm.initialize(_scene(), OFF), 240, 320) is None
    _check_tracker("fclk_crop_blocks")


# -- interp_bf16 --------------------------------------------------------------

@pytest.mark.parametrize("kind", ["linear", "cubic", "cubic_bspl"])
def test_bf16_samplers_match_jax(kind):
    """`sample_dense` (with a crop) and `sample_windows` (PF's window)
    with bfloat16 operands against the JAX package's `sample_dense(...,
    compute_dtype=bfloat16)` on the scene's non-integer values: within
    1e-4 of the value scale, where the float32 samplers part from it by
    more than that."""
    img = _scene()
    pts = _points(lo=3.0, hi=(316.0, 236.0))
    jv, jg = jax.jit(functools.partial(
        jinterp.sample_dense, kind=kind, crop=96,
        compute_dtype=jnp.bfloat16))(jnp.asarray(img), jnp.asarray(pts))
    jv, jg = np.asarray(jv), np.asarray(jg)
    scale = np.abs(jv).max()
    tv, tg = interp.sample_dense(torch.tensor(img), torch.tensor(pts)[None],
                                 kind, crop=96, bf16=True)
    assert np.abs(tv[0].numpy() - jv).max() <= 1e-4 * scale
    assert np.abs(tg[0].numpy() - jg).max() <= 1e-4 * scale
    fv, _ = interp.sample_dense(torch.tensor(img), torch.tensor(pts)[None],
                                kind, crop=96)
    assert np.abs(fv[0].numpy() - jv).max() > 1e-4 * scale
    # PF's window: 64 x 80 px of the scene, points inside it
    win = img[40:104, 60:140]
    wp = _points(lo=2.0, hi=(77.0, 61.0), seed=1)
    jw, _ = jax.jit(functools.partial(
        jinterp.sample_dense, kind=kind, compute_dtype=jnp.bfloat16,
        need_grad=False))(jnp.asarray(win), jnp.asarray(wp))
    tw = interp.sample_windows(torch.tensor(win)[None],
                               torch.tensor(wp[:, 0])[None],
                               torch.tensor(wp[:, 1])[None], kind=kind,
                               bf16=True)
    assert np.abs(tw[0].numpy() - np.asarray(jw)[:, 0]).max() \
        <= 1e-4 * scale


@pytest.mark.parametrize("name", ["fclk_bf16", "grid_bf16"])
def test_bf16_kernels_plain_forms_match_jax(name):
    """fclk with `interp_bf16` on the chain kernel's plain form (its
    window rounded to bfloat16, its tap weights rounded by the flag) and
    a grid tracker on K5's plain form with the flag, from the JAX init,
    within 0.05 px (the grid: 0.1 px for one update) of the JAX package's
    XLA paths with `interp_bf16`."""
    key, cfg, _, _ = CASES[name]
    if key == "fclk":
        sm = tcreate(key, "ssd", "8", device="cpu", **cfg)
        assert sm._fused_ok(types.SimpleNamespace(spi_mask=None),
                            torch.zeros(240, 320))
    _check_tracker(name)


# -- interp_precision ---------------------------------------------------------

@pytest.mark.parametrize("use_pallas", [False, None])
def test_interp_precision_highest_is_the_default(use_pallas):
    """`interp_precision="highest"` builds as the JAX factory builds it
    and updates exactly as the default, on the generic path (where the
    JAX package reads it) and on the chain kernel's."""
    out = []
    for prec in (None, "highest"):
        sm = tcreate("fclk", "ssd", "8", device="cpu", interp="linear_mm",
                     crop=96, use_pallas=use_pallas, interp_precision=prec,
                     **LK)
        j = jcreate("fclk", "ssd", "8", interp_precision=prec, **LK)
        assert sm.prm.interp_precision == j.prm.interp_precision == prec
        out.append(sm.corners(sm.update(sm.initialize(_scene(), OFF),
                                        _frames()[1])))
    assert torch.equal(out[0], out[1])


# -- the trackers -------------------------------------------------------------

def _check_tracker(name):
    """The port's tracker of CASES[name] from the JAX init (a grid handed
    the JAX RANSAC draws) against the JAX fleet's corners per update."""
    key, cfg, corners, n = CASES[name]
    ref = reference(jax_reference, name)
    sm = tcreate(key, "ssd", "8", device="cpu", **cfg)
    if key == "grid":
        use_indices(sm, jax_fit_indices(n, n_hyps=16, n_pts=16))
    st = convert.to_torch(ref["state0"], device="cpu", sm=sm)
    tol = GRID_TOL if key == "grid" else CORNER_TOL
    for t, f in enumerate(_frames()[1:1 + n]):
        st = sm.update(st, f)
        got = sm.corners(st).numpy()
        assert np.isfinite(got).all(), t
        assert np.abs(got - ref["corners"][t]).max() < tol, (t, np.abs(
            got - ref["corners"][t]).max())
