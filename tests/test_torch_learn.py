"""Port parity, slice 12's learning trackers and preprocessing: RCT, MIL,
Boosting, Struck, FragTrack and DFT (`mtf_tpu_torch/sm/learn.py`) and
`utils/preproc.py` against the JAX package's (`mtf_tpu/sm/learn.py`,
`mtf_tpu/utils/preproc.py`), with the factory keys and the state
converters.

References as in `test_torch_cf.py`: lone JAX trackers run op by op, the
port's B = 4 trackers one fleet. Struck's lone trackers are its reference
for a second reason: its Optimize pass can pick a degenerate pair (the
hardest negative is the positive pattern itself, so the pair's kernel
denominator is exactly 0 and the step clips to C), and which pair a
vmapped JAX update takes then turns on the rounding of its batched
products (on the CPU test scene a vmapped and a lone JAX tracker part by
3.2 px after two updates; the port follows the lone one). Struck draws
nothing: the JAX state's key is never split. The RCT measurement matrix
is drawn from the same seed in both packages. Widths are cut (RCT's
pool of 16 features, MIL's and Boosting's of 24 with 6 selected, Struck's
8x8 patches and 16 support vectors, FragTrack's 20-px template) to keep
the op-by-op references short; DFT runs FCLK on the descriptor fields
at 16x16 (the chain kernel's multi-channel mode, its plain form here)
against the JAX package under `jit`, as the registration trackers'
tests do.

Tolerances: `descriptor_fields` and the filters within 1e-4 of their
norm, corners within 0.05 px.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtf_tpu import create_tracker as jcreate
from mtf_tpu.parallel.fleet import TrackerFleet as JFleet
from mtf_tpu.utils import preproc as jpre
from mtf_tpu_torch import create_tracker as tcreate
from mtf_tpu_torch.sm.learn import RCT
from mtf_tpu_torch.utils import preproc as tpre
from test_torch_cf import (BOXES, CORNER_TOL, check_continuation, frames_of,
                           lone_jax, port_run, reference, rel,
                           start_references)
from test_torch_fleet import _scene

PRE_REL = 1e-4
LEARN_SMALL = {
    "rct": dict(res=24, search=6, n_feats=16),
    "mil": dict(res=24, search=6, n_feats=24, n_sel=6),
    "boost": dict(res=24, search=6, n_feats=24, n_sel=6),
    "strk": dict(res=8, search=4, budget=16),
    "frg": dict(res=20, search=5),
}
DFT_CFG = dict(dft_sm="fclk", resx=16, resy=16, max_iters=5, epsilon=0.0,
               interp="linear_mm", crop=96)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def learn_reference(key):
    return lone_jax(key, LEARN_SMALL[key], frames_of(_scene()), BOXES)


def dft_reference():
    """The JAX package's DFT fleet (jitted) over the frames: corners
    (T, B, 2, 4)."""
    frames = frames_of(_scene())
    jf = JFleet(jcreate("dft", "ssd", "8", **DFT_CFG))
    js = jf.initialize(jnp.asarray(frames[0]), jnp.asarray(BOXES))
    out = []
    for f in frames[1:]:
        js = jf.update(js, jnp.asarray(f))
        out.append(np.asarray(jf.corners(js)))
    return np.stack(out)


PREPROC = ("descriptor_fields", "gaussian_filter", "box_filter",
           "median_filter", "sobel_filter", "bilateral_filter",
           "anisotropic_diffusion", "hist_equalize")


def preproc_image():
    return _scene()[:96, :128]


def preproc_reference():
    """Each JAX filter of `preproc_image`, and the registry's keys."""
    out = {n: np.asarray(getattr(jpre, n)(jnp.asarray(preproc_image())))
           for n in PREPROC}
    return out, sorted(jpre.PREPROC_REGISTRY)


REFERENCE_JOBS = ([(learn_reference, "strk"), (dft_reference,)]
                  + [(learn_reference, k) for k in sorted(LEARN_SMALL)
                     if k != "strk"] + [(preproc_reference,)])


@pytest.fixture(scope="module", autouse=True)
def _references(request):
    start_references(request)


@pytest.mark.parametrize("name", PREPROC)
def test_preproc_matches_jax(name):
    filtered, keys = reference(preproc_reference)
    want = filtered[name]
    got = getattr(tpre, name)(torch.tensor(preproc_image())).numpy()
    assert got.shape == want.shape
    assert rel(got, want) <= PRE_REL, (name, rel(got, want))
    assert sorted(tpre.PREPROC_REGISTRY) == keys


@pytest.mark.parametrize("key", sorted(LEARN_SMALL))
def test_learn_matches_lone_jax_trackers(key):
    """A B = 4 fleet of each learn key, init and 3 updates, against 4 lone
    JAX trackers; then the JAX init state carried across continues
    identically."""
    frames = frames_of(_scene())
    ref = reference(learn_reference, key)
    sm = tcreate(key, device="cpu", **LEARN_SMALL[key])
    got = port_run(sm, frames, BOXES)
    err = np.abs(got - ref[1]).max(axis=(1, 2, 3))
    assert np.all(err <= CORNER_TOL), (key, err)
    check_continuation(sm, ref, frames, key)


def test_rct_tables_from_the_seed():
    """One seed draws the same measurement matrix in both packages."""
    for seed in (0, 5):
        j = jcreate("rct", seed=seed)
        t = RCT(type(j.prm)(**j.prm.__dict__), device="cpu")
        assert t._rects == j._rects
        np.testing.assert_array_equal(t._proj.numpy(), j._proj)


def test_learn_aliases_and_update_multi():
    """The aliases build the same trackers; `update_multi` on B copies of
    the frame is the shared path; `set_region` moves the box."""
    assert type(tcreate("bsr", device="cpu")).__name__ == "Boosting"
    assert type(tcreate("struck", device="cpu")).__name__ == "Struck"
    assert type(tcreate("frag", device="cpu")).__name__ == "FragTrack"
    frames = frames_of(_scene())
    for key in ("rct", "strk", "frg"):
        sm = tcreate(key, device="cpu", **LEARN_SMALL[key])
        st = sm.initialize(frames[0], BOXES)
        a = sm.corners(sm.update(st, frames[1]))
        b = sm.corners(sm.update_multi(st, np.stack([frames[1]] * 4)))
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)
        c2 = BOXES + 3.0
        np.testing.assert_allclose(
            sm.corners(sm.set_region(st, c2)).numpy().transpose(0, 2, 1),
            c2, atol=1e-4)


def test_dft_matches_jax():
    """DFT with FCLK on the descriptor fields (the multi-channel chain
    kernel's plain form) against the JAX package's fleet; its
    `update_multi` (the fields of the per-tracker frames in one batched
    pass) on copies of one frame is `update` on it, bit for bit (its
    parity with the JAX fleet's: `tests/test_torch_multi.py`)."""
    frames = frames_of(_scene())
    sm = tcreate("dft", "ssd", "8", device="cpu", **DFT_CFG)
    got = port_run(sm, frames, BOXES)
    err = np.abs(got - reference(dft_reference)).max(axis=(1, 2, 3))
    assert np.all(err <= CORNER_TOL), err
    assert sm.inner.name == "fclk" and sm.sigma == 1.5
    st = sm.initialize(frames[0], BOXES)
    multi = sm.update_multi(st, np.stack([frames[1]] * len(BOXES)))
    assert torch.equal(sm.corners(multi),
                       sm.corners(sm.update(st, frames[1])))
    assert tcreate("dft", device="cpu", resx=16, resy=16).inner.name == "esm"
