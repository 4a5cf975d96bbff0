"""Port parity, slice 12's TLD (`mtf_tpu_torch/sm/tld.py`) against the JAX
package's (`mtf_tpu/sm/tld.py`), the factory's slice-12 routing, and the
dense linear rule at integer coordinates (ROADMAP Queue 3, item 2).

The scene, boxes and trajectory are `tests/test_tld.py`'s, at a cut
canonical pyramid (48x64, 3 levels; the JAX reference costs 15-46 s a
case at 96x128). The reference is 4 lone JAX trackers in a spawned
process (`test_torch_cf.reference`): their detection cascade runs op by
op, so each canonical level, variance and fern bit is the port's bit for
bit; their Median Flow leg and the fern-index map (`_level_maps`, equal
under `jit` given its level) run jitted, composed from the JAX package's
own functions, to keep the reference short.

Held: the fern posterior counts exactly, the NN template sets within
1e-5, the boxes within 0.05 px and the validity flags, after init and
each of 3 updates; the JAX init state carried across by `convert`. Under
the occluder of `test_tld.py` the Median Flow leg tracks noise, where
the two packages' rounding parts (as the JAX package's own jitted and
op-by-op legs part there), so that leg holds the port to the JAX test's
own assertions: invalid while hidden, valid again once re-acquired.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from mtf_tpu import create_tracker as jcreate
from mtf_tpu.ops import interp as jinterp
from mtf_tpu_torch import convert
from mtf_tpu_torch import create_tracker as tcreate
from mtf_tpu_torch.ops import interp as tinterp
from mtf_tpu_torch.sm.tld import _top_k
from test_torch_cf import CORNER_TOL, reference, start_references

TLD_CFG = dict(tld_canon_h=48, tld_canon_w=64, tld_levels=3)
# test_tld.py's own pyramid, for its occlusion leg
TLD_OCC_CFG = dict(tld_canon_h=96, tld_canon_w=128, tld_levels=3)
NN_TOL = 1e-5
C0 = np.array([[60, 50], [110, 50], [110, 100], [60, 100]], np.float32)
CENTER0 = np.array([85.0, 75.0])
BOXES = np.stack([C0 + np.float32(d) for d in
                  ((0.31, 0.27), (20.4, 10.7), (-15.3, 8.6),
                   (30.2, -12.9))])
CLEAN = ((2, 1), (4, 2), (6, 3))
# test_tld.py's trajectory: the target hidden on frames 3-7
OCCLUDED = ((2, 1), (4, 2), (6, 3)) + ((8, 4),) * 6 + ((10, 5), (12, 6))
HELD = ("fern_pos", "fern_neg", "pos_set", "neg_set", "pos_valid",
        "neg_valid", "valid", "var_min", "pos_ptr", "neg_ptr")


def tld_scene():
    rng = np.random.default_rng(3)
    img = gaussian_filter(rng.standard_normal((160, 200)), 2.0)
    img = (img - img.min()) / (img.max() - img.min()) * 255.0
    return np.asarray(img, np.float32)


def frame_at(scene, t, dxdy, occ_rng=None):
    """Frame t of a trajectory; with `occ_rng`, test_tld.py's occluder
    over the target on frames 3-7."""
    dx, dy = dxdy
    f = np.roll(np.roll(scene, dy, axis=0), dx, axis=1)
    if occ_rng is not None and 3 <= t <= 7:
        c = CENTER0 + [dx, dy]
        x0, y0 = int(c[0] - 35), int(c[1] - 35)
        h = min(70, 160 - max(0, y0))
        w = min(70, 200 - max(0, x0))
        f = f.copy()
        f[max(0, y0):max(0, y0) + h, max(0, x0):max(0, x0) + w] = \
            128.0 + 20 * occ_rng.standard_normal((h, w))
    return f


class _JitLeg:
    """The JAX Median Flow leg with its entry points jitted."""

    def __init__(self, mf):
        self.ssm = mf.ssm
        self.corners = mf.corners
        self.initialize = jax.jit(mf.initialize)
        self.update = jax.jit(mf.update)
        self.set_region = jax.jit(lambda st, c, f=None: mf.set_region(st, c))


def _stack(states):
    return jax.tree.map(lambda *x: np.stack([np.asarray(a) for a in x]),
                        *states)


def tld_reference():
    """4 lone JAX TLD trackers on the clean trajectory: (the init states
    stacked, the stacked states after each update)."""
    jt = jcreate("tld", **TLD_CFG)
    jt.mf = _JitLeg(jt.mf)
    jt._level_maps = jax.jit(jt._level_maps)
    scene = tld_scene()
    states = [jt.initialize(jnp.asarray(scene), jnp.asarray(c))
              for c in BOXES]
    out = [_stack(states)]
    for t, d in enumerate(CLEAN):
        f = jnp.asarray(frame_at(scene, t, d))
        states = [jt.update(s, f) for s in states]
        out.append(_stack(states))
    return out


REFERENCE_JOBS = [(tld_reference,)]


@pytest.fixture(scope="module", autouse=True)
def _references(request):
    start_references(request)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _held(js, ts, label):
    for f in HELD:
        want = np.asarray(getattr(js, f))
        got = getattr(ts, f).numpy()
        if f in ("pos_set", "neg_set", "var_min"):
            np.testing.assert_allclose(got, want, rtol=0, atol=NN_TOL,
                                       err_msg=f"{label} {f}")
        else:
            np.testing.assert_array_equal(got, want, err_msg=f"{label} {f}")
    err = np.abs(np.concatenate([ts.center.numpy() - js.center,
                                 ts.size.numpy() - js.size])).max()
    assert err <= CORNER_TOL, (label, err)


def test_tld_matches_lone_jax_trackers():
    """A B = 4 fleet against 4 lone JAX trackers: init (5 detection passes,
    the seeded negatives) and 3 updates, fern counts exact."""
    ref = reference(tld_reference)
    scene = tld_scene()
    sm = tcreate("tld", device="cpu", **TLD_CFG)
    st = sm.initialize(scene, BOXES)
    _held(ref[0], st, "init")
    assert float(st.fern_pos.sum()) > 0 and float(st.fern_neg.sum()) > 0
    for t, d in enumerate(CLEAN):
        st = sm.update(st, frame_at(scene, t, d))
        _held(ref[t + 1], st, f"update {t + 1}")


def test_tld_state_converts():
    """The JAX init state carried across continues as the JAX trackers do."""
    ref = reference(tld_reference)
    scene = tld_scene()
    sm = tcreate("tld", device="cpu", **TLD_CFG)
    st = convert.to_torch(ref[0], device="cpu", sm=sm)
    _held(ref[0], st, "converted")
    _held(ref[1], sm.update(st, frame_at(scene, 0, CLEAN[0])),
          "converted + 1")


def test_tld_top_k_breaks_ties_as_jax():
    """The first update's detection scores tie (untrained posteriors read
    0 on many windows), and the tie reaches the top K: `_top_k` takes the
    tied windows in index order, as `lax.top_k` does."""
    scene = tld_scene()
    sm = tcreate("tld", device="cpu", **TLD_CFG)
    st = sm.initialize(scene, BOXES)
    frame = sm._gray(frame_at(scene, 0, CLEAN[0]))
    var, conf, *_ = sm._detect(st, frame)
    score = torch.where(var >= st.var_min[:, None, None, None], conf,
                        -1.0).reshape(len(BOXES), -1)
    k = sm.prm.top_k
    kth = torch.sort(score, dim=1, descending=True).values[:, k - 1]
    assert bool(((score == kth[:, None]).sum(1) > 1).any())
    for row in score:
        v, i = _top_k(row[None], k)
        jv, ji = jax.lax.top_k(jnp.asarray(row.numpy()), k)
        np.testing.assert_array_equal(i[0].numpy(), np.asarray(ji))
        np.testing.assert_array_equal(v[0].numpy(), np.asarray(jv))


def test_tld_occlusion_invalidates_and_reacquires():
    """test_tld.py's occlusion leg on the port: invalid while the target
    is hidden, valid again once re-acquired, near the target at the end."""
    scene = tld_scene()
    sm = tcreate("tld", device="cpu", **TLD_OCC_CFG)
    st = sm.initialize(scene, np.stack([C0, BOXES[0]]))
    occ = np.random.default_rng(9)
    valid, errs = [], []
    for t, d in enumerate(OCCLUDED):
        st = sm.update(st, frame_at(scene, t, d, occ))
        valid.append(st.valid.numpy().copy())
        errs.append(np.linalg.norm(st.center.numpy() - (CENTER0 + d), axis=1))
    valid, errs = np.stack(valid), np.stack(errs)
    assert not valid[3:8].all(0).any(), valid
    assert valid[8:].any(0).all(), (valid, errs)
    assert np.all(errs[-1] < 12.0), errs


def test_tld_update_multi_and_set_region():
    scene = tld_scene()
    sm = tcreate("tld", device="cpu", **TLD_CFG)
    st = sm.initialize(scene, BOXES[:2])
    f1 = frame_at(scene, 0, CLEAN[0])
    a = sm.update(st, f1)
    b = sm.update_multi(st, np.stack([f1, f1]))
    torch.testing.assert_close(a.center, b.center, rtol=0, atol=1e-5)
    assert torch.equal(a.fern_pos, b.fern_pos)
    c2 = BOXES[:2] + 10.0
    s2 = sm.set_region(st, c2)
    np.testing.assert_allclose(sm.corners(s2).numpy().transpose(0, 2, 1),
                               c2, atol=1e-3)
    assert bool(s2.valid.all())


SLICE12_KEYS = {"mosse": {"res": 16}, "kcf": {"res": 16},
                "dsst": {"res": 16, "n_scales": 5, "scale_res": 4},
                "rct": {"res": 16, "search": 3, "n_feats": 8},
                "mil": {"res": 16, "search": 3, "n_feats": 8, "n_sel": 3},
                "boost": {"res": 16, "search": 3, "n_feats": 8, "n_sel": 3},
                "bsr": {"res": 16, "search": 3, "n_feats": 8, "n_sel": 3},
                "strk": {"res": 8, "search": 2, "budget": 8},
                "struck": {"res": 8, "search": 2, "budget": 8},
                "frg": {"res": 16, "search": 3},
                "frag": {"res": 16, "search": 3},
                "dft": {"resx": 8, "resy": 8, "max_iters": 2},
                "tld": dict(TLD_CFG, tld_levels=1)}


def test_factory_builds_and_updates_every_slice12_key():
    scene = tld_scene()
    for key, cfg in SLICE12_KEYS.items():
        sm = tcreate(key, device="cpu", **cfg)
        st = sm.update(sm.initialize(scene, BOXES[:2]),
                       frame_at(scene, 0, CLEAN[0]))
        assert sm.corners(st).shape == (2, 2, 4), key
        assert bool(torch.isfinite(sm.corners(st)).all()), key
    # the cv2 trackers are ported (slice 14): feat and cmt build, and a
    # cv2 adapter key builds or raises with the machine's list, as in JAX
    assert type(tcreate("feat", device="cpu")).__name__ == "FeatureTracker"
    assert type(tcreate("cmt", device="cpu")).__name__ == "CMT"
    from mtf_tpu_torch import third_party
    if "csrt" not in third_party.available():
        with pytest.raises(NotImplementedError, match="available in this "
                           "environment"):
            tcreate("csrt", device="cpu")
    with pytest.raises(NotImplementedError):
        tcreate("kcf", device="cpu", tld_levels=3)


def test_dense_linear_rule_at_integer_coordinates():
    """ROADMAP Queue 3, item 2: both packages' dense linear rule fed the
    same points, placed exactly on integers, give the same values and the
    same derivative (0 along an axis at an integer coordinate), so the
    parted rows seen on the trackers are a rounding difference: a point
    that lands on an integer in one package lands beside it in the
    other."""
    img = tld_scene()[:40, :48]
    g = np.stack(np.meshgrid(np.arange(3.0, 40.0, 1.0),
                             np.arange(2.0, 30.0, 1.0)), -1)
    pts = np.concatenate([g.reshape(-1, 2),
                          g.reshape(-1, 2) + [0.5, 0.0],
                          g.reshape(-1, 2) + [0.0, 0.25]]).astype(np.float32)
    jv, jg = jinterp.sample_dense(jnp.asarray(img), jnp.asarray(pts))
    tv, tg = tinterp.sample_dense(torch.tensor(img), torch.tensor(pts))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=0, atol=1e-4)
    n = g.reshape(-1, 2).shape[0]
    assert np.all(np.asarray(jg)[:n] == 0.0)
    assert np.all(tg.numpy()[:n] == 0.0)
