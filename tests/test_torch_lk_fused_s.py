"""Port parity, the chain kernel at every state size, its blurred-tap mode
(K4b) and `lk_fused_gn_t` (K6), on their plain forms.

  * The plain chain kernel at S = 2 and 6 (SSD, NCC with ESM's J0,
    multi-channel SSD, one cubic kind) and at blur 2 and 4 against the
    JAX `lk_fused_chain(..., interpret=True)` with its bf16 casts made
    float32 (`test_torch_mc.pallas_f32`): val within 1.0, g and JtJ (NCC:
    the combined gradient and selft Hessian) within 1e-4 of their norms,
    the tolerances the S = 8 files use.
  * Plain K6 at S = 2 and 8, linear and cubic, with and without a crop,
    against the JAX `lk_fused_gn_t(..., interpret=True)` made float32
    alike, at the same tolerances.
  * The blurred-tap identity (a port of
    `tests/test_dense_interp.py:50-80`).
  * The K1-vs-K6 oracle (a port of `tests/test_dense_interp.py:134-181`)
    on the plain forms, at S = 2, 6 and 8.
  * The raw-sum rule's rounding floor that `chip_smoke.py` holds the
    CUDA forms to at S != 8: it passes other roundings, not faults.
The CUDA forms are held against these plain forms on the card
(`test_torch_gpu.py`, `chip_smoke.py`).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mtf_tpu.ops.pallas.lk_fused as jlk
from mtf_tpu.ops.pallas.dense_sample import _weights_dense as jweights
from mtf_tpu_torch.ops import interp as tinterp
from mtf_tpu_torch.ops.kernels import lk_fused as tk
from mtf_tpu_torch.ops.kernels.dense_sample import (_binomial_taps,
                                                    _weights_dense)
from mtf_tpu_torch.sm.lk import _blur2
import chip_smoke as cs
from chip_smoke import oracle_operands
from test_torch_gpu import assert_norm_close, gn_inputs, ssm_inputs
from test_torch_mc import _F32Jnp, pallas_f32


def _t(*arrays):
    return [None if a is None else torch.tensor(np.asarray(a))
            for a in arrays]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small CPU runs beside XLA's thread pool: one PyTorch thread (as the
    S = 8 files do)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _check(val, g, h, jv, jg, jh):
    np.testing.assert_allclose(val.numpy(), jv, atol=1.0, rtol=0)
    for b in range(val.shape[0]):
        assert_norm_close(g[b].numpy(), jg[b], 1e-4)
        assert_norm_close(h[b].numpy(), jh[b], 1e-4)


@pytest.mark.parametrize("s", [2, 6])
@pytest.mark.parametrize("am,esm,c,kind", [
    ("ssd", False, 1, "linear"), ("ncc", True, 1, "linear"),
    ("ssd", False, 2, "linear"), ("ssd", False, 1, "cubic")])
def test_plain_chain_at_s_matches_pallas_interpret(monkeypatch, s, am, esm,
                                                   c, kind):
    (win, M0, gens, ph, templ), j0 = ssm_inputs(100, s, am, esm, c, b=2,
                                                size=64)
    jv, jg, jh = pallas_f32(monkeypatch, win, M0, gens, ph, templ, am, j0,
                            kind)
    val, g, h = tk.lk_fused_chain(*_t(win, M0, gens, ph, templ), am=am,
                                  j0=_t(j0)[0], kind=kind)
    assert g.shape == (2, s) and h.shape == (2, s, s)
    _check(val, g, h, jv, jg, jh)


@pytest.mark.parametrize("s,blur,am,kind", [(6, 2, "ssd", "linear"),
                                            (8, 4, "ncc", "cubic")])
def test_plain_blurred_taps_match_pallas_interpret(monkeypatch, s, blur, am,
                                                   kind):
    """K4b: the blur-widened clip margins and binomial-convolved taps."""
    (win, M0, gens, ph, templ), _ = ssm_inputs(100, s, am, b=2, size=64)
    monkeypatch.setattr(jlk, "jnp", _F32Jnp())
    gj = jnp.asarray(gens)
    jv, jg, jh = (np.asarray(a) for a in jax.jit(jax.vmap(
        lambda w, m, p, t: jlk.lk_fused_chain(w, m, gj, p, t, kind,
                                              interpret=True, blur=blur,
                                              am=am)))(win, M0, ph, templ))
    monkeypatch.undo()
    val, g, h = tk.lk_fused_chain(*_t(win, M0, gens, ph, templ), am=am,
                                  kind=kind, blur=blur)
    _check(val, g, h, jv, jg, jh)
    # the blurred taps sample differently from the plain ones
    v0 = tk.lk_fused_chain(*_t(win, M0, gens, ph, templ), am=am,
                           kind=kind)[0]
    assert float((val - v0).abs().max()) > 1.0


def test_blur_must_fit_the_window():
    """A blur whose taps cannot fit the window (the widened clip bounds
    would cross) raises ValueError on every device, before anything runs."""
    (win, M0, gens, ph, templ), _ = ssm_inputs(100, 6, b=1, size=16)
    args = _t(win, M0, gens, ph, templ)
    tk.lk_fused_chain(*args, blur=8)                   # 16 taps fit in 16
    with pytest.raises(ValueError, match="taps"):
        tk.lk_fused_chain(*args, kind="cubic", blur=8)  # 18 do not
    with pytest.raises(ValueError, match="blur"):
        tk.lk_fused_chain(*args, blur=-1)
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="taps"):
        tk.lk_fused_chain_raw(*meta, kind="cubic", blur=8)


@functools.cache
def _jax_gn(s, kind):
    """The float32 JAX K6 (interpret mode) on `gn_inputs(400, s)` without a
    crop and with the 144-px one, from one compiled function."""
    args = gn_inputs(400, s, b=2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlk, "jnp", _F32Jnp())
        out = jax.jit(jax.vmap(lambda i, p, j, t: tuple(
            jlk.lk_fused_gn_t(i, p, j, t, kind, crop, interpret=True)
            for crop in (None, 144))))(*args)
    return args, {c: [np.asarray(a) for a in o]
                  for c, o in zip((None, 144), out)}


@pytest.mark.parametrize("s", [2, 8])
@pytest.mark.parametrize("kind", ["linear", "cubic"])
@pytest.mark.parametrize("crop", [None, 144])
def test_plain_k6_matches_pallas_interpret(s, kind, crop):
    (img, pts, jac, templ), want = _jax_gn(s, kind)
    jv, jg, jh = want[crop]
    val, g, h = tk.lk_fused_gn_t(*_t(img, pts, jac, templ), kind=kind,
                                 crop=crop)
    assert g.shape == (2, s) and h.shape == (2, s, s)
    _check(val, g, h, jv, jg, jh)


def test_k6_crop_origin_is_the_jax_rule():
    img, pts, _, _ = gn_inputs(50, 2, b=3)
    origin, hc, wc = tk.gn_crop(torch.tensor(pts), 180, 220, 144)
    assert (hc, wc) == (144, 144)
    want = np.clip(np.floor(pts.min(-1)) - 2.0, 0.0, [220 - 144, 180 - 144])
    np.testing.assert_array_equal(origin.numpy(), want)
    o2, h2, w2 = tk.gn_crop(torch.tensor(pts), 180, 220, 256)
    assert (h2, w2) == (180, 220) and not o2.any()


@pytest.mark.parametrize("kind", ["linear", "cubic"])
@pytest.mark.parametrize("blur", [2, 4])
def test_blurred_tap_weights_match_blurred_image(kind, blur):
    """_weights_dense(blur=k) equals the plain taps on the binomially
    blurred image (convolution commutes), the identity K4b relies on; and
    the weights are the JAX package's."""
    rng = np.random.default_rng(0)
    img = torch.tensor(rng.uniform(0, 255, (240, 320)), dtype=torch.float32)
    pts = torch.tensor(rng.uniform(60, 170, (400, 2)), dtype=torch.float32)
    interior = pts[(pts[:, 0] > 12) & (pts[:, 0] < 115) & (pts[:, 1] > 12)
                   & (pts[:, 1] < 115)]
    t = torch.arange(-8.0, 8.01, 0.37)
    wb, db = _weights_dense(t, kind, blur)
    taps = _binomial_taps(blur)
    r = (len(taps) - 1) // 2
    ref = sum(float(c) * _weights_dense(t - (i - r), kind)[0]
              for i, c in enumerate(taps))
    np.testing.assert_allclose(wb.numpy(), ref.numpy(), atol=1e-5)
    jw, jd = jweights(jnp.asarray(t.numpy()), kind, blur)
    np.testing.assert_allclose(wb.numpy(), np.asarray(jw), atol=1e-6)
    np.testing.assert_allclose(db.numpy(), np.asarray(jd), atol=1e-6)
    # end to end: blurred-tap sampling of the raw image equals plain
    # sampling of the blurred image (away from the borders)
    v_plain = tinterp.sample(_blur2(img, blur), interior, "linear")
    kx = torch.arange(img.shape[1], dtype=torch.float32)
    ky = torch.arange(img.shape[0], dtype=torch.float32)
    wx, _ = _weights_dense(kx[None, :] - interior[:, :1], "linear", blur)
    wy, _ = _weights_dense(ky[None, :] - interior[:, 1:2], "linear", blur)
    v_taps = torch.einsum("nh,hw,nw->n", wy, img, wx)
    np.testing.assert_allclose(v_taps.numpy(), v_plain[:, 0].numpy(),
                               atol=0.15)


@pytest.mark.parametrize("key", ["2", "6", "8"])
@pytest.mark.parametrize("n", [1024, 4500])
def test_k1_matches_k6_fed_the_jvp_jacobian(n, key):
    """The chain kernel's in-kernel projection and quotient-rule Jacobian
    equal K6 fed the (2S, N) Jacobian of the point map built by forward
    mode: val within 1.0, g and JtJ within 1e-4 of their norms."""
    img, M0, gens, ph, templ, ptsT, jacT = oracle_operands(torch, n, key,
                                                           "cpu")
    v1, g1, h1 = tk.lk_fused_gn_t(img[None], ptsT[None], jacT[None],
                                  templ[None])
    v2, g2, h2 = tk.lk_fused_chain(img[None], M0[None], gens, ph[None],
                                   templ[None])
    np.testing.assert_allclose(v1.numpy(), v2.numpy(), atol=1.0)
    assert_norm_close(g2[0].numpy(), g1[0].numpy(), 1e-4)
    assert_norm_close(h2[0].numpy(), h1[0].numpy(), 1e-4)


@pytest.mark.parametrize("am,esm", [("ssd", False), ("ncc", True)])
def test_raw_sum_rule_floor_passes_rounding_and_rejects_faults(am, esm):
    """`chip_smoke.raw_verdict`'s rounding floor (S != 8): sums of the same
    function rounded otherwise (the float64 plain form, rounded to float32)
    pass it where they miss 1e-4 of a cancelling norm, and the planted
    faults of `chip_smoke.PLANTED_FAULTS` (a bfloat16 window, one
    generator scaled by 1 + 1e-3) fail it."""
    frame = torch.as_tensor(cs._scene(0))
    args, j0 = cs._chain_inputs(torch, frame, 169, 384, am, esm, "cpu",
                                ssm_key="2", size=32, span=32)

    def exact(*a):
        return [o.float() for o in tk.lk_fused_chain_ref(
            *(x.double() for x in a), am=am,
            j0=None if j0 is None else j0.double(), kind="cubic")]

    want = tk.lk_fused_chain_ref(*args, am=am, j0=j0, kind="cubic")
    scales = cs.chain_sum_scales(torch, tk, args, am, j0, "cubic")
    assert not cs.raw_verdict(torch, exact(*args)[1:], want[1:])["ok"]
    sound = cs.raw_verdict(torch, exact(*args)[1:], want[1:], scales)
    assert sound["ok"] and sound["by_floor"].any()
    gens = args[2].clone()
    gens[0] *= 1 + 1e-3
    for bad in ((args[0].bfloat16().float(),) + tuple(args[1:]),
                tuple(args[:2]) + (gens,) + tuple(args[3:])):
        assert not cs.raw_verdict(torch, exact(*bad)[1:], want[1:],
                                  scales)["ok"]
