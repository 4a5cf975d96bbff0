"""Port parity, chain kernel K2 (NCC moments) and K3 (ESM's J0 operand),
and the NCC appearance model they serve.

On the CPU the port's plain form `lk_fused_chain_ref` (the raw sums) and
`ncc_combine` are held against
  1. a float32 JAX oracle: `interp.sample_dense` plus the jvp warp
     Jacobian (as `test_torch_lk_fused.py` builds it), the ESM mean
     Jacobian, and NCC's gradient and self Hessian by AD from
     `mtf_tpu.am.ncc`, and
  2. the JAX Pallas kernel itself in interpret mode, given the same
     bf16-rounded window.
Every point of these inputs stays inside its 128-row band of the Pallas
kernel, so its in-band mask drops none (the port has no bands).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mtf_tpu.ops.pallas.lk_fused as jlk
from mtf_tpu.am import get_am as jget_am
from mtf_tpu.am.base import AMState as JAMState
from mtf_tpu.am.base import self_hessian as jself_hessian
from mtf_tpu.ops import interp as jinterp
from mtf_tpu.ssm import get_ssm as jget_ssm
from mtf_tpu_torch.am import get_am as tget_am
from mtf_tpu_torch.ops import interp as tinterp
from mtf_tpu_torch.ops.kernels import lk_fused as tk
from test_torch_gpu import NEW_MODES, N_POINTS, assert_norm_close, mode_inputs

MODE_IDS = [tk.mode_name(am, esm) for am, esm in NEW_MODES]


def _t(*arrays):
    return [None if a is None else torch.tensor(np.asarray(a))
            for a in arrays]


def _oracle_one(win, M0, ph, templ, j0, esm):
    """One tracker's float32 JAX oracle -> (val (N,), Jm (S, N), NCC g
    (S,), NCC selft H (S, S)), with `templ` read as n0 for NCC and,
    with `esm`, the ESM mean Jacobian."""
    ssm = jget_ssm("8")
    S = ssm.dof

    def ptsT_of(dp):
        q = (M0 @ ssm.to_matrix(dp)) @ ph
        return q[:2] / q[2:3]

    zero = jnp.zeros((S,), jnp.float32)
    ptsT = ptsT_of(zero)
    rows = [jax.jvp(ptsT_of, (zero,), (jnp.eye(S, dtype=jnp.float32)[s],))[1]
            for s in range(S)]
    jx = jnp.stack([r[0] for r in rows])
    jy = jnp.stack([r[1] for r in rows])
    val, grad = jinterp.sample_dense(win, ptsT.T, "linear")
    Jm = grad[:, 0, 0][None] * jx + grad[:, 0, 1][None] * jy    # (S, N)
    if esm:
        Jm = 0.5 * (Jm + j0)
    ncc = jget_am("ncc")
    patch = val                                                 # (N, 1)
    st = JAMState(template=patch, p_am=jnp.zeros((0,), jnp.float32),
                  extra=(templ[:, None],))
    g = Jm @ ncc.grad_corrected(st, patch)[:, 0]
    H = jself_hessian(ncc, patch, st.p_am, Jm.T)
    return val[:, 0], Jm, g, H


@functools.partial(jax.jit, static_argnums=5)
def _oracle_f32(win, M0, ph, templ, j0, esm):
    """`_oracle_one` batched over trackers."""
    return jax.vmap(lambda *a: _oracle_one(*a, esm))(win, M0, ph, templ, j0)


def _oracle_moments(val, Jm, n0):
    """The K2 raw sums of the oracle's val and Jm, in float64."""
    val, Jm, n0 = (np.asarray(a, np.float64) for a in (val, Jm, n0))
    scal = np.stack([val.sum(-1), (val * val).sum(-1), (n0 * val).sum(-1),
                     np.full(val.shape[0], val.shape[-1]), n0.sum(-1)], -1)
    mom = np.stack([(Jm * val[:, None]).sum(-1), Jm.sum(-1)], 1)
    return ((Jm * n0[:, None]).sum(-1), Jm @ np.transpose(Jm, (0, 2, 1)),
            mom, scal)


# The combine subtracts nv m mᵀ and u uᵀ from R (a real cancellation) and
# divides by the variance, so the combined g and H are compared on their
# own scale. Measured on these inputs at N in {169, 625, 2500} (CPU,
# float32 port vs float32 oracle): val within 3.1e-4 levels, raw sums
# within 1.3e-6 of their norms, NCC g and H within 2.6e-6 of theirs; the
# bounds below leave 15x headroom or more.
RAW_REL = 2e-5
G_REL = 1e-4
H_REL = 1e-4


@pytest.mark.parametrize("n", N_POINTS)
@pytest.mark.parametrize("am,esm", NEW_MODES, ids=MODE_IDS)
def test_plain_k2_k3_match_f32_oracle(am, esm, n):
    """NCC: the raw sums against the oracle's, and the combine against
    NCC's AD gradient and selft Hessian. SSD with ESM: g = Jmᵀ(templ -
    val) and JmᵀJm of the mean Jacobian."""
    (win, M0, gens, ph, templ), j0 = mode_inputs(n, am, esm, b=2)
    out = tk.lk_fused_chain_ref(*_t(win, M0, gens, ph, templ), am=am,
                                j0=_t(j0)[0])
    j0_or_0 = np.zeros((2, 8, n), np.float32) if j0 is None else j0
    v0, Jm0, g0, H0 = (np.asarray(a) for a in _oracle_f32(
        win, M0, ph, templ, j0_or_0, esm))
    np.testing.assert_allclose(out[0].numpy(), v0, atol=1e-3, rtol=0)
    if am == "ssd":
        for b in range(2):
            assert_norm_close(out[1][b].numpy(), Jm0[b] @ (templ[b] - v0[b]),
                              1e-4)
            assert_norm_close(out[2][b].numpy(), Jm0[b] @ Jm0[b].T, 1e-4)
        return
    want = _oracle_moments(v0, Jm0, templ)
    for got, w in zip(out[1:], want):
        for b in range(2):
            assert_norm_close(got[b].numpy(), w[b], RAW_REL)
    g, h = tk.ncc_combine(*out[1:])
    for b in range(2):
        assert_norm_close(g[b].numpy(), g0[b], G_REL)
        assert_norm_close(-h[b].numpy(), H0[b], H_REL)


def _pallas(win, M0, gens, ph, templ, am, j0):
    """The Pallas kernel in interpret mode through the JAX wrapper
    (combined outputs), batched over trackers."""
    gj = jnp.asarray(gens)
    args = [jnp.asarray(a) for a in (win, M0, ph, templ)]
    if j0 is None:
        fn = jax.vmap(lambda w, m, p, t: jlk.lk_fused_chain(
            w, m, gj, p, t, interpret=True, am=am))
        return fn(*args)
    fn = jax.vmap(lambda w, m, p, t, j: jlk.lk_fused_chain(
        w, m, gj, p, t, interpret=True, am=am, j0=j))
    return fn(*args, jnp.asarray(j0))


# The Pallas kernel rounds the window AND the linear tap weights to bf16
# before its sampling dots; the port is given the same bf16-rounded
# window, so what remains is the tap-weight rounding, which the NCC
# combine carries into g and H. Measured on these inputs at N in {169,
# 625, 2500} (CPU, float32 port), worst over the three modes: max |dval|
# 0.48 levels, g within 2.0e-3 (SSD + ESM; NCC 1.5e-3) and h within
# 1.5e-3 (NCC; SSD + ESM 5.0e-4) of their norms; the bounds leave 2x or
# more headroom.
BF16_VAL_ATOL = 1.0
BF16_G_REL = 5e-3
BF16_H_REL = 4e-3


@pytest.mark.parametrize("n", N_POINTS)
@pytest.mark.parametrize("am,esm", NEW_MODES, ids=MODE_IDS)
def test_plain_k2_k3_match_pallas_interpret(am, esm, n):
    (win, M0, gens, ph, templ), j0 = mode_inputs(n, am, esm, b=2, seed=1)
    jv, jg, jh = _pallas(win, M0, gens, ph, templ, am, j0)
    win_bf16 = np.asarray(jnp.asarray(win).astype(jnp.bfloat16)
                          .astype(jnp.float32))
    val, g, h = tk.lk_fused_chain(*_t(win_bf16, M0, gens, ph, templ),
                                  am=am, j0=_t(j0)[0])
    np.testing.assert_allclose(val.numpy(), np.asarray(jv),
                               atol=BF16_VAL_ATOL, rtol=0)
    for b in range(2):
        assert_norm_close(g[b].numpy(), np.asarray(jg[b]), BF16_G_REL)
        assert_norm_close(h[b].numpy(), np.asarray(jh[b]), BF16_H_REL)


def test_ncc_combine_matches_jax_combine(monkeypatch):
    """The port's combine and the JAX wrapper's, on the same moments: the
    Pallas core is replaced by one that returns the port's plain moments
    (one tile), so the JAX wrapper's combine runs on exactly them."""
    (win, M0, gens, ph, n0), j0 = mode_inputs(625, "ncc", True, b=2)
    raw = tk.lk_fused_chain_ref(*_t(win, M0, gens, ph, n0), am="ncc",
                                j0=torch.tensor(j0))
    g, h = tk.ncc_combine(*raw[1:])
    for b in range(2):
        val, a, R, mom, scal = (np.asarray(x[b]) for x in raw)
        scal8 = np.zeros(8, np.float32)
        scal8[:5] = scal
        tiles = (val[None], a[None], R[None], mom[None],
                 scal8[None, None])

        def fake_core(*_args, tiles=tiles):
            return lambda *_a: tuple(jnp.asarray(x) for x in tiles)

        monkeypatch.setattr(jlk, "_chain_core_for", fake_core)
        _, jg, jh = jlk.lk_fused_chain(
            jnp.asarray(win[b]), jnp.asarray(M0[b]), jnp.asarray(gens),
            jnp.asarray(ph[b]), jnp.asarray(n0[b]), am="ncc",
            j0=jnp.asarray(j0[b]))
        assert_norm_close(g[b].numpy(), np.asarray(jg), 1e-6)
        assert_norm_close(h[b].numpy(), np.asarray(jh), 1e-6)


@pytest.mark.parametrize("am,esm", NEW_MODES, ids=MODE_IDS)
def test_wrapper_takes_plain_form_on_cpu(am, esm):
    """CPU tensors go to the plain form; no kernel launch is counted."""
    arrays, j0 = mode_inputs(169, am, esm, b=2)
    args = _t(*arrays)
    j0 = _t(j0)[0]
    before = dict(tk.lk_fused_chain_raw.launches)
    got = tk.lk_fused_chain_raw(*args, am=am, j0=j0)
    want = tk.lk_fused_chain_ref(*args, am=am, j0=j0)
    assert tk.lk_fused_chain_raw.launches == before
    assert len(got) == (5 if am == "ncc" else 3)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_ncc_similarity_and_init():
    """NCC's cached n0 and f against the JAX package's."""
    rng = np.random.default_rng(11)
    t0 = rng.uniform(0, 255, (2, 50, 1)).astype(np.float32)
    p = rng.uniform(0, 255, (2, 50, 1)).astype(np.float32)
    tam, jam = tget_am("ncc"), jget_am("ncc")
    st = tam.init(torch.as_tensor(t0))
    got = tam.f_corrected(st, torch.as_tensor(p))
    for b in range(2):
        jst = jam.init(jnp.asarray(t0[b]))
        np.testing.assert_allclose(st.extra[0][b].numpy(),
                                   np.asarray(jst.extra[0]), atol=1e-6)
        np.testing.assert_allclose(float(got[b]), float(jam.f(
            jst, jnp.asarray(p[b]))), atol=1e-6)


def test_sample_windows_matches_linear_mm():
    """Per-tracker window values equal `sample(window, pts, "linear_mm")`
    of the JAX package, edge and integer coordinates included."""
    rng = np.random.default_rng(12)
    win = rng.uniform(0, 255, (2, 20, 24)).astype(np.float32)
    pts = rng.uniform(-2, 26, (2, 60, 2)).astype(np.float32)
    pts[:, :10] = np.round(pts[:, :10])
    got = tinterp.sample_windows(torch.as_tensor(win),
                                 torch.as_tensor(pts[..., 0]),
                                 torch.as_tensor(pts[..., 1]))
    for b in range(2):
        want = jinterp.sample(jnp.asarray(win[b]), jnp.asarray(pts[b]),
                              "linear_mm")
        np.testing.assert_allclose(got[b].numpy(), np.asarray(want)[:, 0],
                                   atol=1e-3, rtol=0)
