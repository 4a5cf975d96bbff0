"""Port parity, the information-theoretic and structural AMs
(`mtf_tpu_torch/ops/hist.py`, `am/ssim.py`, `am/info.py`) against the JAX
package's (`mtf_tpu/ops/hist.py`, `am/ssim.py`, `am/info.py`) on the same
inputs: 16x16 patches of C = 1 and 3 channels, 8 and 32 bins.

Histogram quantities and similarities agree within 1e-5 relative;
gradients (df/dIt, df/dI0 through `init`) and the Gauss-Newton Hessian
within 1e-4 of their norm (`tests/test_dense_interp.py:
176-181`). The JAX references of every case are computed in one jit.
"""
import functools
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtf_tpu.am import get_am as jget_am
from mtf_tpu.am.base import AMParams as JAMParams
from mtf_tpu.am.base import gn_hessian as jgn_hessian
from mtf_tpu.ops import hist as jhist
from mtf_tpu_torch.am import AMParams, gn_hessian
from mtf_tpu_torch.am import get_am as tget_am
from mtf_tpu_torch.ops import hist as thist

REL = 1e-4          # gradients and Hessians, of their norm
VAL_REL = 1e-5      # histograms and similarities
RES = 16
S = 4


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """PyTorch on one thread in this module: beside XLA's compile of the
    references its OpenMP pool slows both (17 s against 11 s here)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- ops/hist.py --------------------------------------------------------------

def _pix(n=200, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 255, (n,)).astype(np.float32), \
        rng.uniform(0, 255, (n,)).astype(np.float32)


def _hist_chain(H, t, a, b, n_bins):
    """Every `hist` function of one package on the same inputs."""
    za, zb = H.to_bin_coords(a, n_bins), H.to_bin_coords(b, n_bins)
    w0, wt = H.bspl_weights(za, n_bins), H.bspl_weights(zb, n_bins)
    m, j = H.marginal_hist(w0), H.joint_hist(w0, wt)
    return [H.bspl3(t), H.bspl3_grad(t), H.cum_bspl3(t), za, w0,
            H.cum_bspl_weights(zb, n_bins), m, j, H.mutual_information(j),
            H.entropy(m)]


@pytest.mark.parametrize("n_bins", [8, 32])
def test_hist_functions_match_jax(n_bins):
    """bspl3, its derivative and cumulative form on a grid through every
    segment; bin coordinates, the Parzen and survival membership
    matrices, marginal and joint histograms, MI and entropy."""
    t = np.linspace(-2.5, 2.5, 401).astype(np.float32)
    a, b = _pix()
    got = _hist_chain(thist, *map(torch.tensor, (t, a, b)), n_bins)
    want = jax.jit(lambda *x: _hist_chain(jhist, *x, n_bins))(t, a, b)
    for i, (g, w) in enumerate(zip(got, want)):
        if i < 3:
            np.testing.assert_allclose(g.numpy(), w, rtol=VAL_REL, atol=1e-6)
        else:
            assert _rel(g.numpy(), w) < VAL_REL, i


def test_hist_batched_matches_per_sample():
    """Leading batch dims: a stack of two joint histograms is the two
    computed alone."""
    a, b = _pix()
    w0 = thist.bspl_weights(thist.to_bin_coords(torch.tensor(a), 8), 8)
    wt = thist.bspl_weights(thist.to_bin_coords(torch.tensor(b), 8), 8)
    both = thist.mutual_information(thist.joint_hist(
        torch.stack([w0, wt]), torch.stack([wt, w0])))
    assert torch.equal(both[0], thist.mutual_information(
        thist.joint_hist(w0, wt)))


# -- the AMs ------------------------------------------------------------------

AMS = ("ssim", "spss", "mi", "ccre", "kld", "lkld")
HIST_AMS = ("mi", "ccre", "kld", "lkld")
# the joint-histogram AMs also at 32 bins (nn1k's), on one channel
AM_CASES = ([(k, c, 8) for k in AMS for c in (1, 3)]
            + [(k, 1, 32) for k in ("mi", "ccre")])


def _inputs(c, seed=0):
    rng = np.random.default_rng(seed + c)
    n = RES * RES
    templ = rng.uniform(0, 255, (n, c)).astype(np.float32)
    patch = np.clip(templ + rng.normal(0, 12, templ.shape), 0, 255).astype(
        np.float32)
    J = rng.normal(0, 1, (n * c, S)).astype(np.float32)
    return templ, patch, J


def _params(nb):
    return dict(resx=RES, resy=RES, n_bins=nb, likelihood_alpha=7.0)


def _jam(key, c, nb):
    return jget_am(key if c == 1 else "mc" + key,
                   replace(JAMParams(), **_params(nb)))


def _tam(key, c, nb):
    return tget_am(key if c == 1 else key + "3", AMParams(**_params(nb)))


@functools.cache
def _refs():
    """{case: the JAX AM's f, grad, grad_template, Gauss-Newton Hessian,
    likelihood and distance features}, every case in one jit (one XLA
    compile: 12 s here against 13-18 s for one jit per case on 2-4
    threads)."""
    jams = [_jam(*case) for case in AM_CASES]
    ins = [_inputs(c) for _, c, _ in AM_CASES]

    def run(ins):
        out = []
        for jam, (t, p, J) in zip(jams, ins):
            st = jam.init(t)
            out.append([jam.f(st, p), jam.grad(st, p),
                        jam.grad_template(st, p), jgn_hessian(jam, st, p, J),
                        jam.likelihood(st, p), jam.dist_feat(p)])
        return out
    return {case: [np.asarray(x) for x in o]
            for case, o in zip(AM_CASES, jax.jit(run)(ins))}


def _f_scale(tam, st, patch, want):
    """The rounding scale of f: |f|, or for KLD and LKLD, whose f sums
    p0 (log p0 - log pt) to near 0 at a good match, the sum of the terms'
    magnitudes."""
    if tam.name not in ("kld", "lkld"):
        return abs(float(want))
    p0 = st.extra[0]
    pt = tam._marginals(tam._blocks(patch) if tam.name == "lkld" else patch)
    return float((p0 * (torch.log(p0 + 1e-8).abs()
                        + torch.log(pt + 1e-8).abs())).sum())


@pytest.mark.parametrize("key,c,nb", AM_CASES)
def test_am_matches_jax(key, c, nb):
    """f (within 1e-5 of its rounding scale, `_f_scale`), df/dIt, df/dI0
    (through `init`) and the Gauss-Newton Hessian at the patch, on
    C-channel 16x16 patches (some pixels saturated at 0 and 255, on a bin
    centre)."""
    tam = _tam(key, c, nb)
    templ, patch, J = (torch.tensor(x)[None] for x in _inputs(c))
    st = tam.init(templ)
    want = _refs()[(key, c, nb)]
    f = float(tam.f(st, patch)[0])
    assert abs(f - float(want[0])) < VAL_REL * _f_scale(tam, st, patch,
                                                        want[0])
    got = [tam.grad(st, patch), tam.grad_template(st, patch),
           gn_hessian(tam, st, patch, J)]
    for name, g, w in zip(("grad", "grad_template", "gn_hessian"), got,
                          want[1:4]):
        assert _rel(g[0].numpy(), w) < REL, name


@pytest.mark.parametrize("key,c,nb", [(k, c, nb) for k, c, nb in AM_CASES
                                      if nb == 8])
def test_likelihood_and_dist_feat_match_jax(key, c, nb):
    """The sampler-facing likelihood (SSIM and SPSS: exp(-alpha (1 - f));
    MI and CCRE: exp(alpha f); KLD, LKLD: the default exp(alpha f)) and
    the NN distance features (MI: the binned weights; CCRE: the survival
    weights; the others: the flat raw patch)."""
    tam = _tam(key, c, nb)
    templ, patch, _ = (torch.tensor(x)[None] for x in _inputs(c))
    st = tam.init(templ)
    want = _refs()[(key, c, nb)]
    assert _rel(tam.likelihood(st, patch)[0].numpy(), want[4]) < VAL_REL
    assert _rel(tam.dist_feat(patch)[0].numpy(), want[5]) < VAL_REL


@pytest.mark.parametrize("key", ["ssd", "ncc"])
def test_ssd_ncc_likelihood_matches_jax(key):
    """SSD's likelihood exp(-alpha * the RMS residual) and NCC's
    exp(-alpha (1 - f)), on 3-channel patches; their distance features
    (SSD: the flat raw patch; NCC: the centred unit patch)."""
    tam, jam = _tam(key, 3, 8), _jam(key, 3, 8)
    templ, patch, _ = _inputs(3)
    want, want_feat = jax.jit(lambda t, p: (
        jam.likelihood(jam.init(t), p), jam.dist_feat(p)))(templ, patch)
    got = tam.likelihood(tam.init(torch.tensor(templ)[None]),
                         torch.tensor(patch)[None])
    assert _rel(got[0].numpy(), want) < VAL_REL
    assert _rel(tam.dist_feat(torch.tensor(patch)).numpy(),
                want_feat) < VAL_REL


@pytest.mark.parametrize("key", AMS + ("ssd", "ncc"))
def test_particle_axis_broadcasts(key):
    """Patches (B, P, N, C) against a state whose tensors carry a particle
    axis of 1 (the PF's scoring) give each particle its own f."""
    from mtf_tpu_torch.sm.pf import _particle_view
    tam = _tam(key, 3, 8)
    templ, patch, _ = _inputs(3)
    rng = np.random.default_rng(5)
    parts = torch.tensor(patch[None, None] + rng.normal(
        0, 4, (2, 3) + patch.shape).astype(np.float32))
    st = tam.init(torch.tensor(np.stack([templ, patch])))
    got = tam.f(_particle_view(st), parts)
    assert got.shape == (2, 3)
    for b in range(2):
        one = tam.init(st.template[b:b + 1].expand(3, -1, -1))
        torch.testing.assert_close(got[b], tam.f(one, parts[b]),
                                   rtol=1e-6, atol=1e-6)


def test_lkld_blocks_match_jax():
    """LKLD's k x k blocks, including the crop to a multiple of k, in the
    JAX package's order."""
    from mtf_tpu_torch.am.info import LKLD
    prm = AMParams(resx=7, resy=5, n_channels=2, extra={"sub_regions": 2})
    jprm = replace(JAMParams(), resx=7, resy=5, n_channels=2,
                   extra={"sub_regions": 2})
    p = np.arange(70, dtype=np.float32).reshape(35, 2)
    got = LKLD(prm)._blocks(torch.tensor(p)[None])[0].numpy()
    want = np.asarray(jget_am("lkld", jprm)._blocks(jnp.asarray(p)))
    np.testing.assert_array_equal(got, want)
