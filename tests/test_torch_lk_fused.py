"""Port parity, chain kernel K1 (`lk_fused_chain`, SSD, one channel).

On the CPU the port's plain form `lk_fused_chain_ref` is held against
  1. a float32 JAX oracle: `interp.sample_dense` plus the jvp warp
     Jacobian, then g = J^T r and J^T J (as tests/test_dense_interp.py
     builds it), and
  2. the JAX Pallas kernel itself in interpret mode, which samples a
     bf16 window with bf16 tap weights.
The CUDA kernel is held against the plain form on the card (marker
`gpu`; skipped where there is no CUDA device).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtf_tpu.ops import interp as jinterp
from mtf_tpu.ops.pallas.lk_fused import lk_fused_chain as jchain
from mtf_tpu.ssm import get_ssm as jget_ssm
from mtf_tpu_torch.ops.kernels import lk_fused as tk
from test_torch_gpu import N_POINTS, assert_norm_close, chain_inputs


@jax.jit
@jax.vmap
def _oracle_f32(win, M0, ph, templ):
    """Per-tracker float32 JAX oracle (dense sampling + jvp Jacobian),
    batched over trackers."""
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
    J = grad[:, 0, 0][None] * jx + grad[:, 0, 1][None] * jy     # (S, N)
    r = templ - val[:, 0]
    return val[:, 0], J @ r, J @ J.T


def _t(*arrays):
    return [torch.tensor(np.asarray(a)) for a in arrays]


@pytest.mark.parametrize("n", N_POINTS)
def test_plain_k1_matches_f32_oracle(n):
    inputs = chain_inputs(n)
    win, M0, _, ph, templ = inputs
    val, g, h = tk.lk_fused_chain_ref(*_t(*inputs))
    v0, g0, h0 = (np.asarray(a) for a in _oracle_f32(win, M0, ph, templ))
    np.testing.assert_allclose(val.numpy(), v0, atol=1e-3, rtol=0)
    for b in range(win.shape[0]):
        assert_norm_close(g[b].numpy(), g0[b], 1e-4)
        assert_norm_close(h[b].numpy(), h0[b], 1e-4)


# The Pallas kernel rounds the window AND the linear tap weights to bf16
# (8 significant bits) before its sampling dots; the port is given the
# same bf16-rounded window, so what remains is the tap-weight rounding.
# Measured on these inputs at N in {169, 625, 2500} (CPU, float32 port):
# max |dval| 0.484 levels, g within 2.0e-3 and J^T J within 5.0e-4 of
# their norms; the bounds below leave 2.5-4x headroom.
BF16_VAL_ATOL = 1.0
BF16_G_REL = 5e-3
BF16_H_REL = 2e-3


@pytest.mark.parametrize("n", N_POINTS)
def test_plain_k1_matches_pallas_interpret(n):
    win, M0, gens, ph, templ = chain_inputs(n, b=2, seed=1)
    jv, jg, jh = jax.vmap(
        lambda w, m, p, t: jchain(w, m, jnp.asarray(gens), p, t,
                                  interpret=True))(
        jnp.asarray(win), jnp.asarray(M0), jnp.asarray(ph),
        jnp.asarray(templ))
    # like with like: the port samples the same bf16-rounded window
    win_bf16 = np.asarray(jnp.asarray(win).astype(jnp.bfloat16)
                          .astype(jnp.float32))
    val, g, h = tk.lk_fused_chain_ref(*_t(win_bf16, M0, gens, ph, templ))
    np.testing.assert_allclose(val.numpy(), np.asarray(jv),
                               atol=BF16_VAL_ATOL, rtol=0)
    for b in range(2):
        assert_norm_close(g[b].numpy(), np.asarray(jg[b]), BF16_G_REL)
        assert_norm_close(h[b].numpy(), np.asarray(jh[b]), BF16_H_REL)


def test_wrapper_takes_plain_form_on_cpu():
    """CPU tensors go to the plain form; no kernel launch is counted."""
    args = _t(*chain_inputs(169, b=2))
    before = dict(tk.lk_fused_chain_raw.launches)
    got = tk.lk_fused_chain(*args)
    want = tk.lk_fused_chain_ref(*args)
    assert tk.lk_fused_chain_raw.launches == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_block_warps_cover_every_n():
    """The CUDA chain kernel's block size: 1 to 8 warps, more points more
    warps, each warp at least one 32-point chunk where N has them, and
    every warp of a full block busy at the headline's N = 2500."""
    prev = 1
    for n in range(1, 5001):
        w = tk.block_warps(n)
        assert 1 <= w <= tk.MAX_WARPS and w >= prev, n
        assert w == 1 or 32 * (w - 1) < n, n
        prev = w
    assert tk.block_warps(2500) == tk.MAX_WARPS
