"""The numerics of the 3xTF32 tensor-core kernels of the fused lm-head
(csrc/fused_logprob_fwd.cu, csrc/fused_logprob_bwd.cu), emulated on the CPU.

The kernels split each f32 operand x into two TF32 numbers: hi = x rounded
to 10 mantissa bits (to nearest, ties away from zero), lo = x - hi (exact in
f32) rounded the same way, which is how the tensor cores read it. They then
accumulate hi*hi + hi*lo + lo*hi in f32. Products of TF32 numbers are exact
in f64, so an f64 matmul of the parts stands in for the tensor cores here.
The emulated forward and dH are held against the JAX package (the reference
and jax.grad of the Pallas kernels in interpret mode) at the port's
tolerances, 1e-4 and 2e-4, and hi*hi alone is shown to miss them, so this
test tells the two schemes apart. dW is emulated as its kernels compute it:
the coefficient from the logits, then hidden^T times coef^T, both split
transposed, each 32-deep stage's products rounded to f32 and summed in f32.
"""

import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from agilerl_tpu.ops.fused_loss import fused_token_logprob_diff as j_fused_diff  # noqa: E402
from agilerl_tpu.ops.fused_loss import reference_token_logprob as j_reference  # noqa: E402
from agilerl_tpu_torch.ops import fused_loss as tfl  # noqa: E402

torch.set_num_threads(1)

N, D, V = 67, 200, 1000  # none a multiple of the kernels' 128 x 128 x 32 tile
HEAD_SCALE = 0.3         # hidden ~ N(0, 1), head ~ N(0, 0.3^2): logits of std ~4.2


def _tf32_by_frexp(x: np.ndarray) -> np.ndarray:
    """x rounded to 11 significant bits, to nearest, ties away from zero,
    by frexp arithmetic (independent of the port's bit operations)."""
    out = np.empty_like(x, dtype=np.float64)
    for i, v in enumerate(x.astype(np.float64).ravel()):
        m, e = math.frexp(v)               # v = m 2^e, 0.5 <= |m| < 1
        q = math.floor(abs(m) * 2048 + 0.5)  # 11 bits, halves away from zero
        out.ravel()[i] = math.copysign(math.ldexp(q, e - 11), v)
    return out.astype(np.float32)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    hidden = rng.normal(size=(N, D)).astype(np.float32)
    head = (HEAD_SCALE * rng.normal(size=(D, V))).astype(np.float32)
    targets = rng.integers(0, V, N).astype(np.int32)
    g = rng.normal(size=N).astype(np.float32)
    return hidden, head, targets, g


def _mm(a, b, scheme):
    """a [M, K] @ b [K, P] as the tensor cores do it: '3x' = hi.hi + hi.lo +
    lo.hi, 'hi' = hi.hi alone (plain TF32)."""
    ah, al = tfl.split_tf32(a)
    bh, bl = tfl.split_tf32(b)
    out = ah.double() @ bh.double()
    if scheme == "3x":
        out = out + ah.double() @ bl.double() + al.double() @ bh.double()
    return out.float()


def _fwd(hidden, head, targets, temperature, scheme):
    z = _mm(hidden, head, scheme) / temperature
    lse = torch.logsumexp(z, dim=-1)
    return z.gather(1, targets.long()[:, None])[:, 0] - lse, lse


def _dh(hidden, head, targets, lse, g, temperature, scheme):
    z = _mm(hidden, head, scheme) / temperature
    coef = -torch.exp(z - lse[:, None])
    coef[torch.arange(z.shape[0]), targets.long()] += 1.0
    coef = coef * (g / temperature)[:, None]  # the kernels fold 1/T into coef
    return _mm(coef, head.t().contiguous(), scheme)


def test_split_is_exact_and_bit_for_bit():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.normal(size=500) * 10.0 ** rng.integers(-6, 6, 500),
                        [1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 3 * 2.0 ** -12, 0.0]])
    x = x.astype(np.float32)
    hi, lo = tfl.split_tf32(torch.as_tensor(x))
    np.testing.assert_array_equal(hi.numpy(), _tf32_by_frexp(x))  # ties go away from zero
    exact = torch.as_tensor(x) - hi
    assert torch.equal(hi + exact, torch.as_tensor(x))        # hi + (x - hi) == x, exactly
    np.testing.assert_array_equal(lo.numpy(), _tf32_by_frexp(exact.numpy()))
    for part in (hi, lo):  # the low 13 bits are 0: the tensor cores read them exactly
        assert int((part.view(torch.int32) & 0x1FFF).abs().sum()) == 0


@pytest.mark.parametrize("temperature", [1.0, 1.7])
def test_3xtf32_forward_and_dh_match_jax(temperature):
    hidden, head, targets, g = _inputs(1)
    th, tw, tt, tg = (torch.as_tensor(a) for a in (hidden, head, targets, g))
    want = np.asarray(j_reference(jnp.asarray(hidden), jnp.asarray(head), jnp.asarray(targets),
                                  temperature))
    want_dh = np.asarray(jax.grad(lambda h: jnp.sum(j_fused_diff(
        h, jnp.asarray(head), jnp.asarray(targets), temperature, 16, 128) * g))(
            jnp.asarray(hidden)))

    errs = {}
    for scheme in ("3x", "hi"):
        lp, lse = _fwd(th, tw, tt, temperature, scheme)
        dh = _dh(th, tw, tt, lse, tg, temperature, scheme)
        errs[scheme] = (np.abs(lp.numpy() - want).max(), np.abs(dh.numpy() - want_dh).max())
    assert errs["3x"][0] <= 1e-4 and errs["3x"][1] <= 2e-4, errs
    # plain TF32 misses both tolerances at this scale
    assert errs["hi"][0] > 1e-4 and errs["hi"][1] > 2e-4, errs


def _mm_staged(a, b):
    """a [M, K] times b [P, K]^T as the wgmma kernels take it (both operands
    K-major, split into hi/lo): each 32-deep stage's hi.hi + hi.lo + lo.hi
    (exact in f64) rounded to f32 and added into an f32 sum."""
    ah, al = (t.double() for t in tfl.split_tf32(a))
    bh, bl = (t.double() for t in tfl.split_tf32(b))
    out = torch.zeros(a.shape[0], b.shape[0], dtype=torch.float32)
    for k0 in range(0, a.shape[1], 32):
        k = slice(k0, k0 + 32)
        part = ah[:, k] @ bh[:, k].t() + ah[:, k] @ bl[:, k].t() + al[:, k] @ bh[:, k].t()
        out = out + part.float()
    return out


@pytest.mark.parametrize("temperature", [1.0, 1.7])
def test_3xtf32_dw_matches_jax(temperature):
    """dW as the tensor-core kernels compute it: the logits from hidden
    [N, D] and head^T [V, D] (K = D), the coefficient times 1/T, then
    hidden^T [D, N] times coef^T [V, N] (K = N), each operand split by the
    plain version of tf32x3_split (transposed where the kernels read it
    transposed). Held against jax.grad of the JAX kernels with respect to
    the head at 2e-4."""
    hidden, head, targets, g = _inputs(2)
    th, tw, tt, tg = (torch.as_tensor(a) for a in (hidden, head, targets, g))
    want = np.asarray(jax.grad(lambda w: jnp.sum(j_fused_diff(
        jnp.asarray(hidden), w, jnp.asarray(targets), temperature, 16, 128) * g))(
            jnp.asarray(head)))

    z = _mm_staged(th, tw.t().contiguous()) / temperature
    lse = torch.logsumexp(z, dim=-1)
    coef = -torch.exp(z - lse[:, None])
    coef[torch.arange(N), tt.long()] += 1.0
    coef = coef * (tg / temperature)[:, None]
    dw = _mm_staged(th.t().contiguous(), coef.t().contiguous())
    err = np.abs(dw.numpy() - want).max()
    assert err <= 2e-4, err


@pytest.mark.parametrize("rows", [1, 65, 129, 300])
def test_transposed_split_with_padded_ld(rows):
    """The plain tf32x3_split of x [rows, 200] transposed with a row stride
    padded for TMA: [200, ld], ld the next multiple of 4 floats, the split
    of x^T in the first ``rows`` columns bit for bit and zeros after."""
    x = torch.as_tensor(np.random.default_rng(rows).normal(size=(rows, 200)).astype(np.float32))
    ld = tfl.tma_ld(rows)
    assert ld % 4 == 0 and rows <= ld < rows + 4
    hi, lo = tfl.split_tf32(x, transpose=True, ld=ld)
    want_hi, want_lo = tfl.split_tf32(x.t().contiguous())
    assert hi.shape == lo.shape == (200, ld)
    assert torch.equal(hi[:, :rows], want_hi) and torch.equal(lo[:, :rows], want_lo)
    assert not hi[:, rows:].any() and not lo[:, rows:].any()
