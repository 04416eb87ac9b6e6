"""The stat-free 3x3 conv (``ops/cuda/conv3x3_flat.py``) against the JAX
package: the plain versions of ``conv3x3_flat`` and ``conv3x3_im2col``
against the Pallas kernels they port (``ops/pallas/conv3x3.py``, in interpret
mode on the CPU), and ``conv3x3_same``'s input gradient against ``jax.vjp`` of
the JAX VGG conv (``layers.conv2d`` with zero padding). On CPU tensors the
wrappers run the plain versions and launch no kernel."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from styletransfer_tpu.ops import layers as jlayers
from styletransfer_tpu.ops.pallas import conv3x3 as pconv
from styletransfer_tpu_torch.ops.cuda import conv3x3_flat as tc

# f32: the same products summed in another order over K = 9C <= 576 terms.
ATOL = 1e-4
# The VJP through one conv: relative L2 of the input gradient.
GRAD_REL_L2 = 1e-5


def _inputs(C, O, seed=0, H=9, W=7, B=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H + 2, W + 2, C)).astype(np.float32)
    w = (rng.standard_normal((3, 3, C, O)) / np.sqrt(9 * C)).astype(np.float32)
    b = rng.standard_normal(O).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("kernel", ["flat", "im2col"])
@pytest.mark.parametrize("C,O", [(3, 64), (16, 8), (64, 3)])
@pytest.mark.parametrize("relu", [False, True])
def test_plain_matches_the_jax_kernel_in_interpret_mode(kernel, C, O, relu):
    x, w, b = _inputs(C, O)
    jfn = {"flat": pconv.conv3x3_flat, "im2col": pconv.conv3x3_im2col}[kernel]
    want = np.asarray(jfn(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), relu=relu,
                          interpret=True))
    args = (torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))
    counts = tc.flat_launches, tc.im2col_launches
    got = getattr(tc, f"conv3x3_{kernel}")(*args, relu)
    assert (tc.flat_launches, tc.im2col_launches) == counts  # CPU: the plain version
    assert torch.equal(got, getattr(tc, f"conv3x3_{kernel}_plain")(*args, relu))
    assert got.shape == want.shape == (2, 9, 7, O) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("kernel", ["flat", "im2col"])
def test_bf16_plain_is_the_f32_result_rounded_once(kernel):
    x, w, b = _inputs(16, 24, seed=1)
    xq, wq = torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16()
    plain = getattr(tc, f"conv3x3_{kernel}_plain")
    want = plain(xq.float(), wq.float(), torch.from_numpy(b), True)
    got = plain(xq, wq, torch.from_numpy(b), True)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want, rtol=2 ** -7, atol=1e-6)


def test_the_two_plain_forms_agree():
    x, w, b = _inputs(32, 40, seed=2)
    args = (torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))
    torch.testing.assert_close(tc.conv3x3_flat_plain(*args), tc.conv3x3_im2col_plain(*args),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("C,O", [(3, 64), (64, 64), (64, 3)])
def test_conv3x3_same_matches_the_jax_vgg_conv_and_its_vjp(C, O):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 10, 8, C)).astype(np.float32)
    w = (rng.standard_normal((3, 3, C, O)) / np.sqrt(9 * C)).astype(np.float32)
    b = rng.standard_normal(O).astype(np.float32)
    g = rng.standard_normal((2, 10, 8, O)).astype(np.float32)
    want, vjp = jax.vjp(
        lambda a: jlayers.conv2d(a, jnp.asarray(w), jnp.asarray(b), stride=1, reflect=False),
        jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    got = tc.conv3x3_same(xt, torch.from_numpy(w), torch.from_numpy(b))
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=ATOL)
    want_dx = np.asarray(want_dx)
    rel = np.linalg.norm(xt.grad.numpy() - want_dx) / np.linalg.norm(want_dx)
    assert rel <= GRAD_REL_L2


def test_conv3x3_same_refuses_weights_that_want_a_gradient():
    x, w, b = torch.zeros(1, 4, 4, 3), torch.zeros(3, 3, 3, 8), torch.zeros(8)
    with pytest.raises(NotImplementedError, match="input gradient only"):
        tc.conv3x3_same(x, w.requires_grad_(), b)
    with pytest.raises(NotImplementedError, match="input gradient only"):
        tc.conv3x3_same(x, w.detach(), b.requires_grad_())
    with torch.no_grad():  # nothing would need the gradient
        assert tc.conv3x3_same(x, w, b).shape == (1, 4, 4, 8)


def test_the_routing_rule_sends_few_input_channels_to_im2col():
    assert [tc.uses_im2col(c) for c in (1, 3, 31, 32, 64, 256)] == [
        True, True, True, False, False, False]


@pytest.mark.parametrize("bad, err", [
    (dict(x=np.zeros((1, 5, 5, 4), np.float16)), TypeError),
    (dict(w=np.zeros((3, 3, 5, 8), np.float32)), ValueError),
    (dict(b=np.zeros(8, np.float64)), ValueError),
    (dict(x=np.zeros((1, 2, 5, 4), np.float32)), ValueError),
])
def test_wrappers_check_their_inputs(bad, err):
    args = dict(x=np.zeros((1, 5, 5, 4), np.float32), w=np.zeros((3, 3, 4, 8), np.float32),
                b=np.zeros(8, np.float32))
    args.update(bad)
    t = {k: torch.from_numpy(v) for k, v in args.items()}
    for fn in (tc.conv3x3_flat, tc.conv3x3_im2col):
        with pytest.raises(err):
            fn(t["x"], t["w"], t["b"])
