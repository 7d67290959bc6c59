"""The port's ResNet3D against every layout of the JAX ResNet3D, on the CPU.

The JAX ResNet3D has two layout fields: conv_impl ("direct", or
"mm_wgrad", the weight gradient as one product per kernel tap) and
pool_impl ("separable", its default: three 1-D max pools, or "direct", the
joint 3^3 pool). The port has one layout, cuDNN's convolutions and the
joint pool (models/resnet3d.py says why). Each JAX layout computes the same
function:

- the port's ResNet3D against the JAX ResNet3D at each of the four
  settings, train mode over a tie-free 32^3 grid (uniform values: the pool
  sees no tie that a gradient reaches): the features, the input gradient
  and every parameter's gradient to 1e-4 of the peak (f32 convolutions
  through 8 blocks, test_torch_train.py's bound);
- the stem's max pool on an input with exact ties (values on a 0.5 grid):
  the port's values are both JAX pools' bitwise, its gradient the joint
  pool's bitwise, and the separable pool routes a tie's gradient to another
  (equal-valued) element.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from neraf_tpu.models.resnet3d import ResNet3D as JResNet3D
from neraf_tpu_torch.bridge import load_state_dict, resnet_state_dict
from neraf_tpu_torch.models.resnet3d import ResNet3D

T = lambda a: torch.from_numpy(np.array(a))
to_ncdhw = lambda a: np.ascontiguousarray(np.transpose(a, (0, 4, 1, 2, 3)))
to_ndhwc = lambda a: np.transpose(a, (0, 2, 3, 4, 1))


def _peak_close(a, b, tol, what=""):
    b = np.asarray(b)
    np.testing.assert_allclose(np.asarray(a), b, rtol=0,
                               atol=tol * max(np.abs(b).max(), 1e-30),
                               err_msg=what)


@pytest.mark.parametrize("conv_impl,pool_impl", [
    ("mm_wgrad", "direct"), ("mm_wgrad", "separable"), ("direct", "separable"),
    ("direct", "direct")])
def test_resnet_layouts_match_jax(conv_impl, pool_impl):
    rng = np.random.default_rng(6)
    x = rng.uniform(0, 1, (1, 32, 32, 32, 7)).astype(np.float32)
    r = rng.normal(size=(1, 256)).astype(np.float32)
    jmodel = JResNet3D(backbone="resnet18", n_features=1024,
                       conv_impl=conv_impl, pool_impl=pool_impl)
    variables = jmodel.init(jax.random.PRNGKey(1), jnp.asarray(x), train=True)

    def jf(params, xx):
        feat, _ = jmodel.apply({"params": params,
                                "batch_stats": variables["batch_stats"]},
                               xx, train=True, mutable=["batch_stats"])
        return jnp.sum(feat * r), feat

    (_, jfeat), (jgp, jdx) = jax.jit(jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True))(variables["params"], jnp.asarray(x))
    model = ResNet3D(backbone="resnet18", n_features=1024)
    load_state_dict(model, resnet_state_dict(variables["params"],
                                             variables["batch_stats"]))
    model.train()
    xt = T(x).requires_grad_()
    feat = model(xt)
    (feat * T(r)).sum().backward()
    _peak_close(feat.detach().numpy(), jfeat, 1e-4, "features")
    _peak_close(xt.grad.numpy(), jdx, 1e-4, "input gradient")
    want = resnet_state_dict(jgp, variables["batch_stats"])
    grads = dict(model.named_parameters())
    assert grads
    for k, p in grads.items():
        _peak_close(p.grad.numpy(), want[k].numpy(), 1e-4, k)
    assert float(np.abs(want["conv1.weight"].numpy()).max()) > 0


def _jax_pool(x, pool_impl):
    import flax.linen as fnn

    if pool_impl == "direct":
        return fnn.max_pool(x, (3, 3, 3), strides=(2, 2, 2),
                            padding=((1, 1),) * 3)
    x = fnn.max_pool(x, (3, 1, 1), strides=(2, 1, 1),
                     padding=((1, 1), (0, 0), (0, 0)))
    x = fnn.max_pool(x, (1, 3, 1), strides=(1, 2, 1),
                     padding=((0, 0), (1, 1), (0, 0)))
    return fnn.max_pool(x, (1, 1, 3), strides=(1, 1, 2),
                        padding=((0, 0), (0, 0), (1, 1)))


def test_max_pool_tie_routing_matches_jax():
    """The pool of ResNet3D.forward (F.max_pool3d(x, 3, 2, 1)) on ties."""
    rng = np.random.default_rng(3)
    x = (np.round(rng.normal(size=(1, 16, 16, 16, 4)) * 2.0) / 2.0).astype(
        np.float32)
    g = rng.normal(size=(1, 8, 8, 8, 4)).astype(np.float32)
    xt = T(to_ncdhw(x)).requires_grad_()
    y = F.max_pool3d(xt, 3, 2, 1)
    (y * T(to_ncdhw(g))).sum().backward()
    y, dx = to_ndhwc(y.detach().numpy()), to_ndhwc(xt.grad.numpy())
    jgrads = {}
    for impl in ("direct", "separable"):
        jy, vjp = jax.vjp(lambda xx: _jax_pool(xx, impl), jnp.asarray(x))
        (jgrads[impl],) = vjp(jnp.asarray(g))
        np.testing.assert_array_equal(y, np.asarray(jy))
    np.testing.assert_array_equal(dx, np.asarray(jgrads["direct"]))
    assert not np.array_equal(dx, np.asarray(jgrads["separable"]))
