"""The port's eval-mode ResNet3D against flax ResNet3D.apply(train=False).

Bridged weights, random non-trivial batch_stats so BatchNorm's running
statistics are exercised, a 16^3 grid with the 7 grid channels, f32 on CPU;
both stems are the space-to-depth folded one (flax's stem_impl "s2d").
ResNet3D.stem (the s2d stem in train and eval mode, the baked stem with the
kernel gate on) against the direct F.conv3d in float64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from neraf_tpu.models.resnet3d import ResNet3D as JResNet3D
from neraf_tpu_torch.bridge import load_state_dict, resnet_state_dict
from neraf_tpu_torch.models.grid import (
    bake_cells_folded,
    cell_centers,
    fold_volume,
)
from neraf_tpu_torch.models.resnet3d import ResNet3D


def _random_stats(tree, rng):
    """Replace every BN mean/var with random values (var in [0.5, 1.5])."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out[k] = _random_stats(v, rng)
        elif k == "mean":
            out[k] = jnp.asarray(rng.normal(0, 0.2, v.shape), jnp.float32)
        else:
            out[k] = jnp.asarray(rng.uniform(0.5, 1.5, v.shape), jnp.float32)
    return out


@pytest.mark.parametrize("backbone,n_features", [("resnet18", 1024),
                                                 ("resnet50", 1024),
                                                 ("resnet18", 2048)])
def test_resnet3d_eval_matches_flax(backbone, n_features, rng):
    # f32 convolutions of up to 27*256 terms through 8-17 blocks; the
    # pooled features are O(1), so 1e-4 absolute with 1e-3 relative
    x = rng.uniform(0, 1, size=(1, 16, 16, 16, 7)).astype(np.float32)
    if n_features == 2048:  # layer4 needs one more halving
        x = rng.uniform(0, 1, size=(1, 32, 32, 32, 7)).astype(np.float32)
    jmodel = JResNet3D(backbone=backbone, n_features=n_features)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x), train=True)
    stats = _random_stats(variables["batch_stats"], rng)
    ref = np.asarray(jmodel.apply(
        {"params": variables["params"], "batch_stats": stats},
        jnp.asarray(x), train=False))

    model = ResNet3D(backbone=backbone, n_features=n_features)
    load_state_dict(model, resnet_state_dict(variables["params"], stats))
    with torch.no_grad():
        out = model(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (1, jmodel.feature_dim)
    assert model.feature_dim == jmodel.feature_dim
    assert np.abs(ref).max() > 1e-2  # the comparison is not of zeros
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-3)


def test_resnet3d_is_eval_only():
    """Built in eval mode (the serving paths use it so); train mode, which
    the joint step now uses, normalises with the batch's statistics
    instead (tests/test_torch_train.py holds it against flax)."""
    model = ResNet3D(backbone="resnet18")
    assert not model.training
    x = torch.rand((1, 16, 16, 16, 7), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        eval_out = model(x)
        model.train()
        model.set_update_stats(False)
        train_out = model(x)
    assert not torch.allclose(eval_out, train_out)


def test_seeded_init_is_xavier_and_reproducible():
    a, b = ResNet3D(backbone="resnet18"), ResNet3D(backbone="resnet18")
    a.reset_parameters(torch.Generator().manual_seed(4))
    b.reset_parameters(torch.Generator().manual_seed(4))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    w = a.conv1.weight.detach()  # (64, 7, 5, 5, 5): fans 7*125 and 64*125
    std = np.sqrt(2.0 / (7 * 125 + 64 * 125))
    assert abs(float(w.std()) / std - 1.0) < 0.05


@pytest.mark.parametrize("mode", ["gate_off", "gate_on", "eval"])
def test_stem_matches_conv3d_in_float64(mode):
    """ResNet3D.stem on the 7 grid channels against the direct conv (kernel
    5, stride 2, padding 2) and its autograd in float64, each of the
    output, the input gradient and the parameter's gradient to 1e-10 of its
    peak (only the order of the sums differs). gate_off and eval: the s2d
    stem of an NDHWC volume with D != H != W, the input gradient through
    the fold. gate_on: the baked stem over the folded 16^3 grid with one
    cursor batch's slab live and the weight gradient from stem_wgrad's
    plain version; the input gradient is the fresh cells', against the
    direct conv's gradient of the same cells."""
    net = ResNet3D(backbone="resnet18").double()
    net.reset_parameters(torch.Generator().manual_seed(3))
    net.train(mode != "eval")
    rng = np.random.default_rng(11)
    wr = net.conv1.weight.detach().clone().requires_grad_()
    if mode == "gate_on":
        R, B, cursor = 16, 64, 5 * 256 + 96
        grid = torch.from_numpy(rng.uniform(0, 1, size=(R ** 3, 7)))
        grid[:, 4:] = torch.from_numpy(cell_centers(R))  # as the slab's xyz
        fresh0 = torch.from_numpy(rng.uniform(0, 1, size=(B, 4)))
        g = torch.from_numpy(rng.normal(size=(1, 64, 8, 8, 8)))
        x, xr = fresh0.clone().requires_grad_(), fresh0.clone().requires_grad_()
        nf = fold_volume(grid.reshape(1, R, R, R, 7))
        slab = bake_cells_folded(nf, cursor, x, grid[:, 4:], R)
        out = net.stem(nf, bake_slab=(*slab, True))
        vol = torch.cat([grid[:cursor], torch.cat(
            [xr, grid[cursor:cursor + B, 4:]], -1), grid[cursor + B:]])
        ref = F.conv3d(vol.reshape(1, R, R, R, 7).permute(0, 4, 1, 2, 3), wr,
                       None, 2, 2)
    else:
        x0 = torch.from_numpy(rng.uniform(0, 1, size=(1, 12, 10, 14, 7)))
        g = torch.from_numpy(rng.normal(size=(1, 64, 6, 5, 7)))
        x, xr = x0.clone().requires_grad_(), x0.clone().requires_grad_()
        out = net.stem(x)
        ref = F.conv3d(xr.permute(0, 4, 1, 2, 3), wr, None, 2, 2)
    out.backward(g)
    ref.backward(g)
    assert net.conv1.weight.grad.shape == (64, 7, 5, 5, 5)
    for got, want in ((out, ref), (x.grad, xr.grad),
                      (net.conv1.weight.grad, wr.grad)):
        assert got.dtype == torch.float64 and got.shape == want.shape
        got, want = got.detach(), want.detach()
        err = float((got - want).abs().max() / want.abs().max())
        assert err <= 1e-10, err
