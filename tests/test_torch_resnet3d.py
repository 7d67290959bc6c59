"""The port's eval-mode ResNet3D against flax ResNet3D.apply(train=False).

Bridged weights, random non-trivial batch_stats so BatchNorm's running
statistics are exercised, a 16^3 grid with the 7 grid channels, f32 on CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neraf_tpu.models.resnet3d import ResNet3D as JResNet3D
from neraf_tpu_torch.bridge import load_state_dict, resnet_state_dict
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
    model = ResNet3D(backbone="resnet18")
    assert not model.training
    model.train()
    with pytest.raises(RuntimeError, match="eval mode only"):
        model(torch.zeros((1, 16, 16, 16, 7)))


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
