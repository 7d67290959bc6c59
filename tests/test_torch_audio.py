"""The port's encodings and acoustic model against the JAX package (CPU, f32).

Weights come from the JAX initialisers and cross over through the bridge;
inputs come from numpy with a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from neraf_tpu.configs.config import AudioModelConfig
from neraf_tpu.fields.acoustic import AcousticSoundField as JField
from neraf_tpu.models.audio import AudioModel as JAudioModel
from neraf_tpu.ops import encodings as jenc
from neraf_tpu_torch.bridge import field_state_dict, load_state_dict
from neraf_tpu_torch.fields.acoustic import AcousticSoundField
from neraf_tpu_torch.models.audio import AudioModel
from neraf_tpu_torch.ops import encodings as tenc

T = torch.from_numpy


def test_nerf_encoding_matches_jax(rng):
    # angles reach 2*pi*256 rad: one float32 ulp of the angle (~1e-4 rad)
    # bounds the difference of the sines
    x = rng.uniform(0.0, 1.0, size=(7, 3)).astype(np.float32)
    out = tenc.nerf_encoding(T(x)).numpy()
    ref = np.asarray(jenc.nerf_encoding(jnp.asarray(x)))
    assert out.shape == ref.shape == (7, tenc.nerf_encoding_dim(3, 10))
    np.testing.assert_allclose(out, ref, atol=5e-4, rtol=0)
    np.testing.assert_array_equal(out[:, -3:], x)  # input appended last


def test_sh_encoding_matches_jax(rng):
    # polynomials of degree <= 3 in float32
    d = rng.uniform(0.0, 1.0, size=(11, 3)).astype(np.float32)
    out = tenc.sh_encoding(T(d)).numpy()
    ref = np.asarray(jenc.sh_encoding(jnp.asarray(d)))
    assert out.shape == ref.shape == (11, tenc.SH_DIM)
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=1e-5)


def test_acoustic_field_matches_jax_with_bridged_params(rng):
    # five float32 layers up to 5096 wide, summed in another order; outputs
    # are tanh*10, so compare absolutely
    in_dim, w, C, F = 40, 32, 2, 33
    jfield = JField(hidden_w=w, sound_rez=C, n_frequencies=F)
    variables = jfield.init(jax.random.PRNGKey(3), jnp.zeros((1, in_dim)))
    field = AcousticSoundField(in_dim, hidden_w=w, sound_rez=C,
                               n_frequencies=F)
    load_state_dict(field, field_state_dict(variables))
    h = rng.normal(size=(9, in_dim)).astype(np.float32)
    with torch.no_grad():
        out = field(T(h)).numpy()
    ref = np.asarray(jfield.apply(variables, jnp.asarray(h)))
    assert out.shape == ref.shape == (9, C, F)
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)


def test_seeded_init_matches_flax_statistics():
    """reset_parameters draws flax's lecun_normal: truncated at 2 std of
    sqrt(1/fan_in)/0.8796, i.e. a weight std of sqrt(1/fan_in)."""
    field = AcousticSoundField(1145, hidden_w=512)
    field.reset_parameters(torch.Generator().manual_seed(0))
    wt = field.trunk[0].weight.detach()  # (5096, 1145)
    std = np.sqrt(1.0 / 1145)
    assert abs(float(wt.std()) / std - 1.0) < 0.01
    assert float(wt.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6
    assert float(field.trunk[0].bias.detach().abs().max()) == 0.0


def _audio_models(feat_dim, max_len=12):
    cfg = AudioModelConfig(dataset="SoundSpaces", max_len=max_len,
                           n_freq_stft=257, w_field=16).resolve()
    jmodel = JAudioModel(config=cfg, grid_feature_dim=feat_dim)
    params = jmodel.init(jax.random.PRNGKey(1))
    model = AudioModel(cfg, grid_feature_dim=feat_dim)
    load_state_dict(model.field, field_state_dict(params))
    return jmodel, params, model.eval()


def _poses(rng, n):
    mic = rng.uniform(-3.5, 3.5, size=(n, 3)).astype(np.float32)  # some out of box
    src = rng.uniform(-2.0, 2.0, size=(n, 3)).astype(np.float32)
    rot = rng.uniform(0.0, 1.0, size=(n, 3)).astype(np.float32)
    return mic, src, rot


def test_audio_forward_and_render_rirs_batch_match_jax(rng):
    # the field's tolerance; the grid feature enters first in both
    feat_dim = 24
    jmodel, params, model = _audio_models(feat_dim)
    aabb = np.array([[-3.0, -3.0, -3.0], [3.0, 3.0, 3.0]], np.float32)
    feat = rng.normal(size=(feat_dim,)).astype(np.float32)
    mic, src, rot = _poses(rng, 5)
    tq = rng.integers(0, 12, size=5)

    batch = {"time_query": tq, "mic_pose": mic, "source_pose": src, "rot": rot}
    with torch.no_grad():
        out = model({k: T(np.asarray(v)) for k, v in batch.items()}, T(aabb),
                    T(feat)).numpy()
    ref = np.asarray(jmodel.apply(params, {k: jnp.asarray(v)
                                           for k, v in batch.items()},
                                  jnp.asarray(aabb), jnp.asarray(feat)))
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)

    with torch.no_grad():
        rirs = model.render_rirs_batch(T(mic), T(src), T(rot), T(aabb),
                                       T(feat)).numpy()
    jrirs = np.asarray(jmodel.render_rirs_batch(
        params, jnp.asarray(mic), jnp.asarray(src), jnp.asarray(rot),
        jnp.asarray(aabb), jnp.asarray(feat)))
    assert rirs.shape == jrirs.shape == (5, 2, 257, 12)
    np.testing.assert_allclose(rirs, jrirs, atol=1e-4, rtol=0)


def test_normalize_positions_zeroes_outside_the_open_box():
    from neraf_tpu.models.audio import normalize_positions as jnorm
    from neraf_tpu_torch.models.audio import normalize_positions

    aabb = np.array([[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]], np.float32)
    pos = np.array([[0.0, 0.5, -0.5], [1.0, 0.0, 0.0], [-1.0, 0.2, 0.2],
                    [0.3, 2.0, 0.0]], np.float32)
    out = normalize_positions(T(pos), T(aabb)).numpy()
    np.testing.assert_array_equal(out, np.asarray(jnorm(jnp.asarray(pos),
                                                        jnp.asarray(aabb))))
    np.testing.assert_array_equal(out[1:], 0.0)  # on the faces counts as out
