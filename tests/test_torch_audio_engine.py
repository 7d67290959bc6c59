"""The port's AudioEngine against the JAX package's, on the CPU in float32.

Both engines start from one JAX init_state (the port's field loaded
through bridge.field_state_dict) and train on the same synthetic split
(data/synthetic.py::synth_scene against scripts/validate_learning.py's);
the port is handed the (recording, time bin) indices the JAX step draws
from state.rng (audio_engine.py:72-75, loader.py:31-33).

Tolerances, as tests/test_torch_train.py and test_torch_train_slice.py
hold the joint groups: the losses 1e-5 relative; every gradient to 1e-4
of its tensor's peak, against jax.grad of the JAX model's loss on the JAX
step's batch (measured 5e-7). The JAX step's own gradient (kept by
test_torch_train_slice.py's recording optax wrapper, swapped onto the
engine before its step is traced; no JAX file changes) is not the oracle:
XLA:CPU's jitted step computes the first trunk layer's weight gradient
0.8% of its peak away from jax.grad's eager value, while the port agrees
with the eager one (measured). After the update, every parameter moved by
the learning rate where its gradient is above 1e-10 (Adam's first step
is lr * g / (|g| + 1e-15), 1e-4 relative), not at all where it is 0, and
equal to the JAX step's result to 1e-6 wherever the JAX step's gradient is
above 5% of its tensor's peak (below that its 0.8% can flip a sign).
`evaluate` from JAX's Griffin-Lim angles, at
test_torch_eval_paths.py's bounds for evaluate_audio: the same keys and
invalid-T60 count, C50, magnitudes and the quick metric 1e-3 relative, T60
and EDT 1e-2 (32 Griffin-Lim iterations amplify float32 rounding).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neraf_tpu.configs.config import AudioModelConfig as JAudioModelConfig
from neraf_tpu.configs.config import ExperimentConfig as JExperimentConfig
from neraf_tpu.data.loader import gather_audio_batch as jgather_audio_batch
from neraf_tpu.engine.audio_engine import AudioEngine as JAudioEngine
from neraf_tpu.models.audio import AudioModel as JAudioModel
from neraf_tpu_torch.bridge import field_state_dict, load_state_dict
from neraf_tpu_torch.configs.config import AudioModelConfig, ExperimentConfig
from neraf_tpu_torch.data.synthetic import synth_scene
from neraf_tpu_torch.engine.audio_engine import AudioEngine
from neraf_tpu_torch.models.audio import AudioModel
from scripts.validate_learning import synth_scene as jsynth_scene
from test_torch_eval_paths import _jax_angles
from test_torch_train_slice import _recording

T, N_TRAIN, N_EVAL, CHUNK, B, LR = 60, 6, 5, 3, 32, 5e-4


def _config(exp_cls, audio_cls):
    cfg = exp_cls(dataset="SoundSpaces")
    cfg.audio_model = audio_cls(dataset="SoundSpaces", max_len=T,
                                n_freq_stft=257, w_field=32,
                                use_grid=False).resolve()
    cfg.audio_data.batch_size = B
    cfg.optimizers.audio_fields.warmup_steps = 0
    cfg.optimizers.audio_fields.lr = LR
    return cfg


@pytest.fixture(scope="module")
def engines():
    jcfg = _config(JExperimentConfig, JAudioModelConfig)
    train, jtrain = synth_scene(N_TRAIN, max_len=T), jsynth_scene(N_TRAIN, max_len=T)
    jeng = JAudioEngine(config=jcfg, model=JAudioModel(config=jcfg.audio_model),
                        aabb=jnp.asarray(jtrain.outputs.aabb, jnp.float32))
    jeng.optimizer = _recording(jeng.optimizer)
    state = jeng.init_state(seed=3)
    cfg = _config(ExperimentConfig, AudioModelConfig)
    eng = AudioEngine(cfg, AudioModel(cfg.audio_model), train.outputs.aabb,
                      device="cpu")
    load_state_dict(eng.model.field, field_state_dict(state.params))
    return {"jax": jeng, "state": state, "port": eng, "train": train,
            "jtrain": jtrain}


def _fresh(state):
    """A copy of a JAX state (the JAX step donates its input's buffers)."""
    return jax.tree_util.tree_map(lambda x: x.copy(), state)


def _params(eng):
    return {k: v.detach().numpy().copy()
            for k, v in eng.model.field.named_parameters()}


def test_train_step_matches_jax(engines):
    jeng, eng, state = engines["jax"], engines["port"], _fresh(engines["state"])
    load_state_dict(eng.model.field, field_state_dict(state.params))
    before = _params(eng)
    _, sample_key = jax.random.split(state.rng)
    idx = np.array(jax.random.randint(sample_key, (B,), 0, N_TRAIN * T))
    jarrays = engines["jtrain"].slice_arrays()
    batch = jgather_audio_batch(jarrays, jnp.asarray(idx // T), jnp.asarray(idx % T))
    eager = jax.grad(lambda p: sum(jeng.model.loss(
        jeng.model.apply(p, batch, jeng.aabb), batch["data"]).values()))(
            state.params)
    eager = {k: v.numpy() for k, v in field_state_dict(eager).items()}
    new, jm = jeng.train_step(state, jarrays)
    pm = eng.train_step(engines["train"].slice_arrays("cpu"),
                        indices=(idx // T, idx % T))
    assert eng.step == 1 and int(new.step) == 1
    assert set(pm) == set(jm) == {"audio_sc_loss", "audio_mag_loss", "total_loss"}
    for k in jm:
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    jstep_grad = {k: v.numpy() for k, v in field_state_dict(new.opt_state[2]).items()}
    jafter = {k: v.numpy() for k, v in field_state_dict(new.params).items()}
    after = _params(eng)
    assert set(eager) == set(after)
    for k, p in eng.model.field.named_parameters():
        g = p.grad.numpy()
        np.testing.assert_allclose(g, eager[k], rtol=0,
                                   atol=1e-4 * np.abs(eager[k]).max(), err_msg=k)
        moved = after[k] - before[k]
        live = np.abs(g) > 1e-10
        np.testing.assert_allclose(np.abs(moved[live]), LR, rtol=1e-4, err_msg=k)
        assert not moved[g == 0].any(), k
        jg = jstep_grad[k]
        sure = np.abs(jg) > 5e-2 * np.abs(jg).max()
        np.testing.assert_allclose(after[k][sure], jafter[k][sure], rtol=1e-6,
                                   atol=1e-8, err_msg=k)


def test_train_step_draws_from_its_generator(engines):
    """Without indices a step draws its batch from the engine's generator:
    two engines from one seed take the same steps, and each step's draw
    differs from the last."""
    cfg = _config(ExperimentConfig, AudioModelConfig)
    cfg.seed = 7
    arrays = engines["train"].slice_arrays("cpu")
    a, b = (AudioEngine(cfg, AudioModel(cfg.audio_model),
                        engines["train"].outputs.aabb, device="cpu")
            for _ in range(2))
    losses = [[float(e.train_step(arrays)["total_loss"]) for _ in range(3)]
              for e in (a, b)]
    assert losses[0] == losses[1] and len(set(losses[0])) == 3
    for (k, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), k
    assert a.optimizers["audio_fields"].count == 3 and a.step == 3


def test_evaluate_matches_jax(engines):
    jeng, eng, state = engines["jax"], engines["port"], _fresh(engines["state"])
    load_state_dict(eng.model.field, field_state_dict(state.params))
    ds, jds = synth_scene(N_EVAL, max_len=T, seed=1), jsynth_scene(
        N_EVAL, max_len=T, seed=1)
    key = jax.random.PRNGKey(8)
    ang = _jax_angles(key, (CHUNK, *ds.log_stft.shape[1:]))
    ref = jeng.evaluate(state, jds, key=key, chunk=CHUNK)
    out = eng.evaluate(ds, chunk=CHUNK, init_angles=ang)
    assert set(out) == set(ref)
    assert out["audio_total_invalids_T60"] == ref["audio_total_invalids_T60"]
    for k, v in ref.items():
        if k.startswith(("fps", "num_rays")):
            assert out[k] > 0
        elif k.startswith(("audio_C50", "quick_")):
            np.testing.assert_allclose(out[k], v, rtol=1e-3, err_msg=k)
        elif k.startswith(("audio_T60", "audio_EDT")):
            np.testing.assert_allclose(out[k], v, rtol=1e-2, err_msg=k)
