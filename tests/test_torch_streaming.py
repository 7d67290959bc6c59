"""The port's streaming audio path (data/streaming.py, the streamed form of
data/loader.py::resolve_audio_batch, and the joint and audio-only steps on
a streamed batch) against the JAX package's, on the CPU.

Every case of tests/test_streaming.py has its twin here:
- the streamed structure resolves to the resident gather's batch, exactly;
- for one seed the port's sampler yields the JAX sampler's
  (audio_idx, time_query) sequence and, at float32, its columns bitwise
  (both draw with np.random.default_rng and gather in the same order);
  at bfloat16 the columns are the JAX sampler's ml_dtypes values bitwise
  (both round to nearest even) and within 2^-8 relative of the store;
- the three store layouts give identical batches, and the port's
  write_time_major_store writes the JAX package's bytes;
- should_stream's thresholds;
- an apartment_1-scale split (111,513 recordings x 2 x 257 x 101, 23 GB)
  from a lazily backed time-major store (layout="tcf", so nothing is
  transposed), with batches of 2,048 and no split-sized allocation;
- KeyError on an input with neither structure; ValueError on float16;
- the audio engine trains on streamed batches.
And the steps: a tiny joint step and an audio-only step on a streamed
batch equal, bitwise, the resident steps at the same (rec, t), and a step
on a streamed batch draws from the generator as the resident step does.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from neraf_tpu.data.loader import resolve_audio_batch as jresolve_audio_batch
from neraf_tpu.data.streaming import StreamingAudioSampler as JSampler
from neraf_tpu.data.streaming import write_time_major_store as jwrite_store
from neraf_tpu_torch.data.loader import (
    audio_arrays,
    gather_audio_batch,
    resolve_audio_batch,
    sample_audio_indices,
)
from neraf_tpu_torch.data.streaming import (
    StreamingAudioSampler,
    should_stream,
    split_device_bytes,
    write_time_major_store,
)

BF16_REL = 2.0 ** -8  # bf16 keeps 8 significand bits


@dataclasses.dataclass
class _Outputs:
    microphone_poses: np.ndarray
    source_poses: np.ndarray
    rotations: np.ndarray
    audio_filenames: list
    aabb: np.ndarray


@dataclasses.dataclass
class _Dataset:
    log_stft: np.ndarray
    outputs: _Outputs
    max_len: int
    waveforms: np.ndarray | None = None


def _outputs(rng, n):
    return _Outputs(
        microphone_poses=rng.uniform(-1, 1, (n, 3)).astype(np.float32),
        source_poses=rng.uniform(-1, 1, (n, 3)).astype(np.float32),
        rotations=rng.uniform(0, 1, (n, 3)).astype(np.float32),
        audio_filenames=[str(i) for i in range(n)],
        aabb=np.array([[-1.0] * 3, [1.0] * 3], np.float32))


def _make_dataset(rng, n=12, C=2, F=9, T=7):
    return _Dataset(log_stft=rng.standard_normal((n, C, F, T)).astype(np.float32),
                    outputs=_outputs(rng, n), max_len=T)


def _arrays(ds):
    o = ds.outputs
    return audio_arrays({"mic_pose": o.microphone_poses,
                         "source_pose": o.source_poses, "rot": o.rotations,
                         "log_stft": ds.log_stft}, "cpu")


def _draw(sampler_cls, ds, n, **kwargs):
    """n batches of a sampler as numpy dicts (rec, t, data)."""
    out = []
    with sampler_cls(ds, **kwargs) as s:
        for _ in range(n):
            b = s.next()
            out.append({k: np.asarray(b[k]) for k in
                        ("audio_idx", "time_query", "data")})
    return out


def test_streamed_batch_matches_the_resident_gather(rng):
    """The streamed structure resolves to exactly the resident batch, and
    to the JAX package's resolve of the same input."""
    ds = _make_dataset(rng)
    arrays = _arrays(ds)
    rec = np.array([0, 3, 3, 11, 7])
    t = np.array([6, 0, 2, 1, 5])
    resident = gather_audio_batch(arrays, torch.from_numpy(rec),
                                  torch.from_numpy(t))
    streamed_in = {k: arrays[k] for k in ("mic_pose", "source_pose", "rot")}
    streamed_in.update(audio_idx=torch.from_numpy(rec),
                       time_query=torch.from_numpy(t),
                       data=torch.from_numpy(ds.log_stft[rec, :, :, t]))
    # the indices given beside a streamed batch are not used
    resolved = resolve_audio_batch(streamed_in, torch.zeros(5, dtype=torch.long),
                                   torch.zeros(5, dtype=torch.long))
    jin = {k: jnp.asarray(v.numpy()) for k, v in streamed_in.items()}
    jresolved = jresolve_audio_batch(jax.random.PRNGKey(0), jin, 5, ds.max_len)
    assert set(resolved) == set(resident) == set(jresolved)
    for k in resident:
        assert torch.equal(resolved[k], resident[k]), k
        np.testing.assert_array_equal(resolved[k].numpy(),
                                      np.asarray(jresolved[k]), err_msg=k)
    assert resolved["data"].dtype == torch.float32


def test_sampler_draws_the_jax_samplers_batches(rng):
    """Same seed: the JAX sampler's (audio_idx, time_query) and columns,
    bitwise, every batch valid against the store; successive draws differ."""
    ds = _make_dataset(rng)
    ours = _draw(StreamingAudioSampler, ds, 6, batch_size=8, seed=1,
                 device="cpu")
    theirs = _draw(JSampler, ds, 6, batch_size=8, seed=1)
    for b, j in zip(ours, theirs):
        assert b["data"].shape == (8, 2, 9) and b["data"].dtype == np.float32
        for k in b:
            np.testing.assert_array_equal(b[k], j[k], err_msg=k)
        rec, t = b["audio_idx"], b["time_query"]
        assert rec.min() >= 0 and rec.max() < 12
        assert t.min() >= 0 and t.max() < ds.max_len
        np.testing.assert_array_equal(b["data"], ds.log_stft[rec, :, :, t])
    assert any(not np.array_equal(ours[0]["audio_idx"], b["audio_idx"])
               for b in ours[1:])


def test_sampler_batch_holds_the_pose_tables(rng):
    ds = _make_dataset(rng)
    with StreamingAudioSampler(ds, batch_size=4, seed=0, device="cpu") as s:
        b = s.next()
    assert set(b) == {"data", "audio_idx", "time_query", "mic_pose",
                      "source_pose", "rot"}
    assert b["audio_idx"].dtype == torch.int64
    np.testing.assert_array_equal(b["mic_pose"].numpy(),
                                  ds.outputs.microphone_poses)
    np.testing.assert_array_equal(b["rot"].numpy(), ds.outputs.rotations)


def test_audio_engine_trains_on_streamed_batches(rng):
    from neraf_tpu_torch.configs.config import AudioModelConfig, ExperimentConfig
    from neraf_tpu_torch.engine.audio_engine import AudioEngine
    from neraf_tpu_torch.models.audio import AudioModel

    ds = _make_dataset(rng, n=10, C=2, F=9, T=7)
    cfg = ExperimentConfig(dataset="SoundSpaces")
    cfg.audio_model = AudioModelConfig(
        dataset="SoundSpaces", max_len=7, n_freq_stft=9, w_field=16,
        use_grid=False).resolve()
    cfg.audio_data.batch_size = 16
    cfg.audio_data.max_len = 7
    engine = AudioEngine(cfg, AudioModel(cfg.audio_model), ds.outputs.aabb,
                         device="cpu")
    with StreamingAudioSampler(ds, batch_size=16, seed=2, device="cpu") as s:
        losses = [float(engine.train_step(s.next())["total_loss"])
                  for _ in range(5)]
    assert all(np.isfinite(v) for v in losses)
    # the same engine also takes the resident structure
    assert np.isfinite(float(engine.train_step(_arrays(ds))["total_loss"]))


def test_should_stream_auto_thresholds(rng):
    ds = _make_dataset(rng)

    class Cfg:
        streaming = "auto"
        stream_threshold_gb = 1e-9  # the tiny split exceeds it

    assert split_device_bytes(ds.log_stft) == ds.log_stft.nbytes
    assert should_stream(Cfg(), ds)
    Cfg.stream_threshold_gb = 8.0
    assert not should_stream(Cfg(), ds)
    Cfg.streaming = "on"
    assert should_stream(Cfg(), ds)
    Cfg.streaming = "off"
    Cfg.stream_threshold_gb = 1e-9
    assert not should_stream(Cfg(), ds)


def test_apartment1_scale_split_streams_from_a_time_major_store():
    """apartment_1's train-split shapes (23 GB of log-STFT) from a lazily
    backed time-major store: np.zeros commits no page until written, and
    layout="tcf" takes it as it is, so only the gathered columns are read.
    The batches equal the JAX sampler's on the same store, the two marked
    columns read back, and a batch is MBs, not the split's GBs."""
    N, C, F, T = 111_513, 2, 257, 101
    store = np.zeros((N, T, C, F), np.float32)
    store[0, 0] = 1.5
    store[N - 1, T - 1] = -2.5
    ds = _Dataset(log_stft=store, outputs=_outputs(np.random.default_rng(3), N),
                  max_len=T)
    assert split_device_bytes(ds.log_stft) > 20 * 2**30  # the point
    kwargs = dict(batch_size=2048, seed=4, layout="tcf", prefetch=1,
                  inflight=1)
    ours = _draw(StreamingAudioSampler, ds, 3, device="cpu", **kwargs)
    theirs = _draw(JSampler, ds, 3, **kwargs)
    for b, j in zip(ours, theirs):
        assert b["data"].shape == (2048, C, F)
        for k in b:
            np.testing.assert_array_equal(b[k], j[k], err_msg=k)
        rec, t = b["audio_idx"], b["time_query"]
        np.testing.assert_array_equal(b["data"], store[rec, t])
        batch_bytes = sum(v.nbytes for v in b.values())
        assert batch_bytes < 32 * 2**20


def test_resolve_audio_batch_rejects_neither_structure():
    with pytest.raises(KeyError):
        resolve_audio_batch({"bogus": torch.zeros(3)}, torch.zeros(4),
                            torch.zeros(4))


def test_bf16_transfer_rounds_as_the_jax_sampler(rng):
    """transfer_dtype="bfloat16": the batch is bf16, the JAX sampler's
    ml_dtypes values bitwise, within 2^-8 relative of the store, and
    resolve_audio_batch upcasts it to float32; float16 raises."""
    ds = _make_dataset(rng)
    with StreamingAudioSampler(ds, batch_size=8, seed=3,
                               transfer_dtype="bfloat16", device="cpu") as s:
        batch_in = s.next()
    with JSampler(ds, batch_size=8, seed=3, transfer_dtype="bfloat16") as s:
        jbatch = s.next()
    assert batch_in["data"].dtype == torch.bfloat16
    assert np.asarray(jbatch["data"]).dtype == ml_dtypes.bfloat16
    ours = batch_in["data"].view(torch.int16).numpy()
    np.testing.assert_array_equal(ours, np.asarray(jbatch["data"]).view(np.int16))
    resolved = resolve_audio_batch(batch_in, None, None)
    assert resolved["data"].dtype == torch.float32
    rec, t = batch_in["audio_idx"].numpy(), batch_in["time_query"].numpy()
    exact = ds.log_stft[rec, :, :, t]
    np.testing.assert_allclose(resolved["data"].numpy(), exact, rtol=BF16_REL,
                               atol=BF16_REL)
    with pytest.raises(ValueError, match="transfer_dtype"):
        StreamingAudioSampler(ds, batch_size=8, transfer_dtype="float16",
                              device="cpu")


def test_time_major_layouts_gather_identically(rng, tmp_path):
    """The auto-transposed store, time_major=False and a
    write_time_major_store memmap draw identical batches for one seed; the
    port's store file is the JAX package's, byte for byte."""
    ds = _make_dataset(rng)
    tm_store = write_time_major_store(ds.log_stft, tmp_path / "tm.npy")
    jwrite_store(ds.log_stft, tmp_path / "jtm.npy")
    assert tm_store.shape == (12, 7, 2, 9)
    assert (tmp_path / "tm.npy").read_bytes() == (tmp_path / "jtm.npy").read_bytes()
    np.testing.assert_array_equal(np.asarray(tm_store),
                                  ds.log_stft.transpose(0, 3, 1, 2))
    ds_tm = dataclasses.replace(ds, log_stft=tm_store)
    draws = {name: _draw(StreamingAudioSampler, d, 3, batch_size=16, seed=7,
                         device="cpu", **kwargs)
             for name, kwargs, d in (("auto_tm", {}, ds),
                                     ("no_tm", {"time_major": False}, ds),
                                     ("disk_tm", {"layout": "tcf"}, ds_tm))}
    for other in ("no_tm", "disk_tm"):
        for b_ref, b in zip(draws["auto_tm"], draws[other]):
            for k in b_ref:
                np.testing.assert_array_equal(b_ref[k], b[k], err_msg=k)
    for b in draws["disk_tm"]:
        np.testing.assert_array_equal(
            b["data"], ds.log_stft[b["audio_idx"], :, :, b["time_query"]])


def test_producer_error_surfaces_from_next(rng):
    ds = _make_dataset(rng)
    ds.log_stft = ds.log_stft[:, :, :, :2]  # max_len 7 draws t past the store
    with StreamingAudioSampler(ds, batch_size=64, seed=0, device="cpu") as s:
        with pytest.raises(RuntimeError, match="producer"):
            s.next()


# ------------------------------------------------------------------ steps
def _streamed_and_resident(split, batch_size, seed=5):
    """One streamed batch of the split and the resident arrays."""
    ds = _Dataset(log_stft=split["log_stft"], outputs=_Outputs(
        split["mic_pose"], split["source_pose"], split["rot"], [],
        np.array([[-1.0] * 3, [1.0] * 3], np.float32)),
        max_len=split["log_stft"].shape[-1])
    with StreamingAudioSampler(ds, batch_size=batch_size, seed=seed,
                               device="cpu") as s:
        streamed = s.next()
    return streamed, audio_arrays(split, "cpu")


def _split(rng, n, T):
    split = {"mic_pose": rng.uniform(-2.0, 2.0, (n, 3)),
             "source_pose": rng.uniform(-2.0, 2.0, (n, 3)),
             "rot": rng.uniform(0.0, 1.0, (n, 3)),
             "log_stft": rng.normal(-3.0, 0.5, (n, 2, 257, T))}
    return {k: v.astype(np.float32) for k, v in split.items()}


def _params(*modules):
    return [p.detach().clone() for m in modules for p in m.parameters()]


def test_streamed_joint_step_is_the_resident_step():
    """Two tiny joint pipelines from one seed, the audio branch live: the
    resident step at the streamed batch's (rec, t) and the streamed step
    give the same metrics, weights, Adam moments, grid and BatchNorm
    statistics, bitwise; a streamed step without draws takes from the
    generator what a resident one does."""
    from neraf_tpu_torch.data.vision_data import camera_arrays, synthetic_cameras
    from neraf_tpu_torch.engine.factory import NUM_CAMERAS, build_joint_pipeline

    rng = np.random.default_rng(12)
    split = _split(rng, 5, 12)
    cams = camera_arrays(synthetic_cameras(NUM_CAMERAS, 12, 10, seed=2), "cpu")
    images = {"images": torch.from_numpy(rng.uniform(
        0.0, 1.0, (NUM_CAMERAS, 12, 10, 3)).astype(np.float32))}
    pipes = [build_joint_pipeline(grid_res=8, tiny=True, device="cpu",
                                  mixed_precision=False) for _ in range(2)]
    streamed, resident = _streamed_and_resident(
        split, pipes[0].config.audio_data.batch_size)
    for p in pipes:
        p.step = pipes[0].config.trainer.start_step_audio + 1
    draws = pipes[0].draw(NUM_CAMERAS, 12, 10, 5)
    pipes[1].draw(NUM_CAMERAS, 12, 10, 5)  # the generators stay in step
    draws_res = dict(draws, rec=streamed["audio_idx"], t=streamed["time_query"])
    m_res = pipes[0].train_step(cams, resident, images, draws=draws_res)
    m_str = pipes[1].train_step(cams, streamed, images, draws=draws)
    assert m_res["audio_mag_loss"] > 0 and m_res == m_str
    for a, b in zip(_params(*pipes[0].models.values()),
                    _params(*pipes[1].models.values())):
        assert torch.equal(a, b)
    for name, opt in pipes[0].optimizers.items():
        other = pipes[1].optimizers[name].opt
        for p, q in zip(opt.params, pipes[1].optimizers[name].params):
            for k in ("exp_avg", "exp_avg_sq"):
                assert torch.equal(opt.opt.state[p][k], other.state[q][k])
    assert torch.equal(pipes[0].grid, pipes[1].grid)
    for a, b in zip(pipes[0].resnet.buffers(), pipes[1].resnet.buffers()):
        assert torch.equal(a, b)
    # drawn by the step: the generators stay in step
    pipes[0].train_step(cams, resident, images)
    pipes[1].train_step(cams, streamed, images)
    assert torch.equal(pipes[0].generator.get_state(),
                       pipes[1].generator.get_state())
    # eval_loss_dict takes a streamed batch too (its own rec, t)
    out = pipes[1].eval_loss_dict(cams, streamed, images)
    ref = pipes[1].eval_loss_dict(cams, resident, images, draws=dict(
        pipes[1].eval_draws(NUM_CAMERAS, 12, 10, 5),
        rec=streamed["audio_idx"], t=streamed["time_query"]))
    assert out == ref


def test_streamed_audio_only_step_is_the_resident_step():
    from neraf_tpu_torch.configs.config import AudioModelConfig, ExperimentConfig
    from neraf_tpu_torch.engine.audio_engine import AudioEngine
    from neraf_tpu_torch.models.audio import AudioModel

    split = _split(np.random.default_rng(4), 6, 12)
    cfg = ExperimentConfig(dataset="SoundSpaces")
    cfg.audio_model = AudioModelConfig(dataset="SoundSpaces", max_len=12,
                                       n_freq_stft=257, w_field=32,
                                       use_grid=False).resolve()
    cfg.audio_data.batch_size = 32
    engines = [AudioEngine(cfg, AudioModel(cfg.audio_model),
                           np.array([[-3.0] * 3, [3.0] * 3]), device="cpu")
               for _ in range(2)]
    streamed, resident = _streamed_and_resident(split, 32)
    m_res = engines[0].train_step(resident, indices=(streamed["audio_idx"],
                                                     streamed["time_query"]))
    m_str = engines[1].train_step(streamed)
    for k in m_res:
        assert torch.equal(m_res[k], m_str[k]), k
    for a, b in zip(_params(engines[0].model), _params(engines[1].model)):
        assert torch.equal(a, b)
    # the streamed step drew from the generator as a resident one does
    gen = torch.Generator().manual_seed(cfg.seed)
    sample_audio_indices(6, 12, 32, gen)
    assert torch.equal(engines[1].generator.get_state(), gen.get_state())
