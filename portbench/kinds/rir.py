"""Traffic of kind "rir": RenderPipeline.render_waveforms in the closed loop
of portbench/core/serve.py, `rirs_per_request` poses a request (mic and
source uniform in the audio AABB, one of the azimuths), Griffin-Lim's
phases from a generator seeded for the request. The pipeline is built from
the configuration (portbench/core/program.py) and holds weights and a
scene grid made on the device from the seed."""

from __future__ import annotations

import numpy as np
import torch

from portbench.core import inputs, program, serve
from portbench.core.common import Run
from portbench.core.yardstick import conv_flops, field_flops, gl_bound_ms
from portbench.reference import neraf as ref


class RirServer:
    parts = ("resnet", "field")

    def __init__(self, run: Run):
        spec, dev, a = run.spec, run.device, run.spec["audio"]
        self.run, self.spec, self.n = run, spec, run.traffic["rirs_per_request"]
        self.weights = inputs.make_weights(ref.param_shapes(spec, self.parts), run.seed, dev)
        self.grid = inputs.grid(a["grid_res"], run.seed, dev)
        self.gen = torch.Generator(device=dev)
        self.gl_gen = torch.Generator(device=dev)
        self.aabb = torch.tensor(a["aabb"], dtype=torch.float32, device=dev)
        if run.control:
            self.pipe = None
            return
        pipe = program.render_pipeline(spec, self.grid.clone(), dev)
        inputs.load_weights(pipe.resnet, self.weights, "resnet.")
        inputs.load_weights(pipe.audio_model, self.weights, "audio_model.")
        self.pipe = pipe

    def request(self, i: int):
        """-> (its inputs, the program's answer)."""
        self.gen.manual_seed(inputs.key(self.run.seed, "request", i))
        mic, src, rot = inputs.poses(self.n, self.gen, self.spec["audio"]["aabb"],
                                     self.run.traffic["azimuths_deg"])
        seed = inputs.key(self.run.seed, "gl", i)
        if self.pipe is None:
            return (mic, src, rot, seed), None
        self.gl_gen.manual_seed(seed)
        return (mic, src, rot, seed), self.pipe.render_waveforms(mic, src, rot,
                                                                 generator=self.gl_gen)

    def reference(self, inp, precision):
        """-> (waveforms, magnitudes)."""
        mic, src, rot, seed = inp
        a = self.spec["audio"]
        g = torch.Generator(device=mic.device).manual_seed(seed)
        shape = (mic.shape[0], a["mic_ch"], a["n_freq_stft"], a["max_len"])
        phase = torch.rand(shape, generator=g, device=mic.device) * (2 * np.pi)
        angles = torch.polar(torch.ones_like(phase), phase)
        stats = {k: v for k, v in self.weights.items() if k.endswith(("running_mean", "running_var"))}
        R = a["grid_res"]
        return ref.render_waveforms(self.weights, stats, a, self.grid.reshape(1, R, R, R, 7),
                                    mic, src, rot, self.aabb, angles, precision)

    @staticmethod
    def answer(reference_out):
        """The reference's output as the program answers: the waveforms."""
        return reference_out[0]

    def gaps(self, got, want) -> dict:
        """Per RIR, then the mean over the request's RIRs: spec_gap, the
        relative L2 gap of the waveform's STFT magnitude; edc_db, the mean
        absolute gap of its Schroeder decay curve in dB, down to -60 dB;
        wave_gap, the waveform's relative L2 gap (not held to a limit:
        Griffin-Lim turns a rounding of the magnitudes into a large one)."""
        a = self.spec["audio"]
        wave = want[0]
        got = got.float()
        rel = lambda x, y: (x - y).flatten(1).norm(dim=1) / y.flatten(1).norm(dim=1).clamp_min(1e-30)

        def edc(w):
            tail = (w ** 2).sum(1).flip(-1).cumsum(-1).flip(-1)
            return 10 * torch.log10(tail / tail[:, :1].clamp_min(1e-30) + 1e-20)

        d_got, d_want = edc(got), edc(wave)
        live = d_want > -60
        decay = ((d_got - d_want).abs() * live).sum(-1) / live.sum(-1)
        spec = rel(ref.stft(a, got).abs(), ref.stft(a, wave).abs())
        return {"spec_gap": float(spec.mean()), "edc_db": float(decay.mean()),
                "wave_gap": float(rel(got, wave).mean())}

    def work(self) -> dict:
        """A request: the eval ResNet over the grid and the field over every
        STFT frame of every RIR (Griffin-Lim's FFTs are counted in its own
        bound, on every channel of every RIR)."""
        a = self.spec["audio"]
        return {"flops": conv_flops(a, a["grid_res"])[0] + field_flops(a, self.n * a["max_len"]),
                "rirs": self.n,
                "gl_bound_ms": gl_bound_ms(self.n * a["mic_ch"], a["n_fft"], a["max_len"])}


def drive(run: Run):
    return serve.drive(run, RirServer(run))
