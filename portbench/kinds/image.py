"""Traffic of kind "image": VisionPipeline.render_image in the closed loop of
portbench/core/serve.py, one `height` x `width` view a request from a
camera drawn from the seed (position uniform in +-position_box, yaw
uniform, pitch within +-pitch_deg). The pipeline is built from the
configuration (portbench/core/program.py) and holds weights made on the
device from the seed."""

from __future__ import annotations

from portbench.core import inputs, program, serve
from portbench.core.common import Run
from portbench.core.yardstick import (
    hash_fwd_bound_ms,
    pe_dims,
    pe_mlp_bound_ms,
    vision_fwd_flops,
)
from portbench.reference import neraf as ref

# a pixel's colour is held by how far it lies off the reference's, in
# steps of an 8-bit image (share_of_pixels off by more than this)
RGB_STEP = 1.0 / 255.0


class ImageServer:
    parts = ("vision",)

    def __init__(self, run: Run):
        spec, dev, tr = run.spec, run.device, run.traffic
        self.run, self.spec = run, spec
        self.H, self.W = tr["height"], tr["width"]
        self.weights = inputs.make_weights(ref.param_shapes(spec, self.parts), run.seed, dev)
        self.cams = inputs.cameras(tr["camera_pool"], inputs.generator(dev, run.seed, "cameras"),
                                   tr["position_box"], tr["pitch_deg"], tr["focal"],
                                   self.H, self.W)
        if run.control:
            self.pipe = None
            return
        pipe = program.vision_pipeline(spec, dev)
        inputs.load_weights(pipe.vision_model, self.weights, "vision_model.")
        self.pipe = pipe

    def request(self, i: int):
        k = i % self.cams["c2w"].shape[0]
        cam = {n: t[k:k + 1] for n, t in self.cams.items()}
        if self.pipe is None:
            return cam, None
        return cam, self.pipe.render_image(cam, 0, self.H, self.W)

    def reference(self, cam, precision):
        return ref.render_image(self.weights, self.spec["vision"], cam, self.H, self.W,
                                precision)

    @staticmethod
    def answer(reference_out):
        return reference_out

    def gaps(self, got, want) -> dict:
        """depth_gap: the share of pixels whose median depth differs by more
        than 1%; rgb_med, acc_med: the median over pixels of the absolute
        gap of the colour (its worst channel) and of the accumulation;
        rgb_share: the share of pixels whose colour is off by more than
        one step of an 8-bit image; rgb_gap, acc_gap: root-mean-square gaps
        over the image."""
        d_rgb = (got["rgb"].float() - want["rgb"]).abs().amax(-1)
        d_acc = (got["accumulation"].float() - want["accumulation"]).abs()
        d = (got["depth"].float() - want["depth"]).abs() > 1e-2 * want["depth"].abs()
        rms = lambda k: float(((got[k].float() - want[k]) ** 2).mean().sqrt())
        return {"depth_gap": float(d.float().mean()),
                "rgb_med": float(d_rgb.median()), "acc_med": float(d_acc.median()),
                "rgb_share": float((d_rgb > RGB_STEP).float().mean()),
                "rgb_gap": rms("rgb"), "acc_gap": rms("accumulation")}

    def work(self) -> dict:
        """An image: the proposal fields on every ray's proposal samples and
        the main field on its samples; the PE+MLP kernels' forward calls
        (both proposals, and the main field where it is fourier) and the
        hash encoding's forward on the main field's samples."""
        v, rays = self.spec["vision"], self.H * self.W
        n0, n1 = v["num_proposal_samples"]
        F_p = v["proposal"]["num_frequencies"]
        calls = [(pe_dims(v, "proposal"), F_p, rays * n0, False, False),
                 (pe_dims(v, "proposal"), F_p, rays * n1, False, False)]
        points = rays * v["num_nerf_samples"]
        work = {"flops": vision_fwd_flops(v, rays), "pixels": rays}
        if v["encoding"] == "fourier":
            calls.append((pe_dims(v, "main"), v["num_frequencies"], points, False, False))
        else:
            work["hash_bound_ms"] = hash_fwd_bound_ms(v, points)
        work["pe_mlp_bound_ms"] = pe_mlp_bound_ms(calls)
        return work


def drive(run: Run):
    return serve.drive(run, ImageServer(run))
