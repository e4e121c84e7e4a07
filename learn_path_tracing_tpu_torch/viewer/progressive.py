"""Progressive accumulation renderer with movement-aware restart.

Counterpart of ``learn_path_tracing_tpu.viewer.progressive`` (the legacy
``render(moved)`` loop, 15_module.py:1022-1036): an accumulator image plus
an spp counter that reset when the camera moves and keep integrating
otherwise; the display frame is ``(acc / spp) ** (1/2.2)`` (plain gamma,
no ACES). ``state()``/``restore()`` expose the complete resume state (the
accumulator and the counters: the RNG is counter-based).

Two engines, with the same RNG counters (absolute pixel, sample and
bounce), so switching engines never changes the converged image: the hybrid
integrator (``integrator.hybrid``; 'auto' takes it for legacy scenes on
every device) and the masked wavefront
(``integrator.wavefront.render_accumulate``; 'auto' takes it for sphere
scenes, which the hybrid integrator does not render, as the JAX package
does). The wavefront engine passes ``hit_backend`` to the sphere world's
``hit`` ('bvh': the sphere BVH through K3); for legacy scenes it runs one
``hit_legacy`` per bounce pass, so it reaches the world's packet-traversal
kernel too.
"""

from __future__ import annotations

import numpy as np
import torch

from ..camera.camera import Camera


class ProgressiveRenderer:
    def __init__(self, world_data, camera: Camera, resolution,
                 spp_per_frame: int = 32, limit: int = 32, seed: int = 0,
                 bsdf: str = "legacy", scene: str = "legacy",
                 camera_model: str = "thinlens", hit_backend: str = "auto",
                 preview_spp: int = 0, preview_limit: int = 2, engine: str = "auto"):
        """``preview_spp > 0`` enables motion preview: while the camera is
        moving, frames render at ``preview_spp`` samples and
        ``preview_limit`` bounces; the first still frame discards the
        preview and restarts clean accumulation at full quality.

        ``engine``: 'hybrid' renders with ``integrator.hybrid.render_hybrid``
        (legacy scenes only; it takes ``hit_backend`` and reads none),
        'wavefront' with ``integrator.wavefront.render_accumulate``, and
        'auto' with the hybrid integrator for legacy scenes and the
        wavefront otherwise."""
        if engine not in ("auto", "hybrid", "wavefront"):
            raise ValueError(f"unknown engine: {engine!r}")
        self.world_data = world_data
        self.camera = camera
        self.resolution = (int(resolution[0]), int(resolution[1]))
        self.spp_per_frame = int(spp_per_frame)
        self.limit = int(limit)
        self.seed = int(seed)
        self.bsdf = bsdf
        self.scene = scene
        self.camera_model = camera_model
        self.hit_backend = hit_backend
        self.preview_spp = int(preview_spp)
        self.preview_limit = int(preview_limit)
        if engine == "auto":
            engine = "hybrid" if scene == "legacy" else "wavefront"
        self.engine = engine
        self.device = world_data.device
        w, h = self.resolution
        self.acc = torch.zeros((w * h, 3), dtype=torch.float32, device=self.device)
        self.spp = 0
        self._preview_only = False
        # the last batch's segments and spp (and render_hybrid's stats)
        self.last_stats = None

    def _accumulate(self, acc, sample_start, spp, limit):
        """``acc`` plus ``spp`` more samples' radiance sums."""
        cam = self.camera.params(self.device)
        if self.engine == "wavefront":
            from ..integrator.wavefront import render_accumulate

            acc, segments = render_accumulate(
                self.world_data, cam, acc, sample_start, self.resolution, spp,
                limit=limit, seed=self.seed, bsdf=self.bsdf,
                camera_model=self.camera_model, scene=self.scene,
                hit_backend=self.hit_backend)
            self.last_stats = {"segments": segments, "spp": spp}
            return acc
        from ..integrator.hybrid import render_hybrid

        img, segments, st = render_hybrid(
            self.world_data, cam, self.resolution,
            spp=spp, limit=limit, seed=self.seed, bsdf=self.bsdf,
            camera_model=self.camera_model, scene=self.scene,
            hit_backend=self.hit_backend, sample_base=sample_start, stats=True)
        self.last_stats = dict(st, segments=segments, spp=spp)
        w, h = self.resolution
        return acc + img.reshape(w * h, 3) * float(spp)

    def render(self, moved: bool = True):
        """Add one batch of samples; reset the accumulator if the camera
        moved. Returns the current display frame ``f32[W,H,3]``."""
        w, h = self.resolution
        zeros = torch.zeros((w * h, 3), dtype=torch.float32, device=self.device)
        if moved and self.preview_spp:
            self.acc = self._accumulate(zeros, 0, self.preview_spp, self.preview_limit)
            self.spp = self.preview_spp
            self._preview_only = True
            return self.frame()
        if moved or self._preview_only:
            self.acc = zeros
            self.spp = 0
            self._preview_only = False
        self.acc = self._accumulate(self.acc, self.spp, self.spp_per_frame, self.limit)
        self.spp += self.spp_per_frame
        return self.frame()

    def frame(self):
        w, h = self.resolution
        img = torch.clamp_min(self.acc / max(float(self.spp), 1.0), 0.0) ** (1.0 / 2.2)
        return img.reshape(w, h, 3)

    # ------------------------------------------------- resume checkpoint --
    def state(self) -> dict:
        """Serializable render-resume state (accumulator + counters)."""
        return {
            "acc": self.acc.cpu().numpy(),
            "spp": self.spp,
            "seed": self.seed,
            "resolution": self.resolution,
        }

    def restore(self, state: dict) -> None:
        if tuple(state["resolution"]) != self.resolution:
            raise ValueError("resolution mismatch")
        self.acc = torch.as_tensor(np.asarray(state["acc"], np.float32),
                                   device=self.device).clone()
        self.spp = int(state["spp"])
        self.seed = int(state["seed"])
