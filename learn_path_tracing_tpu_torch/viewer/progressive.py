"""Progressive accumulation renderer with movement-aware restart.

Counterpart of ``learn_path_tracing_tpu.viewer.progressive`` (the legacy
``render(moved)`` loop, 15_module.py:1022-1036): an accumulator image plus
an spp counter that reset when the camera moves and keep integrating
otherwise; the display frame is ``(acc / spp) ** (1/2.2)`` (plain gamma,
no ACES). ``state()``/``restore()`` expose the complete resume state (the
accumulator and the counters: the RNG is counter-based).

Every frame renders with the hybrid integrator (``integrator.hybrid``), on
every device. ``engine='wavefront'`` needs ``render_accumulate``, which is
not ported yet, and raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ..camera.camera import Camera


class ProgressiveRenderer:
    def __init__(self, world_data, camera: Camera, resolution,
                 spp_per_frame: int = 32, limit: int = 32, seed: int = 0,
                 bsdf: str = "legacy", scene: str = "legacy",
                 camera_model: str = "thinlens", preview_spp: int = 0,
                 preview_limit: int = 2, engine: str = "auto"):
        """``preview_spp > 0`` enables motion preview: while the camera is
        moving, frames render at ``preview_spp`` samples and
        ``preview_limit`` bounces; the first still frame discards the
        preview and restarts clean accumulation at full quality.

        ``engine``: 'auto' and 'hybrid' render with
        ``integrator.hybrid.render_hybrid``; 'wavefront' raises until
        ``render_accumulate`` is ported."""
        if engine == "wavefront":
            raise NotImplementedError(
                "engine 'wavefront' needs render_accumulate, not ported yet")
        if engine not in ("auto", "hybrid"):
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
        self.preview_spp = int(preview_spp)
        self.preview_limit = int(preview_limit)
        self.engine = "hybrid"
        self.device = world_data.device
        w, h = self.resolution
        self.acc = torch.zeros((w * h, 3), dtype=torch.float32, device=self.device)
        self.spp = 0
        self._preview_only = False
        self.last_stats = None   # render_hybrid's stats of the last batch

    def _accumulate(self, acc, sample_start, spp, limit):
        """``acc`` plus ``spp`` more samples' radiance sums."""
        from ..integrator.hybrid import render_hybrid

        img, segments, st = render_hybrid(
            self.world_data, self.camera.params(self.device), self.resolution,
            spp=spp, limit=limit, seed=self.seed, bsdf=self.bsdf,
            camera_model=self.camera_model, scene=self.scene,
            sample_base=sample_start, stats=True)
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
