"""Render configuration (the reference's module-level constants, as data).

Counterpart of ``learn_path_tracing_tpu.utils.config`` for the modern stages
1-10 and the legacy stages 11-15: resolution / spp / propagate_limit / seed
plus the integrator options and the torch device. The port reads no
environment variables, so what the JAX package takes from them is data
here: ``packet_version`` is its ``LPT_PACKET_VERSION``
(``learn_path_tracing_tpu/ops/packet_traverse.py:48-50``), the mesh
traversal kernel (2: K2, one ray per thread; 1: K5a, the v1 packet walk
per warp; 3: K5b, the tile-ranged walk per block). Its ``LPT_PACKET_BLOCK``
(the TPU's rays per packet) has no counterpart: the packet sizes are fixed
by the warp (32 rays, K5a) and the block (256 rays, K5b).

``device`` defaults to ``"cuda"``: a render that does not ask for the CPU
runs on the card or fails (``stages.common.require_device``).
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, replace


@dataclass(frozen=True)
class RenderConfig:
    width: int = 1280
    height: int = 720
    spp: int = 128
    propagate_limit: int = 32
    seed: int = 0
    bsdf: str = "modern"          # diffuse | modern | legacy
    scene: str = "spheres"        # spheres | legacy
    camera_model: str = "thinlens"
    hit_backend: str = "auto"     # auto | cuda | xla | bvh
    out: str | None = None        # output path override (stages/CLI)
    device: str = "cuda"          # torch device the render runs on
    packet_version: int = 2       # mesh traversal kernel (LPT_PACKET_VERSION)

    @property
    def resolution(self):
        return (self.width, self.height)

    @property
    def limit(self):
        return self.propagate_limit

    def with_(self, **kw) -> "RenderConfig":
        return replace(self, **kw)

    def to_dict(self) -> dict:
        return asdict(self)


# Stage presets (file:line cites in stages/*.py of the JAX package). Keys:
# modern stages 1-10, legacy stages "l11".."l15".
# The legacy presets keep packet_version 2, the JAX package's default
# LPT_PACKET_VERSION; l14's --packet-version picks 1 or 3 (its
# LPT_PACKET_BLOCK has no counterpart here: packets are a warp or a block).
STAGE_CONFIGS = {
    1: RenderConfig(width=256, height=256, spp=1),
    2: RenderConfig(spp=1),
    3: RenderConfig(spp=1),
    4: RenderConfig(spp=1),
    5: RenderConfig(spp=100),
    6: RenderConfig(spp=8192, bsdf="diffuse"),
    7: RenderConfig(spp=8192),
    8: RenderConfig(spp=8192),
    9: RenderConfig(spp=8192),
    10: RenderConfig(spp=8192),
    "l11": RenderConfig(width=640, height=360, spp=128, propagate_limit=10,
                        bsdf="legacy", hit_backend="auto"),
    "l12": RenderConfig(width=640, height=360, spp=128, propagate_limit=10,
                        bsdf="legacy"),
    "l13": RenderConfig(spp=128, bsdf="legacy"),
    "l14": RenderConfig(width=1500, height=1000, spp=32, bsdf="legacy",
                        scene="legacy"),
    "l15": RenderConfig(width=1500, height=1000, spp=32, bsdf="legacy",
                        scene="legacy"),
}
