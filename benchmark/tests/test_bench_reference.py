"""The plain reference against the port on the CPU, at a small size of each
configuration: the same image bit for bit and the same segment count."""

import pytest
import torch

from benchmark.harness import compare, registry
from benchmark.reference import integrate
from benchmark.tests import tiny


def _frame(cell_name, cfg, cache, seed):
    cell = dict(registry.cell(cell_name, registry.spec()), spp=4)
    scene = registry.module("scenes", cfg["scene"]).generate(cfg)
    drv = registry.module("drivers", cell["driver"])
    state = drv.setup(cfg, cell, drv.prepare(cfg, cell, scene, str(cache)), torch.device("cpu"))
    out = drv.frame(state, seed)
    pix = compare.pixels({"compare": {"pixels": "all"}}, cfg, 0, "cpu")
    acc, segs = registry.module("reference", cfg["reference"]).render(scene, cfg, seed, 4, pix)
    return out, integrate.image(acc, 4), int(segs.sum())


@pytest.mark.parametrize("cell", ["cover_mega_spp64", "cover_auto_spp8", "standin_hybrid_spp32"])
def test_reference_is_the_ports_frame(cell, tmp_path):
    cfg = tiny.config(registry.cell(cell, registry.spec())["config"])
    out, ref, segs = _frame(cell, cfg, tmp_path, 1234567)
    assert out["segments"] == segs
    assert torch.equal(out["image"].reshape(-1, 3), ref)


def test_flagship_reference_at_its_resolution(tmp_path):
    """The flagship's configuration at a small size through the one-card
    hybrid (its sharded frame is the one-card frame bit for bit)."""
    cfg = tiny.config("standin_flagship_4card")
    cfg["resolution"] = [40, 24]
    cfg["digest"] = registry.module("scenes", "standin").digest(
        registry.module("scenes", "standin").generate(cfg))
    out, ref, segs = _frame("standin_hybrid_spp32", cfg, tmp_path, 77)
    assert out["segments"] == segs
    assert torch.equal(out["image"].reshape(-1, 3), ref)
