"""Unified CLI: ``python -m learn_path_tracing_tpu_torch <command> [...]``.

Commands:
  render --stage N [stage args...]   run a tutorial/legacy stage script
  stages                             list available stages
  smoke                              device smoke test (legacy/test.py analog)
  bench [...]                        run the benchmark (bench_torch.py)
  multichip --nproc N [--device D]   multi-device dry run (parallel.dryrun)

Every command runs on the card; ``render``, ``bench`` and ``multichip`` take
``--device cpu`` to run on the CPU instead. ``multichip`` starts one rank a
card (NCCL) on the card, or N gloo ranks on the CPU.
"""

from __future__ import annotations

import argparse
import importlib
import json
import runpy
import sys
from pathlib import Path

STAGES = {
    "1": "s01_save_img", "2": "s02_camera_and_ray", "3": "s03_adding_a_sphere",
    "4": "s04_objects", "5": "s05_anti_aliasing", "6": "s06_diffuse",
    "7": "s07_reflect", "8": "s08_refract", "9": "s09_dof", "10": "s10_final",
    "l11": "l11_bvh", "l12": "l12_free_view", "l13": "l13_texture",
    "l14": "l14_mesh", "l15": "l15_module",
}

# the benchmark script at the root of the checkout, beside the package
BENCH = Path(__file__).resolve().parents[1] / "bench_torch.py"


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    cmd = argv.pop(0)

    if cmd == "stages":
        for key, mod in STAGES.items():
            print(f"{key:>4}  {__package__}.stages.{mod}")
        return 0

    if cmd == "render":
        if argv and argv[0] == "--stage":
            argv.pop(0)
        if not argv:
            print("usage: render --stage <1..10|l11..l15> [stage args]")
            return 2
        stage = argv.pop(0)
        mod_name = STAGES.get(stage)
        if mod_name is None:
            print(f"unknown stage {stage!r}; see 'stages'")
            return 2
        importlib.import_module(f"{__package__}.stages.{mod_name}").main(argv)
        return 0

    if cmd == "smoke":
        from .utils.checks import device_smoke_test

        device_smoke_test()
        print("device smoke test passed")
        return 0

    if cmd == "bench":
        return runpy.run_path(str(BENCH))["main"](argv)

    if cmd == "multichip":
        from .parallel.dryrun import dryrun_multichip

        p = argparse.ArgumentParser(prog="multichip", description="multi-device dry run")
        p.add_argument("--nproc", type=int, required=True,
                       help="ranks; on cuda at most one a card")
        p.add_argument("--device", default="cuda", help="cuda (NCCL) or cpu (gloo)")
        a = p.parse_args(argv)
        report = dryrun_multichip(a.nproc, a.device)
        print(json.dumps(report))
        print(f"dryrun_multichip({a.nproc}) ok")
        return 0

    print(f"unknown command {cmd!r}")
    return 2


if __name__ == "__main__":
    sys.exit(main())
