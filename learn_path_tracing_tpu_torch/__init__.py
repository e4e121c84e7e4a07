"""learn_path_tracing_tpu_torch — the path tracer on PyTorch and CUDA.

A port of ``learn_path_tracing_tpu`` (JAX/Pallas on a TPU) to PyTorch on an
NVIDIA H100. The layout mirrors the JAX package module for module, so each
function has its counterpart at the same path:

  core/        tensor dataclasses, counter RNG, color pipeline, PNG I/O
  geometry/    sphere, triangle and AABB math (plain PyTorch)
  accel/       host-side SAH BVH build, its 8-wide collapse (numpy) and
               BVH debug dumps and renders
  io/          OBJ meshes, OpenEXR images, texture atlases
  bsdf/        sampling primitives and BSDF scatter functions
  camera/      pinhole and thin-lens cameras
  ops/         hand-written CUDA kernels (sources in ``csrc/``) and their
               plain PyTorch twins, with the traversal-table packers
  scene/       sphere world and legacy mesh world, hit queries,
               ``.world.npy`` I/O
  models/      built-in scenes
  integrator/  wavefront, persistent (path-regeneration) and hybrid
               integrators
  viewer/      progressive accumulation renderer
  utils/       render configuration, numerical checks (render agreement,
               image validity, NaN trap), profiling, frame timing
  stages/      runnable stage scripts (s01-s10, l11-l15)
  __main__     the CLI: ``python -m learn_path_tracing_tpu_torch
               render|stages|smoke|bench`` (the bench is ``bench_torch.py``
               at the root of the checkout)

The package imports ``torch`` and ``numpy`` only. Every function that creates
tensors takes an explicit ``device``; randomness is the counter hash of
``core.rng``, so renders are deterministic by construction.
"""

__version__ = "0.1.0"
