"""The no-JAX check compares whole top-level names."""

from benchmark.harness import guard


def test_whole_top_level_names():
    mods = ["learn_path_tracing_tpu_torch", "learn_path_tracing_tpu_torch.ops.build",
            "jaxtyping", "numpy", "flaxen"]
    assert guard.forbidden_modules(mods) == []
    bad = mods + ["jax", "jaxlib.xla_client", "flax.linen", "learn_path_tracing_tpu.core"]
    assert guard.forbidden_modules(bad) == ["flax.linen", "jax", "jaxlib.xla_client",
                                            "learn_path_tracing_tpu.core"]


def test_no_jax_after_a_run(tmp_path):
    from benchmark.tests import tiny

    code, out = tiny.execute("cover_mega_spp64", 5, tmp_path)
    assert code == 0 and out["correct"]
    assert guard.forbidden_modules() == []
