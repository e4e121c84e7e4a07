"""Runnable stage scripts: ``python -m learn_path_tracing_tpu_torch.stages.<name>``."""
