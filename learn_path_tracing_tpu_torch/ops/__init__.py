"""Hand-written CUDA kernels for Hopper (sources in ``csrc/``), each with its
plain PyTorch twin in the same module, except K4 (``bounce_megakernel``):
its plain version is the persistent integrator's own step, so it lives
there (``integrator.persistent.bounce_pass_plain``)."""
