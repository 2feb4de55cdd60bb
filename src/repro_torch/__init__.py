"""repro_torch — the PyTorch/CUDA port of ``repro``: energy-efficient
high-throughput data transfers via dynamic CPU frequency and core scaling.

The package mirrors ``repro`` module for module and imports neither JAX nor
``repro``.  Its entry points (``repro_torch.api.run`` / ``sweep``) run on
the CUDA device unless the caller passes ``device="cpu"``; the tick loop of
every transfer runs in a hand-written CUDA kernel there
(``repro_torch.kernels.tick_loop``), and in its plain PyTorch version on the
CPU.  ``repro_torch.convert`` carries state between the two packages.
"""
