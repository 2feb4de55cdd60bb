"""repro_torch — the PyTorch/CUDA port of ``repro``: energy-efficient
high-throughput data transfers via dynamic CPU frequency and core scaling.

The package mirrors ``repro`` module for module and imports neither JAX nor
``repro``.  Its entry points (``repro_torch.api.run`` / ``sweep``; the
dense-LM serving of ``repro_torch.serve`` and ``repro_torch.launch.serve``)
run on the CUDA device unless the caller passes ``device="cpu"``.  There
the tick loop of every transfer and the attention of every prefill run in
hand-written CUDA kernels (``repro_torch.kernels``), and on the CPU in
their plain PyTorch versions.  ``repro_torch.convert`` carries state and
parameters between the two packages.
"""
