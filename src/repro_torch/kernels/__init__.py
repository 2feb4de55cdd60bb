"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version.

    tick_loop — the fused whole-transfer tick loop (csrc/tick_loop.cu),
                replacing repro/core/engine.py::_build_pallas_core
    build     — nvcc build of csrc/*.cu into plain-C libraries, at first use
"""
