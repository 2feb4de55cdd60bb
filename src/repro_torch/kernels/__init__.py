"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version.

    tick_loop       — the fused whole-transfer tick loop (csrc/tick_loop.cu),
                      replacing repro/core/engine.py::_build_pallas_core
    flash_attention — flash-attention forward and backward: bf16 on wgmma +
                      TMA (csrc/flash_attention{,_bwd}_sm90.cu, helpers
                      in csrc/sm90.cuh), float32 on FMAs
                      (csrc/flash_attention{,_bwd}.cu), replacing
                      repro/kernels/flash_attention/flash_attention.py::
                      flash_attention_bhtd and flash_attention_bwd.py::
                      flash_attention_bwd_bhtd
    rwkv6           — the RWKV-6 WKV recurrence (csrc/wkv.cu), replacing
                      repro/kernels/rwkv6/rwkv6.py::wkv_bhtd
    rglru           — the RG-LRU scan (csrc/rglru.cu), replacing
                      repro/kernels/rglru/rglru.py::rglru_scan
    build           — nvcc build of csrc/*.cu into plain-C libraries, one per
                      source with its own flags, at first use
    cost            — each kernel's operations and bytes from its shapes, and
                      the hook by which a wrapper reports them to a step
                      counter (launch/hlo_stats.py)
"""
