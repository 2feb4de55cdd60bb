"""Count what one rank's program does in a step, and the roofline terms of
those counts on the card (the port of ``repro/launch/hlo_stats.py``).

JAX reads a compiled executable: ``cost_analysis()`` gives its FLOPs and
bytes, and the post-SPMD HLO text its collectives.  The port's program is
eager, so it is counted while it runs: :class:`StepCounter` is a
``TorchDispatchMode`` that sees every aten op of the step, on ``meta``
tensors (the dry run: shapes only, nothing allocated) or on the card
alike, and counts

* **FLOPs**: each matrix product and convolution by the formulas of
  ``torch.utils.flop_counter`` (``flop_registry``: 2 a multiply-add;
  elementwise work counts none), plus each hand-written kernel's own
  operations, which its wrapper reports (``repro_torch.kernels.cost``);
* **bytes accessed**: each op's tensor inputs read and outputs written
  once (an expanded input counts its distinct elements; views and
  allocations move nothing; an op that overwrites its argument does not
  read it), plus each kernel's bytes by its formula.  In an eager
  program every op goes through device memory, so this is what the step
  moves;
* **collectives**: the c10d ops the step issues (the data-parallel mean,
  ``shard_map``'s reassembly, ``psum``, ``all_to_all``, DTensor
  redistributions), by JAX's kinds, in result bytes, an all-reduce twice
  (ring all-reduce = reduce-scatter + all-gather): :func:`collective_bytes`;
* **memory**: the bytes of the storages the step allocates that are
  alive at once, at their peak (``peak_bytes``).

Inside a kernel wrapper the PyTorch ops (the plain version on the CPU, a
wrapper's own scratch work) add memory only: the kernel's formula stands
for them, so a count on the CPU, on ``meta`` and on the card is the same.
DTensor ops are counted at the local tensors' sizes (the mode defers to
DTensor, whose local ops it then sees); the fake tensors DTensor's
sharding propagation makes are not counted.
"""
from __future__ import annotations

import weakref
from collections import defaultdict

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..kernels import cost

# H100 SXM peaks (NVIDIA data sheet, at the 700 W power limit).
BF16_TENSOR_OPS_PER_S = 989e12    # dense bf16 on the tensor cores
F32_OPS_PER_S = 67e12             # float32 on the CUDA cores
HBM_BYTES_PER_S = 3.35e12
NVLINK_BYTES_PER_S = 450e9        # NVLink 4, each way, per card

#: c10d and functional-collective ops, by JAX's collective kinds.
COLLECTIVE_KINDS = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_":
    "reduce-scatter", "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "all_to_all_single": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
    "broadcast_": "broadcast", "broadcast": "broadcast",
}
_COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional")

_aten = torch.ops.aten
#: Ops that allocate or alias and move no bytes.
_FREE = {_aten.empty, _aten.empty_like, _aten.empty_strided,
         _aten.new_empty, _aten.new_empty_strided, _aten.detach,
         _aten.alias, _aten._unsafe_view, _aten.lift_fresh,
         _aten._local_scalar_dense, _aten.set_, _aten.resize_}
#: In-place ops that write their first argument without reading it.
_OVERWRITES = {_aten.copy_, _aten.fill_, _aten.zero_}


def _distinct_bytes(t) -> int:
    """Bytes of the distinct elements a tensor addresses (a broadcast dim,
    stride 0, counts once)."""
    n = t.element_size()
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n if t.numel() else 0


def tensor_leaves(tree, out=None) -> list:
    """The tensors of an op's arguments or results (lists, tuples and
    dicts of them)."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            tensor_leaves(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            tensor_leaves(x, out)
    return out


class StepCounter(TorchDispatchMode):
    """Counts the step run while entered (module docstring): ``flops``,
    ``bytes``, :attr:`collectives`, ``peak_bytes`` (and ``live_bytes``
    now), and ``kernels`` ({wrapper name: {"calls", "flops", "bytes"}}).
    Enter it around the step; it reports the kernels' formulas to itself
    while entered."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.kernels = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self._coll_bytes = defaultdict(int)
        self._coll_counts = defaultdict(int)
        self._kernel_depth = 0
        self._storages = {}

    def __enter__(self):
        self._active = cost.active(self)
        self._active.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._active.__exit__(*exc)

    # -- kernels (called by repro_torch.kernels.cost.counted wrappers) --
    def enter_kernel(self, name: str, flops: int, nbytes: int) -> None:
        if self._kernel_depth == 0:
            k = self.kernels.setdefault(name, {"calls": 0, "flops": 0,
                                               "bytes": 0})
            k["calls"] += 1
            k["flops"] += flops
            k["bytes"] += nbytes
            self.flops += flops
            self.bytes += nbytes
        self._kernel_depth += 1

    def exit_kernel(self) -> None:
        self._kernel_depth -= 1

    @property
    def collectives(self) -> dict:
        """JAX's ``collective_bytes`` dict: {"bytes": {kind: result bytes,
        ..., "total": sum}, "counts": {kind: ops}}."""
        out = dict(self._coll_bytes)
        out["total"] = sum(self._coll_bytes.values())
        return {"bytes": out, "counts": dict(self._coll_counts)}

    # -- the ops --
    def _free(self, key, n):
        self.live_bytes -= n
        self._storages.pop(key, None)

    def _track(self, outs):
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in self._storages:
                continue
            n = st.nbytes()
            self._storages[key] = weakref.finalize(st, self._free, key, n)
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = tensor_leaves((args, kwargs))
        if any(type(x) is DTensor for x in ins):
            return NotImplemented       # counted at DTensor's local ops
        out = func(*args, **kwargs)
        outs = tensor_leaves(out)
        if any(isinstance(x, FakeTensor) for x in ins + outs):
            return out                  # DTensor's sharding propagation
        self._track(outs)
        if self._kernel_depth:
            return out
        packet = func.overloadpacket
        if func.namespace in _COLLECTIVE_NAMESPACES:
            kind = COLLECTIVE_KINDS.get(packet.__name__)
            if kind is not None:
                res = outs or ins[:1]
                nbytes = sum(x.numel() * x.element_size() for x in res)
                self._coll_bytes[kind] += nbytes * (2 if kind == "all-reduce"
                                                    else 1)
                self._coll_counts[kind] += 1
            return out
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
        if func.is_view or packet in _FREE:
            return out
        reads = sum(_distinct_bytes(x) for x in ins)
        if packet in _OVERWRITES:
            reads -= _distinct_bytes(ins[0])
        self.bytes += reads + sum(_distinct_bytes(x) for x in outs)
        return out


def collective_bytes(fn, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` under a :class:`StepCounter` and return
    its collectives as JAX's ``collective_bytes`` does for an HLO module:
    per-kind result bytes (an all-reduce twice) and counts."""
    with StepCounter() as c:
        fn(*args, **kwargs)
    return c.collectives


def roofline_terms(flops: float, hbm_bytes: float, coll_bytes: float,
                   chips: int) -> dict:
    """Three per-step roofline times (seconds) on one H100 SXM at 700 W:
    ``flops`` at the bf16 tensor-core peak, ``hbm_bytes`` at the HBM rate,
    ``coll_bytes`` at NVLink 4's 450 GB/s each way.  Inputs are per-device
    quantities (one rank's program), so ``chips`` does not scale them.

    NVLink joins the 8 cards of one node; a 16 x 16 mesh spans 32 such
    nodes, and between nodes a card has about 50 GB/s (InfiniBand NDR), so
    the collective term is a lower bound wherever a collective's group
    leaves its node."""
    t_compute = flops / BF16_TENSOR_OPS_PER_S
    t_memory = hbm_bytes / HBM_BYTES_PER_S
    t_collective = coll_bytes / NVLINK_BYTES_PER_S
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_collective}
    dom = max(terms, key=terms.get)
    terms["bottleneck"] = dom.replace("_s", "")
    return terms
