"""The cost counter: a program's per-device work, counted as it runs.

Counterpart of what ``repro.launch.dryrun`` reads from XLA
(``cost_analysis``, ``memory_analysis`` and the collectives of the SPMD
per-partition HLO).  The port has no compiler, so :class:`CostCounter`, a
``TorchDispatchMode``, counts the eager program itself, op by op, on
whatever tensors it runs: meta tensors (shapes only, nothing allocated),
CPU tensors, or the card's.

* **Per device.**  On a DTensor op the counter returns ``NotImplemented``,
  so DTensor runs the op on the local shards and those local ops come back
  to the counter: the count is rank 0's partition, as XLA's per-partition
  program is.  DTensor's sharding propagation runs each op once more on
  global-shape fake tensors when its cache misses; ops on fake tensors are
  not counted, so the count does not depend on what ran before.
* **Flops** by the formulas of ``torch.utils.flop_counter`` (matrix
  products, convolutions, attention), kept by the unit that runs them:
  ``"bf16"`` (bf16 and f16), ``"f32"``, ``"int8"``.
* **Bytes accessed**: for each aten op, the bytes of its inputs and
  outputs, each tensor at most its storage's size.  A view or alias moves
  nothing; an allocation (``empty``) moves nothing; a ``*_like`` factory
  and ``copy_`` read nothing of what they overwrite; an indexed read
  (``index``, ``gather``, ``embedding``) reads what it returns, not the
  whole table; an indexed write into ``self`` (``index_copy_``,
  ``index_put_``, ``scatter_*``) writes what it is given.  This is the
  eager program's traffic, which is what the port runs.
* **Kernels**: the ``ops`` entries charge their kernel's work
  (``kernels.cost``) and hide what runs beneath them.
* **Memory**: :meth:`CostCounter.arguments` marks the inputs; every storage
  an op makes is live until Python frees it (storages by identity, so a
  view counts once); ``peak`` is the largest live total, arguments
  included.  Nothing is donated: a train step's new parameters and
  moments live beside the old ones at its end.
* **Collectives**: the bytes of each ``_c10d_functional`` collective's
  local output, by the reference's kind names (``wait_tensor`` moves
  nothing; a kind the reference lacks keeps its op's name).  On a
  cpu-typed mesh DTensor runs an all-to-all as an all-gather and a chunk,
  so a record names its mesh's device type.
"""
from __future__ import annotations

import contextlib

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

__all__ = ["CostCounter", "cost_analysis_dict", "collective_bytes",
           "local_tensors", "unit_of", "COLLECTIVE_KINDS"]

aten = torch.ops.aten

#: ``_c10d_functional`` op -> the reference's collective kind.
COLLECTIVE_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
    "broadcast_": "collective-permute",
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd")
# ops of those namespaces that move nothing between ranks
_NOT_COLLECTIVES = {"wait_tensor", "_wrap_tensor_autograd"}

# aliases the schema does not mark as views
_ALIASES = {aten._unsafe_view.default, aten.lift_fresh.default,
            aten.alias.default}
# allocate without writing
_ALLOCS = {aten.empty.memory_format, aten.empty_strided.default,
           aten.empty_like.default, aten.new_empty.default,
           aten.new_empty_strided.default}
# write their output without reading their inputs' data
_WRITE_ONLY = {aten.zeros_like.default, aten.ones_like.default,
               aten.full_like.default, aten.new_zeros.default,
               aten.new_ones.default, aten.new_full.default,
               aten.fill_.Scalar, aten.zero_.default}
# read the rows they return, not the whole table (its first argument)
_GATHERS = {aten.index.Tensor, aten.index_select.default,
            aten.gather.default, aten.embedding.default}
# write the rows they are given into ``self`` (their first argument)
_SCATTERS = {aten.index_copy_.default, aten.index_copy.default,
             aten.index_put_.default, aten.index_put.default,
             aten._index_put_impl_.default, aten.scatter_.src,
             aten.scatter_add_.default, aten.scatter_reduce_.two,
             aten.index_add_.default, aten.index_add.default,
             aten.scatter.src, aten.scatter_add.default}


def unit_of(dtype: torch.dtype) -> str:
    """The unit a product of ``dtype`` runs on: bf16, f32, int8 (or the
    dtype's own name)."""
    if dtype in (torch.bfloat16, torch.float16):
        return "bf16"
    if dtype == torch.float32:
        return "f32"
    if dtype in (torch.int8, torch.uint8):
        return "int8"
    return str(dtype).replace("torch.", "")


def _tensors(tree) -> list:
    """The tensors of a nested dict / list / tuple (a NamedTuple too)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def local_tensors(tree) -> list:
    """The tensors of a nested dict / list / tuple, a DTensor as its local
    shard."""
    return [x._local_tensor if hasattr(x, "_local_tensor") else x
            for x in _tensors(tree)]


def _nbytes(t: torch.Tensor) -> int:
    """A tensor's bytes, at most its storage's (an expanded view reads its
    storage once)."""
    return min(t.numel() * t.element_size(), t.untyped_storage().nbytes())


def _is_fake(t) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(t, FakeTensor)


def _host_scalar_copy(func, ins, outs) -> bool:
    """A 0-d CPU tensor copied to another device: how a meta op takes a
    host scalar that a CPU or CUDA op reads in place (not counted, so the
    count is the same on every device)."""
    return (func is aten._to_copy.default and len(ins) == 1
            and ins[0].dim() == 0 and ins[0].device.type == "cpu"
            and outs and outs[0].device.type != "cpu")


class CostCounter(TorchDispatchMode):
    """Counts the per-device work of what runs inside ``with counter:``.

    After the block: ``flops`` ({unit: operations}), ``bytes_accessed``,
    ``collectives`` ({kind: bytes}), ``kernels`` ({entry: {calls, flops,
    bytes}}), ``ops`` (aten ops counted) and :meth:`memory`.  Call
    :meth:`arguments` with the step's inputs before running it and
    :meth:`outputs` with its result after."""

    def __init__(self):
        super().__init__()
        from torch.distributed.tensor import DTensor
        self._dtensor = DTensor
        self.flops: dict[str, float] = {}
        self.bytes_accessed = 0
        self.collectives: dict[str, int] = {}
        self.kernels: dict[str, dict] = {}
        self.ops = 0
        self._quiet = 0
        self._live: dict[int, tuple] = {}
        self._live_bytes = 0
        self._args: set[int] = set()
        self.argument = 0
        self.output = 0
        self.peak = 0

    # ----------------------------------------------------------- memory

    def _sweep(self) -> None:
        """Forget storages Python has freed."""
        dead = [k for k, (ref, _) in self._live.items() if ref.expired()]
        for k in dead:
            self._live_bytes -= self._live.pop(k)[1]

    def _track(self, tensors) -> None:
        from torch.multiprocessing.reductions import StorageWeakRef
        for t in tensors:
            if _is_fake(t):
                continue
            st = t.untyped_storage()
            key = st._cdata
            old = self._live.get(key)
            if old is not None:
                if not old[0].expired():
                    continue                 # a view of a live storage
                self._live_bytes -= self._live.pop(key)[1]
            n = st.nbytes()
            if self._live_bytes + n > self.peak:
                self._sweep()
            self._live[key] = (StorageWeakRef(st), n)
            self._live_bytes += n
            self.peak = max(self.peak, self._live_bytes)

    def arguments(self, *trees) -> int:
        """Mark the step's inputs live; returns their bytes (distinct
        storages of the local tensors)."""
        before = self._live_bytes
        tensors = [t for tree in trees for t in local_tensors(tree)]
        self._track(tensors)
        self._args |= {t.untyped_storage()._cdata for t in tensors}
        self.argument += self._live_bytes - before
        return self.argument

    def outputs(self, *trees) -> int:
        """The bytes of the step's results that are not its inputs
        (distinct storages)."""
        seen, n = set(), 0
        for t in (t for tree in trees for t in local_tensors(tree)):
            st = t.untyped_storage()
            if st._cdata in self._args or st._cdata in seen:
                continue
            seen.add(st._cdata)
            n += st.nbytes()
        self.output = n
        return n

    def memory(self) -> dict:
        """argument, output, temp (the peak's bytes past the arguments and
        the outputs) and peak, in bytes."""
        return {"argument": self.argument, "output": self.output,
                "temp": max(self.peak - self.argument - self.output, 0),
                "peak": self.peak}

    # ---------------------------------------------------------- kernels

    @contextlib.contextmanager
    def quiet(self):
        """Count nothing inside (a kernel entry's plain version)."""
        self._quiet += 1
        try:
            yield
        finally:
            self._quiet -= 1

    def charge_kernel(self, name: str, flops: dict, n_bytes: int,
                      out) -> None:
        """One call of kernel entry ``name``: its work, and its outputs'
        memory."""
        if self._quiet:
            return
        k = self.kernels.setdefault(name, {"calls": 0, "flops": {},
                                           "bytes": 0})
        k["calls"] += 1
        k["bytes"] += n_bytes
        for unit, f in flops.items():
            k["flops"][unit] = k["flops"].get(unit, 0.0) + f
            self.flops[unit] = self.flops.get(unit, 0.0) + f
        self.bytes_accessed += n_bytes
        self._track(_tensors(out))

    # --------------------------------------------------------- dispatch

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, self._dtensor) for t in types):
            return NotImplemented           # come back as local ops
        out = func(*args, **kwargs)
        if self._quiet:
            return out
        ins = _tensors(args) + _tensors(kwargs)
        outs = _tensors(out)
        if any(_is_fake(t) for t in ins + outs):
            return out                      # DTensor's shape propagation
        if _host_scalar_copy(func, ins, outs):
            return out
        self._count(func, args, kwargs, out, ins, outs)
        return out

    def _count(self, func, args, kwargs, out, ins, outs) -> None:
        self.ops += 1
        if func.namespace in _COLLECTIVE_NAMESPACES:
            name = func._overloadpacket.__name__
            if name not in _NOT_COLLECTIVES:
                kind = COLLECTIVE_KINDS.get(name, name)
                self.collectives[kind] = (self.collectives.get(kind, 0)
                                          + sum(_nbytes(t) for t in outs))
            self._track(outs)
            return
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None and ins:
            unit = unit_of(ins[0].dtype)
            self.flops[unit] = (self.flops.get(unit, 0.0)
                                + float(formula(*args, **kwargs,
                                                out_val=out)))
        self.bytes_accessed += self._op_bytes(func, args, ins, outs)
        self._track(outs)

    @staticmethod
    def _op_bytes(func, args, ins, outs) -> int:
        if func.is_view or func in _ALIASES or func in _ALLOCS:
            return 0
        written = sum(_nbytes(t) for t in outs)
        if func in _WRITE_ONLY:
            return written
        if func in _GATHERS:
            table = args[0] if isinstance(args[0], torch.Tensor) else None
            return (written + sum(_nbytes(t) for t in ins if t is not table)
                    + written)
        if func in _SCATTERS or func is aten.copy_.default:
            dest = args[0]
            given = sum(_nbytes(t) for t in ins if t is not dest)
            return given + (given if func is not aten.copy_.default
                            else _nbytes(dest))
        return sum(_nbytes(t) for t in ins) + written

    def record(self) -> dict:
        """Everything counted, as plain numbers."""
        return {"flops": dict(self.flops),
                "bytes_accessed": self.bytes_accessed,
                "collectives": dict(self.collectives),
                "kernels": {k: dict(v, flops=dict(v["flops"]))
                            for k, v in self.kernels.items()},
                "memory": self.memory(), "ops": self.ops}


def cost_analysis_dict(counter: CostCounter) -> dict:
    """The counted step in the keys of XLA's ``cost_analysis``: ``flops``
    (every unit) and ``bytes accessed``, plus the flops by unit."""
    return {"flops": float(sum(counter.flops.values())),
            "bytes accessed": float(counter.bytes_accessed),
            "flops by unit": dict(counter.flops)}


def collective_bytes(counter: CostCounter) -> dict:
    """Per-device bytes moved by each collective kind."""
    return dict(counter.collectives)
