"""dsc.compile — whole-pipeline fusion over the public Tensor API.

The reference is eager by construction: every op is one C call, and its
only ahead-of-time hook is the FFT plan cache (``dsc_plan_fft``,
dsc/src/dsc.cpp:218-267). On an accelerator eager dispatch has two costs
the reference never pays: the host's per-op dispatch and one full
device-memory round-trip per op for every intermediate. ``dsc.compile``
traces a Python function of Tensors ONCE into a single XLA program, so a
whole pipeline (e.g. the README filterFFT chain, reference
README.md:110-137) runs as one device dispatch with its elementwise
intermediates fused.

Semantics:

- ``dsc.compile(fn)`` returns a callable. Arguments may be dsc Tensors,
  NumPy arrays (converted to Tensors), or Python scalars. Tensors trace
  as dynamic inputs; scalars are STATIC — each distinct scalar value
  compiles a separate program (pass a 1-element Tensor instead if the
  value changes every call).
- ``fn`` must be FUNCTIONAL: return every Tensor you need. In-place
  writes (``out=``, ``__setitem__``) to tensors created *inside* the
  traced function work as usual, but writes to *argument* tensors do not
  propagate back to the caller's tensors (XLA programs are pure).
- Anything that needs a concrete value mid-trace — ``.numpy()``,
  1-element unwrap via ``__getitem__``, ``print(t)`` — raises JAX's
  ConcretizationTypeError; compute values on device and return them.
- ``randn``/``from_numpy``/creation ops inside ``fn`` bake in as
  program CONSTANTS (same values every call); create varying data
  outside and pass it in.
- Complex tensors in planar storage (planar.py) cross the boundary as
  their two planes, so compiled pipelines keep the planar fast paths.
- ``dsc_tpu.models`` pipelines are ordinary Tensor->Tensor callables and
  compose under ``dsc.compile`` (e.g. STFT -> mask -> ISTFT as one
  program; tests/test_models.py).

Programs are cached per compiled wrapper, keyed by every argument's
(shape, dtype, storage layout) plus static scalar values, with bounded
LRU eviction mirroring the FFT plan cache contract (dsc.cpp:182-267);
cap via DSC_MAX_PROGRAMS (default 32). Traced ops record their tracing
events once at trace time; each call of the compiled program records a
single ``compile:<name>`` event instead (tracing.py).
"""

from __future__ import annotations

import functools
import os
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from . import tracing
from .planar import Planar
from .tensor import Tensor, from_numpy

__all__ = ['compile', 'map']


def _max_programs() -> int:
    try:
        return max(1, int(os.environ.get('DSC_MAX_PROGRAMS', '32')))
    except ValueError:
        return 32


def _spec_of(t: Tensor) -> Tuple[Tuple, Tuple[jax.Array, ...]]:
    """(hashable layout spec, leaf arrays) for one Tensor.

    The spec carries everything ``_rebuild`` needs that is NOT in the
    leaves themselves: the view shape (reshape views share a physical
    buffer of a different shape) and, for planar storage, the planes'
    shape."""
    pp = t._planar
    if pp is None:
        arr = t._buf.arr
        return ('d', t._shape, t._dtype), (arr,)
    return ('p', t._shape, pp.shape), (pp.re, pp.im)


def _rebuild(spec: Tuple, leaves: Tuple) -> Tensor:
    """Tensor over (possibly traced) leaves, matching ``_spec_of``.
    With tracers, _Buffer skips arena accounting (tensor.py); with the
    concrete output arrays it performs it, like any eager result."""
    if spec[0] == 'd':
        _, view_shape, dtype = spec
        t = Tensor._from_jax(leaves[0])
        t._shape = view_shape
        t._dtype = dtype
        return t
    _, view_shape, pshape = spec
    t = Tensor._from_planar(Planar(leaves[0], leaves[1], pshape))
    t._shape = view_shape
    return t


def _leaf_count(spec: Tuple) -> int:
    return 1 if spec[0] == 'd' else 2


def _flatten_result(res) -> Tuple[Tuple, List]:
    """(structure, leaves) of the traced function's return value.
    Supports a Tensor or arbitrarily nested tuples/lists of Tensors."""
    if isinstance(res, Tensor):
        spec, leaves = _spec_of(res)
        return ('t', spec), list(leaves)
    if isinstance(res, (tuple, list)):
        kind = 'tuple' if isinstance(res, tuple) else 'list'
        structs, leaves = [], []
        for r in res:
            s, ls = _flatten_result(r)
            structs.append(s)
            leaves.extend(ls)
        return (kind, tuple(structs)), leaves
    raise RuntimeError(
        'dsc.compile functions must return a Tensor or a tuple/list of '
        f'Tensors, got {type(res).__name__}'
    )


def _unflatten_result(struct: Tuple, it) -> Any:
    kind = struct[0]
    if kind == 't':
        spec = struct[1]
        return _rebuild(spec, tuple(next(it) for _ in range(_leaf_count(spec))))
    children = [_unflatten_result(s, it) for s in struct[1]]
    return tuple(children) if kind == 'tuple' else children


# argument slots: how each call argument enters the traced program
_SLOT_TENSOR = 't'
_SLOT_STATIC = 's'


def _leaf_shardings_of(spec: Tuple, pspec, mesh: Mesh, leaves) -> List:
    """Per-leaf placement for one argument Tensor whose layout spec is
    ``spec`` and whose user-requested logical PartitionSpec is ``pspec``.
    Returns one entry per leaf: a NamedSharding to ``device_put`` to, or
    None meaning LEAVE THE LEAF WHERE IT IS.

    Dense tensors have one leaf of the logical shape; planar complex
    tensors have two leaves each of the logical shape, so the same
    PartitionSpec applies to both planes.

    When no explicit spec was given and every leaf is ALREADY placed with
    a NamedSharding on this mesh (e.g. the sharded output of a previous
    compiled call), the placement is kept — chained mesh pipelines stay
    device-resident with zero host round-trips instead of being gathered
    back to replicated between calls (tests/test_compile.py)."""
    n_leaves = _leaf_count(spec)
    if pspec is None:
        if all(
            isinstance(getattr(l, 'sharding', None), NamedSharding)
            and l.sharding.mesh == mesh
            for l in leaves
        ):
            return [None] * n_leaves
        pspec = PartitionSpec()
    return [NamedSharding(mesh, pspec)] * n_leaves


def _constrain_out(struct: Tuple, leaves: List, out_specs, mesh: Mesh) -> List:
    """Apply ``with_sharding_constraint`` to output leaves, walking the
    result structure. ``out_specs`` is one PartitionSpec for every output
    tensor, or a flat sequence matching the tensor outputs in order."""
    specs: List = []

    def collect(st):
        if st[0] == 't':
            specs.append(st[1])
        else:
            for c in st[1]:
                collect(c)

    collect(struct)
    if isinstance(out_specs, PartitionSpec) or out_specs is None:
        per_tensor = [out_specs] * len(specs)
    else:
        per_tensor = list(out_specs)
        if len(per_tensor) != len(specs):
            raise RuntimeError(
                f'dsc.compile out_specs has {len(per_tensor)} entries for '
                f'{len(specs)} output tensors'
            )
    out, i = list(leaves), 0
    for spec, ps in zip(specs, per_tensor):
        nl = _leaf_count(spec)
        if ps is not None:
            s = NamedSharding(mesh, ps)
            for j in range(i, i + nl):
                out[j] = jax.lax.with_sharding_constraint(out[j], s)
        i += nl
    return out


class _Compiled:
    """One compiled wrapper: spec-keyed LRU of jitted programs."""

    def __init__(self, fn, mesh: Optional[Mesh] = None,
                 in_specs: Optional[Sequence] = None,
                 out_specs=None):
        self._fn = fn
        self._name = getattr(fn, '__name__', 'fn')
        self.__doc__ = getattr(fn, '__doc__', None)
        self.__name__ = self._name
        self._programs: 'OrderedDict[Tuple, Tuple]' = OrderedDict()
        self._mesh = mesh
        self._in_specs = tuple(in_specs) if in_specs is not None else None
        self._out_specs = out_specs
        if mesh is None and (in_specs is not None or out_specs is not None):
            raise RuntimeError('dsc.compile: in_specs/out_specs need mesh=')

    # -- call ---------------------------------------------------------------

    def __call__(self, *args, **kwargs):
        slots: List[Tuple] = []  # (kind, name_or_None, spec_or_value)
        leaves: List = []
        shardings: List = []  # per-leaf NamedSharding when mesh is set
        tensor_slots: List = []  # (tensor, leaf_start, n_leaves)
        if self._in_specs is not None and len(self._in_specs) > len(args):
            raise RuntimeError(
                f'dsc.compile in_specs has {len(self._in_specs)} entries '
                f'for {len(args)} positional arguments'
            )
        for pos, (name, a) in enumerate(
            [(None, a) for a in args] + sorted(kwargs.items())
        ):
            if isinstance(a, np.ndarray):
                a = from_numpy(a)
            if isinstance(a, Tensor):
                spec, ls = _spec_of(a)
                slots.append((_SLOT_TENSOR, name, spec))
                tensor_slots.append((a, len(leaves), len(ls)))
                leaves.extend(ls)
                if self._mesh is not None:
                    ps = None
                    if (self._in_specs is not None and name is None
                            and pos < len(self._in_specs)):
                        ps = self._in_specs[pos]
                    shardings.extend(
                        _leaf_shardings_of(spec, ps, self._mesh, ls)
                    )
            elif isinstance(a, (bool, int, float, complex, str, type(None))):
                slots.append((_SLOT_STATIC, name, a))
            else:
                raise RuntimeError(
                    'dsc.compile arguments must be Tensors, NumPy arrays '
                    f'or Python scalars, got {type(a).__name__}'
                )
        if self._mesh is not None:
            placed = [
                l if s is None else jax.device_put(l, s)
                for l, s in zip(leaves, shardings)
            ]
            # sticky placement: write the placed leaves back into the
            # argument Tensors, so a replicated weight/filter tensor
            # uploads to the mesh ONCE and later calls see it already
            # resident (values are identical — only placement changes)
            for t, i0, nl in tensor_slots:
                if any(placed[i] is not leaves[i] for i in range(i0, i0 + nl)):
                    pp = t._planar
                    if pp is None:
                        t._buf.arr = placed[i0]
                    else:
                        pp.re, pp.im = placed[i0], placed[i0 + 1]
                        pp._dense = None
                    t._buf.version += 1  # derived caches refresh lazily
            leaves = placed
        key = tuple(slots)
        prog = self._programs.get(key)
        if prog is None:
            prog = self._make_program(tuple(slots))
            while len(self._programs) >= _max_programs():
                self._programs.popitem(last=False)
            self._programs[key] = prog
        else:
            self._programs.move_to_end(key)
        jitted, out_cell = prog
        with tracing.trace_op(
            f'compile:{self._name}', 'op;compile',
            {'n_leaves': len(leaves)},
        ) as holder:
            out_leaves = jitted(*leaves)
            if holder is not None and out_leaves:
                holder.result = out_leaves[0]
        return _unflatten_result(out_cell['struct'], iter(out_leaves))

    # -- program construction -------------------------------------------------

    def _make_program(self, slots: Tuple) -> Tuple:
        fn = self._fn
        out_cell: Dict[str, Tuple] = {}

        def run(*in_leaves):
            it = iter(in_leaves)
            call_args: List = []
            call_kwargs: Dict[str, Any] = {}
            for kind, name, payload in slots:
                if kind == _SLOT_STATIC:
                    v: Any = payload
                else:
                    v = _rebuild(
                        payload,
                        tuple(next(it) for _ in range(_leaf_count(payload))),
                    )
                if name is None:
                    call_args.append(v)
                else:
                    call_kwargs[name] = v
            res = fn(*call_args, **call_kwargs)
            struct, out_leaves = _flatten_result(res)
            if self._mesh is not None and self._out_specs is not None:
                out_leaves = _constrain_out(
                    struct, out_leaves, self._out_specs, self._mesh
                )
            out_cell['struct'] = struct
            return tuple(out_leaves)

        return jax.jit(run), out_cell

    # -- introspection ---------------------------------------------------------

    @property
    def n_programs(self) -> int:
        return len(self._programs)

    def clear_cache(self) -> None:
        self._programs.clear()


def compile(fn=None, *, mesh=None, in_specs=None,  # noqa: A001 — public name
            out_specs=None):
    """Compile ``fn(*tensors) -> Tensor(s)`` into one fused XLA program
    per argument signature. Usable as a decorator::

        @dsc.compile
        def pipeline(sig, flt):
            spec = dsc.rfft(sig) * dsc.rfft(flt)
            return dsc.irfft(spec)

    With ``mesh=`` the program compiles SPMD over a ``jax.sharding.Mesh``
    (the reference has no distributed story, SURVEY §2.4; XLA inserts
    the collectives the sharded dataflow needs)::

        mesh = dsc.make_mesh((4, 1))                  # 4 devices on 'data'
        pipe = dsc.compile(pipeline, mesh=mesh,
                           in_specs=(P('data'), P()),  # batch-shard sig,
                           out_specs=P('data'))        # replicate flt

    ``in_specs`` aligns with the positional arguments (None/P() =
    replicated); input leaves are device_put to the requested layout on
    every call, a no-op when already placed. An argument with NO explicit
    spec that already carries a ``NamedSharding`` on this mesh — e.g. the
    sharded output of a previous compiled call — is consumed IN PLACE, so
    chained mesh pipelines stay device-resident (zero gathers / host
    round-trips between steps); otherwise unspecified arguments (and all
    keyword tensors) are replicated. ``out_specs`` is one PartitionSpec
    for all outputs or
    a sequence matching the returned tensors; omitted means GSPMD
    propagation decides.

    See the module docstring for tracing semantics and restrictions."""
    if fn is None:
        return functools.partial(
            compile, mesh=mesh, in_specs=in_specs, out_specs=out_specs
        )
    return _Compiled(fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs)


class _Mapped:
    """One fused-elementwise wrapper over a private ``_Compiled`` of fn."""

    def __init__(self, fn):
        self._compiled = _Compiled(fn)
        self.__doc__ = getattr(fn, '__doc__', None)
        self.__name__ = self._compiled.__name__

    def __call__(self, *args):
        args = tuple(
            from_numpy(a) if isinstance(a, np.ndarray) else a for a in args
        )
        if not args or not all(isinstance(a, Tensor) for a in args):
            raise RuntimeError(
                'dsc.map takes one or more Tensor/ndarray arguments '
                '(bake scalar constants into the function body)'
            )
        return self._compiled(*args)

    @property
    def n_programs(self) -> int:
        return self._compiled.n_programs


def map(fn, *tensors):  # noqa: A001 — public name, mirrors dsc.compile
    """Fuse an elementwise Tensor pipeline into ONE device pass.

    ``dsc.map(fn)`` returns a reusable wrapper; ``dsc.map(fn, x, y)``
    applies immediately. ``fn`` must be ELEMENTWISE — every output
    element depends only on the same-position input elements (chained
    +-*/, clip, transcendentals). Eager chains pay one device-memory
    read+write per op; under ``dsc.map`` the chain compiles to one XLA
    program whose elementwise ops fuse into a single loop, reading and
    writing device memory once each way — e.g.
    ``dsc.map(lambda x: dsc.clip(x * 2.0 + 1.0, 0.0))`` is a single pass
    instead of three. The reference has no analog (its ops are one C call
    each). Arguments must be Tensors or NumPy arrays."""
    wrapper = _Mapped(fn)
    if tensors:
        return wrapper(*tensors)
    return wrapper
