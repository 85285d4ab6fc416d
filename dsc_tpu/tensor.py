"""The dsc_tpu Tensor: a NumPy-compatible tensor over jax.Array.

Rebuild of the reference tensor layer:
- dsc_tensor struct + creation/layout ops (dsc/src/dsc.cpp:342-827)
- Python Tensor class + free functions (python/dsc/tensor.py)

Design translation (SURVEY §7.1): the reference's right-aligned shape[4] /
element strides / refcounted buffers disappear — XLA owns layout. What
remains observable is preserved:

- max rank 4 (dsc.h:72-76)
- views share storage: ``reshape`` / same-dtype ``cast`` / ``conj``/``real``
  on real input return views, and writes through any view are visible through
  every other view of the same buffer (reference buffer-sharing,
  dsc.cpp:599-636). Views are implemented as a shared mutable ``_Buffer``
  cell + a per-view shape, since every view in the reference API is a pure
  reshape of contiguous storage.
- all indexing ops return copies (dsc.h:238-243)
- the exact dtype promotion table incl. the Python scalar rule
  (tensor.py:435-456: int/float -> F32, complex -> C32)
"""

from __future__ import annotations

import math
import weakref
from collections import OrderedDict
from functools import partial
from typing import List, Optional, Sequence, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from . import tracing
from .context import _get_ctx
from .planar import Planar
from . import planar as planar_ops
from .dtype import (
    DTYPE_TO_NP,
    Dtype,
    ScalarType,
    np_to_dtype,
    promote,
    scalar_dtype,
)
from .ops import kernels as K

DSC_MAX_DIMS = 4  # reference dsc.h:72-76

TensorType = Union['Tensor', np.ndarray]


# ---------------------------------------------------------------------------
# storage
# ---------------------------------------------------------------------------


class _Buffer:
    """Refcounted-buffer equivalent (reference dsc_tensor_buffer): owns one
    device array; registers its bytes with the context arena accounting.

    ``version`` bumps on every write-through so views can refresh lazily.

    Under a ``dsc.compile`` trace (fuse.py) the array is a jax Tracer with
    no storage; arena accounting is skipped — the real bytes are accounted
    when the compiled program's concrete outputs are rewrapped.
    """

    __slots__ = ('arr', 'version', 'nbytes', '__weakref__')

    def __init__(self, arr: jax.Array):
        leaf = arr.re if isinstance(arr, Planar) else arr
        if isinstance(leaf, jax.core.Tracer):
            self.arr = arr
            self.nbytes = 0
            self.version = 0
            return
        ctx = _get_ctx()
        nbytes = int(arr.nbytes)
        ctx.alloc(nbytes)
        self.arr = arr
        self.nbytes = nbytes
        self.version = 0
        weakref.finalize(self, ctx.free, nbytes)


class Tensor:
    __slots__ = ('_buf', '_shape', '_dtype', '_cache_ver', '_cache_arr')

    def __init__(self, data, dtype: Optional[Dtype] = None):
        """Construct from a jax.Array / np.ndarray (copies in, like
        dsc.from_numpy)."""
        if isinstance(data, Tensor):
            buf, shape, dt = data._buf, data._shape, data._dtype
        else:
            if isinstance(data, jax.Array):
                arr = data
                if dtype is not None and np_to_dtype(arr.dtype) != dtype:
                    arr = _astype(arr, dtype)
            else:
                host = np.asarray(data)
                if dtype is not None:
                    host = host.astype(DTYPE_TO_NP[dtype])
                arr = jax.device_put(host)
            dt = np_to_dtype(arr.dtype)
            if arr.ndim > DSC_MAX_DIMS:
                raise RuntimeError(
                    f'cannot create a Tensor with {arr.ndim} dimensions, '
                    f'max is {DSC_MAX_DIMS}'
                )
            buf, shape = _Buffer(arr), tuple(arr.shape)
        self._buf = buf
        self._shape = shape
        self._dtype = dt
        self._cache_ver = -1
        self._cache_arr = None

    # -- internal constructors --------------------------------------------

    @classmethod
    def _from_jax(cls, arr: jax.Array) -> 'Tensor':
        t = cls.__new__(cls)
        t._buf = _Buffer(arr)
        t._shape = tuple(arr.shape)
        t._dtype = np_to_dtype(arr.dtype)
        t._cache_ver = -1
        t._cache_arr = None
        return t

    @classmethod
    def _from_planar(cls, pp: Planar) -> 'Tensor':
        """Tensor over planar complex storage (planar.py). The public dtype
        is C32; materialization to dense complex64 is lazy (``.jax``)."""
        t = cls.__new__(cls)
        t._buf = _Buffer(pp)
        t._shape = pp.shape
        t._dtype = np_to_dtype(pp.dtype)
        t._cache_ver = -1
        t._cache_arr = None
        return t

    @classmethod
    def _view_of(cls, base: 'Tensor', shape: Tuple[int, ...]) -> 'Tensor':
        """Buffer-sharing view (reference dsc_view/dsc_reshape semantics)."""
        t = cls.__new__(cls)
        t._buf = base._buf
        t._shape = tuple(shape)
        t._dtype = base._dtype
        t._cache_ver = -1
        t._cache_arr = None
        return t

    # -- data access --------------------------------------------------------

    @property
    def jax(self) -> jax.Array:
        """The underlying device array, reshaped to this view's shape.
        Planar storage materializes to dense complex here (cached on the
        Planar object) — the fallback for every op without a planar fast
        path."""
        buf = self._buf
        arr = buf.arr
        if isinstance(arr, Planar):
            arr = arr.materialize()
        if self._shape == tuple(arr.shape):
            return arr
        if self._cache_ver != buf.version:
            self._cache_arr = arr.reshape(self._shape)
            self._cache_ver = buf.version
        return self._cache_arr

    @property
    def _planar(self) -> Optional[Planar]:
        arr = self._buf.arr
        return arr if isinstance(arr, Planar) else None

    def _write_through(self, arr: jax.Array) -> None:
        """Replace this view's contents, propagating to the shared buffer so
        every other view observes the write (reference shared-buffer
        mutation). A write into planar storage densifies it."""
        buf = self._buf
        # (Planar.shape is the logical shape, so this also densifies
        # planar storage at the right shape.)
        buf.arr = arr.reshape(buf.arr.shape)
        buf.version += 1

    # -- properties (reference tensor.py:171-189) ---------------------------

    @property
    def dtype(self) -> Dtype:
        return self._dtype

    @property
    def shape(self) -> Tuple[int, ...]:
        return self._shape

    @property
    def n_dim(self) -> int:
        return len(self._shape)

    @property
    def ne(self) -> int:
        return int(math.prod(self._shape))

    def __len__(self) -> int:
        return self._shape[0]

    def __str__(self) -> str:
        return str(self.numpy())

    def __repr__(self) -> str:
        return f'Tensor(dtype={self._dtype}, shape={self._shape})\n{self.numpy()}'

    # -- host interop --------------------------------------------------------

    def numpy(self) -> np.ndarray:
        """Materialize as NumPy. Zero-copy when the buffer is host-resident
        (CPU backend); a device->host copy otherwise. Unlike the reference's
        raw-pointer view (tensor.py:305-323) there is no lifetime hazard:
        jax.Array keeps the storage alive."""
        pp = self._planar
        if pp is not None:
            # planar download: two float-plane transfers + host combine
            return pp.to_numpy().reshape(self._shape)
        return np.asarray(self.jax)

    def __bytes__(self) -> bytes:
        return self.numpy().tobytes()

    def tobytes(self) -> bytes:
        return bytes(self)

    def cast(self, dtype: Dtype) -> 'Tensor':
        return cast(self, dtype)

    def reshape(self, *shape) -> 'Tensor':
        return reshape(self, *shape)

    def transpose(self, axes=None) -> 'Tensor':
        return transpose(self, axes)

    # -- indexing (reference tensor.py:193-267, dsc.cpp:829-1169) ------------

    def __getitem__(self, item):
        key = _normalize_key(item, self._shape)
        with tracing.trace_op('get', 'op;indexing', tracing.tensor_args(x=self)) as tr:
            res = self.jax[key]
            if tr:
                tr.result = res
        if res.ndim == 0 or res.size == 1:
            # the reference unwraps ANY 1-element result to a Python scalar
            # (python/dsc/tensor.py:91-103): x[3:4] is a scalar, not a Tensor
            # — except under a dsc.compile trace, where a host scalar cannot
            # exist; there the 1-element result stays a Tensor.
            if isinstance(res, jax.core.Tracer):
                return Tensor._from_jax(res.reshape((1,)))
            return _to_scalar(res.reshape(()), self._dtype)
        return Tensor._from_jax(res)

    def __setitem__(self, key, value):
        nkey = _normalize_key(key, self._shape)
        vj = _wrap_value_for_set(value, self._dtype)
        with tracing.trace_op('set', 'op;indexing', tracing.tensor_args(x=self)) as tr:
            try:
                new = self.jax.at[nkey].set(vj)
            except (TypeError, ValueError):
                # Reference tensor_set cycles the RHS modulo its element
                # count when shapes don't line up (dsc.cpp:1032-1040).
                region = self.jax[nkey]
                vals = jnp.resize(vj, region.shape)
                new = self.jax.at[nkey].set(vals)
            if tr:
                tr.result = new
        self._write_through(new)

    # -- operator protocol (reference tensor.py:269-297) ---------------------

    def __add__(self, other):
        return add(self, other)

    def __radd__(self, other):
        return add(other, self)

    def __sub__(self, other):
        return sub(self, other)

    def __rsub__(self, other):
        return sub(other, self)

    def __mul__(self, other):
        return mul(self, other)

    def __rmul__(self, other):
        return mul(other, self)

    def __truediv__(self, other):
        return true_div(self, other)

    def __rtruediv__(self, other):
        return true_div(other, self)

    def __pow__(self, other):
        return power(self, other)

    def __rpow__(self, other):
        return power(other, self)


# ---------------------------------------------------------------------------
# indexing helpers
# ---------------------------------------------------------------------------


def _normalize_key(item, shape):
    if isinstance(item, (int, np.integer, slice)):
        item = (item,)
    if not isinstance(item, tuple):
        raise RuntimeError(f'cannot index Tensor with object {item}')
    if len(item) > len(shape):
        raise RuntimeError(
            f'too many indices for Tensor with {len(shape)} dimensions'
        )
    out = []
    for i, k in enumerate(item):
        if isinstance(k, (int, np.integer)):
            dim = shape[i]
            k = int(k)
            # negative wrap (reference dsc.cpp:839-846)
            kk = k + dim if k < 0 else k
            if kk < 0 or kk >= dim:
                raise RuntimeError(f'index {k} is out of bounds for axis {i} with size {dim}')
            out.append(kk)
        elif isinstance(k, slice):
            out.append(k)
        else:
            raise RuntimeError(f'cannot index Tensor with object {k}')
    return tuple(out)


def _to_scalar(arr: jax.Array, dtype: Dtype):
    v = np.asarray(arr).item()
    if dtype.is_complex:
        return complex(v)
    return float(v)


@partial(jax.jit, static_argnames=('dtype',))
def _astype_jit(x, *, dtype):
    return x.astype(dtype)


def _astype(arr: jax.Array, dtype: Dtype) -> jax.Array:
    return _astype_jit(arr, dtype=DTYPE_TO_NP[dtype])


def _wrap_value_for_set(value, dtype: Dtype):
    """Value -> jax array of the target dtype (reference _wrap,
    tensor.py:121-150, generalized: values always cast to the tensor dtype)."""
    np_dt = DTYPE_TO_NP[dtype]
    if isinstance(value, Tensor):
        if value.dtype == dtype:
            return value.jax
        return _astype(value.jax, dtype)
    if isinstance(value, np.ndarray):
        return jax.device_put(value.astype(np_dt))
    return jax.device_put(np.asarray(value, dtype=np_dt))


# ---------------------------------------------------------------------------
# operand wrapping + promotion (reference tensor.py:435-456)
# ---------------------------------------------------------------------------


def _wrap(x, dtype: Optional[Dtype] = None) -> Tensor:
    if isinstance(x, Tensor):
        return x
    if isinstance(x, np.ndarray):
        return from_numpy(x)
    # Python scalar: wrap as a 1-element tensor, like dsc_wrap_* value
    # tensors (dsc.cpp:441-475).
    if isinstance(x, complex):
        dt = Dtype.C64 if dtype == Dtype.C64 else Dtype.C32
    elif isinstance(x, (bool, int, float, np.floating, np.integer)):
        if dtype == Dtype.F64:
            dt = Dtype.F64
        elif dtype == Dtype.C32:
            dt = Dtype.C32
        elif dtype == Dtype.C64:
            dt = Dtype.C64
        else:
            dt = Dtype.F32
        if dt.is_complex:
            x = complex(x, 0)
        else:
            x = float(x)
    else:
        raise RuntimeError(f'cannot wrap object {x!r} as a Tensor')
    return Tensor._from_jax(_scalar_device_array(x, dt))


# Device-scalar cache: an EAGER op with a Python-scalar operand otherwise
# pays a fresh 1-element host->device upload per call. jax arrays are
# immutable, so sharing the uploaded scalar across calls is safe.
_SCALAR_CACHE: OrderedDict = OrderedDict()
_SCALAR_CACHE_CAP = 512


def _scalar_device_array(x, dt: Dtype):
    key = (x, dt)
    try:
        arr = _SCALAR_CACHE.get(key)
    except TypeError:  # unhashable — never for plain scalars, but be safe
        arr = None
        key = None
    if arr is None:
        arr = jax.device_put(np.asarray([x], dtype=DTYPE_TO_NP[dt]))
        # Under a jax trace (dsc.compile / user jit) device_put yields a
        # Tracer; caching it would leak it into later eager calls
        # (UnexpectedTracerError). Cache only concrete device arrays.
        if isinstance(arr, jax.core.Tracer):
            key = None
        if key is not None:
            _SCALAR_CACHE[key] = arr
            while len(_SCALAR_CACHE) > _SCALAR_CACHE_CAP:
                _SCALAR_CACHE.popitem(last=False)
    else:
        _SCALAR_CACHE.move_to_end(key)
    return arr


def _operand_dtype(x) -> Dtype:
    if isinstance(x, Tensor):
        return x.dtype
    if isinstance(x, np.ndarray):
        return np_to_dtype(x.dtype)
    return scalar_dtype(x)


def _wrap_operands(xa, xb) -> Tuple[Tensor, Tensor]:
    """Scalar wrap + Python-side dtype promotion (reference
    tensor.py:435-456)."""
    if (isinstance(xa, Tensor) and isinstance(xb, Tensor)) or (
        isinstance(xa, np.ndarray) and isinstance(xb, np.ndarray)
    ):
        return _wrap(xa), _wrap(xb)
    wrap_dtype = promote(_operand_dtype(xa), _operand_dtype(xb))
    return _wrap(xa, wrap_dtype), _wrap(xb, wrap_dtype)


def _can_broadcast(sa: Tuple[int, ...], sb: Tuple[int, ...]) -> bool:
    """Right-aligned dims equal or 1 (reference dsc.cpp:1174-1184)."""
    for da, db in zip(reversed(sa), reversed(sb)):
        if da != db and da != 1 and db != 1:
            return False
    return True


def _finish(res: jax.Array, out: Optional[Tensor]) -> Tensor:
    """Return a fresh tensor, or write into ``out`` and hand back a view of
    it (the reference returns out wrapped as a view, tensor.py:423-432)."""
    if out is None:
        return Tensor._from_jax(res)
    if tuple(res.shape) != out.shape:
        raise RuntimeError(
            f'out tensor has shape {out.shape}, expected {tuple(res.shape)}'
        )
    if np_to_dtype(res.dtype) != out.dtype:
        raise RuntimeError(
            f'out tensor has dtype {out.dtype}, expected {np_to_dtype(res.dtype)}'
        )
    out._write_through(res)
    return Tensor._view_of(out, out.shape)


# ---------------------------------------------------------------------------
# binary ops (reference dsc.cpp:1247-1310)
# ---------------------------------------------------------------------------


def _try_planar_binary(xa, xb, name: str) -> Optional[Tensor]:
    """Planar fast path: keeps complex data as float planes across op
    boundaries (planar.py). Returns None when no fast path applies."""
    pa = xa._planar if isinstance(xa, Tensor) else None
    pb = xb._planar if isinstance(xb, Tensor) else None
    if pa is None and pb is None:
        return None
    args = tracing.tensor_args(
        xa=xa if isinstance(xa, Tensor) else None,
        xb=xb if isinstance(xb, Tensor) else None,
    )
    if pa is not None and pb is not None:
        if xa.shape != xb.shape:
            return None
        with tracing.trace_op(name, 'op;binary', args) as tr:
            res = planar_ops.binary_pp(name, pa, pb)
            if res is None:
                return None
            if tr:
                tr.result = (res.re, res.im)
        return _planar_result(res, xa.shape)
    # one side is a Python/NumPy scalar
    p, s, reverse = (pa, xb, False) if pa is not None else (pb, xa, True)
    if isinstance(s, (bool, int, float, np.floating, np.integer)):
        sc = complex(float(s), 0.0)
    elif isinstance(s, complex):
        sc = s
    elif isinstance(s, np.complexfloating):
        sc = complex(s)
    else:
        return None
    with tracing.trace_op(name, 'op;binary', args) as tr:
        res = planar_ops.binary_ps(name, p, sc, reverse)
        if tr:
            tr.result = (res.re, res.im)
    shape = xa.shape if isinstance(xa, Tensor) else xb.shape
    return _planar_result(res, shape)


def _planar_result(pp: Planar, view_shape) -> Tensor:
    """Wrap a Planar result; re-view when the operand was a reshaped view
    (Planar shapes are canonical)."""
    t = Tensor._from_planar(pp)
    if t._shape != tuple(view_shape):
        return Tensor._view_of(t, tuple(view_shape))
    return t


def _binary_op(xa, xb, out, name: str) -> Tensor:
    if out is None:
        fast = _try_planar_binary(xa, xb, name)
        if fast is not None:
            return fast
    xa, xb = _wrap_operands(xa, xb)
    if not _can_broadcast(xa.shape, xb.shape):
        raise RuntimeError(f'cannot broadcast {xa.shape} and {xb.shape}')
    out_dtype = promote(xa.dtype, xb.dtype)
    args = tracing.tensor_args(xa=xa, xb=xb)
    with tracing.trace_op(name, 'op;binary', args) as tr:
        res = K.BINARY[name](xa.jax, xb.jax, DTYPE_TO_NP[out_dtype])
        if tr:
            tr.result = res
    return _finish(res, out)


def add(xa, xb, out: Optional[Tensor] = None) -> Tensor:
    return _binary_op(xa, xb, out, 'add')


def sub(xa, xb, out: Optional[Tensor] = None) -> Tensor:
    return _binary_op(xa, xb, out, 'sub')


def mul(xa, xb, out: Optional[Tensor] = None) -> Tensor:
    return _binary_op(xa, xb, out, 'mul')


def true_div(xa, xb, out: Optional[Tensor] = None) -> Tensor:
    return _binary_op(xa, xb, out, 'div')


def power(xa, xb, out: Optional[Tensor] = None) -> Tensor:
    return _binary_op(xa, xb, out, 'pow')


# ---------------------------------------------------------------------------
# unary ops (reference dsc.cpp:1312-1769)
# ---------------------------------------------------------------------------


def _unary_op(x: Tensor, out, name: str, fn) -> Tensor:
    with tracing.trace_op(name, 'op;unary', tracing.tensor_args(x=x)) as tr:
        res = fn(x.jax)
        if tr:
            tr.result = res
    return _finish(res, out)


def cos(x: Tensor, out: Optional[Tensor] = None) -> Tensor:
    return _unary_op(x, out, 'cos', K.cos)


def sin(x: Tensor, out: Optional[Tensor] = None) -> Tensor:
    return _unary_op(x, out, 'sin', K.sin)


def sinc(x: Tensor, out: Optional[Tensor] = None) -> Tensor:
    return _unary_op(x, out, 'sinc', K.sinc)


def logn(x: Tensor, out: Optional[Tensor] = None) -> Tensor:
    return _unary_op(x, out, 'logn', K.logn)


def log2(x: Tensor, out: Optional[Tensor] = None) -> Tensor:
    return _unary_op(x, out, 'log2', K.log2)


def log10(x: Tensor, out: Optional[Tensor] = None) -> Tensor:
    return _unary_op(x, out, 'log10', K.log10)


def exp(x: Tensor, out: Optional[Tensor] = None) -> Tensor:
    return _unary_op(x, out, 'exp', K.exp)


def sqrt(x: Tensor, out: Optional[Tensor] = None) -> Tensor:
    return _unary_op(x, out, 'sqrt', K.sqrt)


def absolute(x: Tensor, out: Optional[Tensor] = None) -> Tensor:
    pp = x._planar if isinstance(x, Tensor) else None
    if pp is not None and out is None:
        with tracing.trace_op('abs', 'op;unary', tracing.tensor_args(x=x)) as tr:
            res = planar_ops.abs_planes(pp.re, pp.im)
            if tr:
                tr.result = res
        return Tensor._from_jax(res.reshape(x.shape))
    return _unary_op(x, out, 'abs', K.absolute)


def angle(x: Tensor) -> Tensor:
    pp = x._planar if isinstance(x, Tensor) else None
    if pp is not None:
        with tracing.trace_op('angle', 'op;unary', tracing.tensor_args(x=x)) as tr:
            res = planar_ops.angle_planes(pp.re, pp.im)
            if tr:
                tr.result = res
        return Tensor._from_jax(res.reshape(x.shape))
    return _unary_op(x, None, 'angle', K.angle)


def conj(x: Tensor) -> Tensor:
    # NOP view on real input (reference dsc.cpp:1543-1560)
    if x.dtype.is_real:
        return Tensor._view_of(x, x.shape)
    pp = x._planar if isinstance(x, Tensor) else None
    if pp is not None:
        # planar conj touches only the imaginary plane
        with tracing.trace_op('conj', 'op;unary', tracing.tensor_args(x=x)) as tr:
            res = Planar(pp.re, planar_ops.neg_im(pp.im), pp.shape)
            if tr:
                tr.result = res.im
        return _planar_result(res, x.shape)
    return _unary_op(x, None, 'conj', K.conj)


def real(x: Tensor) -> Tensor:
    # NOP view on real input (reference dsc.cpp:1562-1594)
    if x.dtype.is_real:
        return Tensor._view_of(x, x.shape)
    pp = x._planar if isinstance(x, Tensor) else None
    if pp is not None:
        with tracing.trace_op('real', 'op;unary', tracing.tensor_args(x=x)) as tr:
            res = pp.re
            if tr:
                tr.result = res
        return Tensor._from_jax(res.reshape(x.shape))
    return _unary_op(x, None, 'real', K.real_c)


def imag(x: Tensor) -> Tensor:
    pp = x._planar if isinstance(x, Tensor) else None
    if pp is not None:
        with tracing.trace_op('imag', 'op;unary', tracing.tensor_args(x=x)) as tr:
            res = pp.im
            if tr:
                tr.result = res
        return Tensor._from_jax(res.reshape(x.shape))
    if x.dtype.is_real:
        # np.imag(real) == zeros (reference dsc.cpp:1596-1622)
        with tracing.trace_op('imag', 'op;unary', tracing.tensor_args(x=x)) as tr:
            res = jnp.zeros(x.shape, dtype=DTYPE_TO_NP[x.dtype])
            if tr:
                tr.result = res
        return Tensor._from_jax(res)
    return _unary_op(x, None, 'imag', K.imag_c)


def i0(x, dtype: Dtype = Dtype.F32) -> Tensor:
    x = _wrap(x, dtype)
    if x.dtype.is_complex:
        raise RuntimeError('i0 is defined for real tensors only')
    return _unary_op(x, None, 'i0', K.i0)


def clip(
    x: Tensor,
    x_min: Optional[float] = None,
    x_max: Optional[float] = None,
    out: Optional[Tensor] = None,
) -> Tensor:
    lo = x_min if x_min is not None else float('-inf')
    hi = x_max if x_max is not None else float('+inf')
    np_dt = DTYPE_TO_NP[x.dtype]
    if x.dtype.is_complex:
        lo = complex(lo, 0)
        hi = complex(hi, 0)
    args = tracing.tensor_args(x=x)
    lo_a = jax.device_put(np.asarray(lo, np_dt))
    hi_a = jax.device_put(np.asarray(hi, np_dt))
    with tracing.trace_op('clip', 'op;unary', args) as tr:
        res = K.clip(x.jax, lo_a, hi_a)
        if tr:
            tr.result = res
    return _finish(res, out)


# ---------------------------------------------------------------------------
# reductions (reference dsc.cpp:1771-1953; defaults axis=-1, keepdims=True
# per dsc.h:358-380)
# ---------------------------------------------------------------------------


def _reduce_op(x: Tensor, out, axis: int, keepdims: bool, name: str, fn) -> Tensor:
    nd = x.n_dim
    ax = axis + nd if axis < 0 else axis
    if ax < 0 or ax >= nd:
        raise RuntimeError(f'axis {axis} is out of bounds for a {nd}-D tensor')
    with tracing.trace_op(name, 'op;reduction', tracing.tensor_args(x=x)) as tr:
        res = fn(x.jax, ax, keepdims)
        if tr:
            tr.result = res
    if res.ndim == 0:
        # keepdims=False on 1-D input: the reference leaves this broken
        # ("Fixme", dsc.cpp:1798-1799); we return a 1-element 1-D tensor.
        res = res.reshape(1)
    return _finish(res, out)


def sum(x: Tensor, out=None, axis: int = -1, keepdims: bool = True) -> Tensor:
    return _reduce_op(x, out, axis, keepdims, 'sum', K.reduce_sum)


def mean(x: Tensor, out=None, axis: int = -1, keepdims: bool = True) -> Tensor:
    return _reduce_op(x, out, axis, keepdims, 'mean', K.reduce_mean)


def max(x: Tensor, out=None, axis: int = -1, keepdims: bool = True) -> Tensor:
    return _reduce_op(x, out, axis, keepdims, 'max', K.reduce_max)


def min(x: Tensor, out=None, axis: int = -1, keepdims: bool = True) -> Tensor:
    return _reduce_op(x, out, axis, keepdims, 'min', K.reduce_min)


# ---------------------------------------------------------------------------
# creation ops (reference dsc.cpp:403-534, tensor.py:615-681)
# ---------------------------------------------------------------------------


def from_numpy(x: np.ndarray) -> Tensor:
    dt = np_to_dtype(x.dtype)
    if x.ndim > DSC_MAX_DIMS or x.ndim < 1:
        raise RuntimeError(
            f'cannot create a Tensor with {x.ndim} dimensions, max is {DSC_MAX_DIMS}'
        )
    return Tensor._from_jax(jax.device_put(x))


def arange(n: int, dtype: Dtype = Dtype.F32) -> Tensor:
    with tracing.trace_op('arange', 'op;creation', {'n': n}) as tr:
        res = K.arange(n, DTYPE_TO_NP[dtype])
        if tr:
            tr.result = res
    return Tensor._from_jax(res)


def randn(*shape: int, dtype: Dtype = Dtype.F32) -> Tensor:
    if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
        shape = tuple(shape[0])
    _check_shape(shape)
    key = _get_ctx().next_key()
    with tracing.trace_op('randn', 'op;creation', {'shape': list(shape)}) as tr:
        res = K.randn(key, tuple(shape), DTYPE_TO_NP[dtype])
        if tr:
            tr.result = res
    return Tensor._from_jax(res)


def _check_shape(shape) -> None:
    if len(shape) > DSC_MAX_DIMS or len(shape) < 1:
        raise RuntimeError(
            f'cannot create a Tensor with {len(shape)} dimensions, '
            f'max is {DSC_MAX_DIMS}'
        )


def full(shape, fill_value: ScalarType, dtype: Dtype = Dtype.F32) -> Tensor:
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    _check_shape(shape)
    with tracing.trace_op('full', 'op;creation', {'shape': list(shape)}) as tr:
        res = K.full(shape, fill_value, DTYPE_TO_NP[dtype])
        if tr:
            tr.result = res
    return Tensor._from_jax(res)


def _like_dtype(x, dtype: Optional[Dtype]) -> Dtype:
    if dtype is not None:
        return dtype
    return x.dtype if isinstance(x, Tensor) else np_to_dtype(x.dtype)


def ones(shape, dtype: Dtype = Dtype.F32) -> Tensor:
    return full(shape, 1, dtype=dtype)


def ones_like(x, dtype: Optional[Dtype] = None) -> Tensor:
    return full(x.shape, 1, dtype=_like_dtype(x, dtype))


def zeros(shape, dtype: Dtype = Dtype.F32) -> Tensor:
    return full(shape, 0, dtype=dtype)


def zeros_like(x, dtype: Optional[Dtype] = None) -> Tensor:
    return full(x.shape, 0, dtype=_like_dtype(x, dtype))


def full_like(x, fill_value: ScalarType, dtype: Optional[Dtype] = None) -> Tensor:
    return full(x.shape, fill_value, dtype=_like_dtype(x, dtype))


def empty(shape, dtype: Dtype = Dtype.F32) -> Tensor:
    # Device memory can't be left uninitialized through XLA; zeros is the
    # deterministic equivalent.
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    _check_shape(shape)
    return full(shape, 0, dtype=dtype)


def empty_like(x, dtype: Optional[Dtype] = None) -> Tensor:
    return empty(x.shape, dtype=_like_dtype(x, dtype))


# ---------------------------------------------------------------------------
# layout ops (reference dsc.cpp:587-827)
# ---------------------------------------------------------------------------


def cast(x: Tensor, dtype: Dtype) -> Tensor:
    # Same-dtype cast returns a view of the input (reference dsc.cpp:587-590)
    if x.dtype == dtype:
        return Tensor._view_of(x, x.shape)
    with tracing.trace_op('cast', 'op;layout', tracing.tensor_args(x=x)) as tr:
        res = _astype(x.jax, dtype)
        if tr:
            tr.result = res
    return Tensor._from_jax(res)


def reshape(x: Tensor, *shape) -> Tensor:
    """Buffer-sharing view with -1 inference (reference dsc.cpp:599-636)."""
    if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
        shape = tuple(shape[0])
    if not all(isinstance(s, (int, np.integer)) for s in shape):
        raise RuntimeError(f'cannot reshape tensor with shape {shape}')
    shape = tuple(int(s) for s in shape)
    _check_shape(shape)
    known = 1
    n_infer = 0
    for s in shape:
        if s == -1:
            n_infer += 1
        elif s <= 0:
            raise RuntimeError(f'invalid reshape dimension {s}')
        else:
            known *= s
    if n_infer > 1:
        raise RuntimeError('can only infer one dimension in reshape')
    ne = x.ne
    if n_infer == 1:
        if ne % known != 0:
            raise RuntimeError(f'cannot reshape {x.shape} into {shape}')
        shape = tuple(ne // known if s == -1 else s for s in shape)
    elif known != ne:
        raise RuntimeError(f'cannot reshape {x.shape} into {shape}')
    return Tensor._view_of(x, shape)


def view(x: Tensor) -> Tensor:
    return Tensor._view_of(x, x.shape)


def concat(tensors: Sequence[Tensor], axis: Optional[int] = 0) -> Tensor:
    if not (
        isinstance(tensors, (tuple, list))
        and len(tensors) > 0
        and all(isinstance(t, Tensor) for t in tensors)
    ):
        raise RuntimeError(f'cannot concatenate tensors {tensors}')
    out_dtype = tensors[0].dtype
    for t in tensors[1:]:
        out_dtype = promote(out_dtype, t.dtype)
    arrays = tuple(
        t.jax if t.dtype == out_dtype else _astype(t.jax, out_dtype)
        for t in tensors
    )
    with tracing.trace_op('concat', 'op;layout', {'n': len(tensors)}) as tr:
        # axis=None flattens everything (reference dsc.cpp:665-746)
        res = K.concat(arrays, None if axis is None else int(axis))
        if tr:
            tr.result = res
    return Tensor._from_jax(res)


def transpose(x: Tensor, axes=None) -> Tensor:
    """Materializes a copy (reference dsc.cpp:764-827); 1-D transpose is a
    view."""
    if x.n_dim == 1:
        return Tensor._view_of(x, x.shape)
    if axes is not None and len(tuple(axes)) == 0:
        axes = None
    if axes is None:
        ax = tuple(reversed(range(x.n_dim)))
    else:
        ax = tuple(int(a) + x.n_dim if a < 0 else int(a) for a in axes)
        if sorted(ax) != list(range(x.n_dim)):
            raise RuntimeError(f'cannot transpose axes {axes}')
    with tracing.trace_op('transpose', 'op;layout', tracing.tensor_args(x=x)) as tr:
        res = K.transpose(x.jax, ax)
        if tr:
            tr.result = res
    return Tensor._from_jax(res)
