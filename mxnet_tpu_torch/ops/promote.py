"""The JAX package's result dtypes, decided in one place.

The JAX package runs with 64-bit types on (mxnet_tpu/__init__.py:34) and
promotes as ``jax.numpy`` does. Where torch decides otherwise, the
elementwise functions of ``mx.np``, ``mx.nd`` and the NDArray operators go
through the helpers here:

* :func:`result_dtype`: two arrays promote as torch promotes them (the two
  lattices agree on bool, the ints and the floats); a Python int or float
  is weak: it takes the array's dtype where that is of its kind or wider,
  and the 64-bit default (int64, float64) where it is not. So an int or
  bool array with a Python float computes in float64, and a bool array
  with a Python int in int64;
* :func:`inexact`: what a float function makes of an int or bool input:
  float64 from a 64-bit int, float32 from anything narrower;
* :func:`binary`: a binary function of a given kind (``same``,
  ``numeric``, ``power``, ``inexact``) over tensors and Python scalars,
  with the tensors cast to the result dtype before torch sees them;
* :func:`product`, :func:`set_fn`, :func:`inexact_args`: products, set
  functions and statistics over operands of two dtypes or of bool, which
  torch refuses (two bools give a bool product and bool set values; cov,
  corrcoef and trapezoid compute in the inexact dtype).

Integer ``floor_divide``, ``mod``, ``remainder`` and ``fmod`` by a zero
element return the JAX package's values on the CPU and on the card alike,
instead of raising (torch's CPU kernels) or returning what the card's
integer unit gives: ``x // 0`` is -1 where x is 0 and -2 elsewhere for
signed types, the type's largest value for unsigned ones, and
``x % 0`` is 0. A float ``x // 0`` is nan, as in the JAX package.

``fmod`` of two bools is the exception: ``jnp.fmod`` puts 1 in place of a
zero divisor only when the operands' promoted type is an integer type, and
bool is not one, so two bools reach ``lax.rem`` as int32 with the zero left
in place, and ``lax.rem``'s ``x % 0`` is ``x``: ``fmod(True, False)`` is 1,
``fmod(x, True)`` is 0. ``mod``, ``remainder`` and ``floor_divide``
promote to int32 before they test the divisor, so two bools take the
integer forms above. Where a bool or int input meets a function the JAX
package refuses for it (``rsqrt`` and ``sigmoid`` take floats only;
``sign`` and ``log_sigmoid`` no bool), :func:`float_only` and
:func:`no_bool` raise ``TypeError`` naming the dtype, as it does.
"""
from __future__ import annotations

import numpy as _np
import torch

__all__ = ["is_weak", "result_dtype", "inexact_dtype", "inexact",
           "numeric_dtype", "bool_same", "default_float", "float_fn",
           "float_only", "no_bool", "relu", "binary", "divmod_pair", "KINDS",
           "product", "set_fn", "inexact_args"]


def is_weak(x):
    """A Python int or float: a weak type (a bool, a numpy scalar or an
    array is strong)."""
    return isinstance(x, (int, float)) and not isinstance(
        x, (bool, _np.generic))


def _strong_dtype(x):
    if isinstance(x, torch.Tensor):
        return x.dtype
    if isinstance(x, (bool, _np.bool_)):
        return torch.bool
    return torch.from_numpy(_np.asarray(x)).dtype


def result_dtype(*operands):
    """The dtype the JAX package gives an elementwise function of
    ``operands`` (tensors and Python scalars)."""
    dt = None
    for x in operands:
        if not is_weak(x):
            d = _strong_dtype(x)
            dt = d if dt is None else torch.promote_types(dt, d)
    for x in operands:
        if not is_weak(x):
            continue
        if isinstance(x, float):
            if dt is None or not (dt.is_floating_point or dt.is_complex):
                dt = torch.float64
        elif dt is None or dt == torch.bool:
            dt = torch.int64
    return dt


def inexact_dtype(dt):
    """The float dtype a float function computes an input of ``dt`` in."""
    if dt.is_floating_point or dt.is_complex:
        return dt
    return torch.float64 if dt in (torch.int64, torch.uint64) \
        else torch.float32


def inexact(x):
    """``x`` in :func:`inexact_dtype` of its dtype."""
    dt = inexact_dtype(x.dtype)
    return x if x.dtype == dt else x.to(dt)


def numeric_dtype(dt):
    """bool counts as int32 where the JAX package needs numbers (floor
    division, remainders, powers, shifts, squares)."""
    return torch.int32 if dt == torch.bool else dt


def bool_same(fn):
    """``fn`` that returns a bool input as it is (abs, ceil, floor, trunc
    of a bool array are that array in the JAX package)."""
    def wrapped(x):
        return x.clone() if x.dtype == torch.bool else fn(x)
    wrapped.__name__ = getattr(fn, "__name__", "bool_same")
    return wrapped


def default_float(fn):
    """``fn`` of a float input; an int or bool input becomes float64, the
    JAX package's default float (rint, angle)."""
    def wrapped(x):
        return fn(x if x.is_floating_point() or x.is_complex()
                  else x.to(torch.float64))
    wrapped.__name__ = getattr(fn, "__name__", "default_float")
    return wrapped


def float_fn(fn):
    """``fn`` applied to its input in :func:`inexact_dtype`."""
    def wrapped(x, *args, **kwargs):
        return fn(inexact(x), *args, **kwargs)
    wrapped.__name__ = getattr(fn, "__name__", "float_fn")
    return wrapped


def _refuse(name, dt, accepted):
    return TypeError(f"{name} does not accept dtype "
                     f"{str(dt).removeprefix('torch.')}. Accepted dtypes are "
                     f"subtypes of {accepted}.")


def float_only(fn, name):
    """``fn`` of a float or complex input; an int or bool input raises
    ``TypeError``, as ``lax.rsqrt`` and ``lax.logistic`` do."""
    def wrapped(x, *args, **kwargs):
        if not (x.is_floating_point() or x.is_complex()):
            raise _refuse(name, x.dtype, "floating, complexfloating")
        return fn(x, *args, **kwargs)
    wrapped.__name__ = name
    return wrapped


def no_bool(fn, name):
    """``fn`` of a number; a bool input raises ``TypeError``, as
    ``jnp.sign`` and the negation inside ``jax.nn.log_sigmoid`` do."""
    def wrapped(x, *args, **kwargs):
        if x.dtype == torch.bool:
            raise _refuse(name, x.dtype,
                          "integer, floating, complexfloating")
        return fn(x, *args, **kwargs)
    wrapped.__name__ = name
    return wrapped


def relu(x):
    """``jax.nn.relu``: ``maximum(x, 0)`` with a weak 0, so a bool input
    gives int64; any other input keeps its dtype through ``torch.relu``,
    whose gradient at 0 is 0 like ``jax.nn.relu``'s."""
    if x.dtype == torch.bool:
        return binary(torch.maximum)(x, 0)
    return torch.relu(x)


def _cast(x, dt):
    if isinstance(x, torch.Tensor):
        return x if x.dtype == dt else x.to(dt)
    return torch.tensor(x, dtype=dt)


def product(fn):
    """``fn(a, b)``, a product (dot, vdot, inner, matmul, tensordot), with
    the operands in their :func:`result_dtype`. Two bools give a bool, True
    where any pair of Trues meets, as ``jnp.dot`` gives: the sum of the 0/1
    products in float32, tested ``> 0`` (exact: no term is negative)."""
    def wrapped(a, b, *args, **kwargs):
        dt = result_dtype(a, b)
        if dt == torch.bool:
            return fn(_cast(a, torch.float32), _cast(b, torch.float32),
                      *args, **kwargs) > 0
        return fn(_cast(a, dt), _cast(b, dt), *args, **kwargs)
    wrapped.__name__ = getattr(fn, "__name__", "product")
    return wrapped


def set_fn(fn):
    """``fn(a, b)``, a set function (isin, in1d, intersect1d, setdiff1d,
    setxor1d), with the operands in their :func:`result_dtype`; torch's
    refuse bool, so two bools compute as uint8 and values come back bool."""
    def wrapped(a, b, *args, **kwargs):
        dt = result_dtype(a, b)
        work = torch.uint8 if dt == torch.bool else dt
        out = fn(_cast(a, work), _cast(b, work), *args, **kwargs)
        return out.to(torch.bool) if out.dtype == torch.uint8 \
            and dt == torch.bool else out
    wrapped.__name__ = getattr(fn, "__name__", "set_fn")
    return wrapped


def inexact_args(fn):
    """``fn`` with its tensor arguments in :func:`inexact_dtype` of their
    :func:`result_dtype` (cov, corrcoef and trapezoid of ints and bools)."""
    def wrapped(*args, **kwargs):
        tensors = [a for a in (*args, *kwargs.values())
                   if isinstance(a, torch.Tensor)]
        dt = inexact_dtype(result_dtype(*tensors))
        args = [_cast(a, dt) if isinstance(a, torch.Tensor) else a
                for a in args]
        kwargs = {k: _cast(v, dt) if isinstance(v, torch.Tensor) else v
                  for k, v in kwargs.items()}
        return fn(*args, **kwargs)
    wrapped.__name__ = getattr(fn, "__name__", "inexact_args")
    return wrapped


def _host_value(b):
    """The value of a divisor that torch reads on the host (a 0-dim CPU
    tensor, as :func:`binary` makes of a Python scalar), else None."""
    return b.item() if b.dim() == 0 and b.device.type == "cpu" else None


def _first(a, b):
    """The dividend of a zero-safe integer function as a tensor on the
    divisor's device (a reflected scalar arrives as a 0-dim CPU tensor)."""
    if a.device != b.device:
        return torch.full((), a.item(), dtype=a.dtype, device=b.device)
    return a


def _by_zero(a):
    """``a // 0`` in the JAX package (module note)."""
    if a.dtype.is_signed:
        return -1 - (a != 0).to(a.dtype)
    return torch.full_like(a, torch.iinfo(a.dtype).max)


def _int_floor_divide(a, b):
    v = _host_value(b)
    if v is not None:
        return torch.floor_divide(a, b) if v else _by_zero(a)
    a = _first(a, b)
    zero = b == 0
    return torch.where(zero, _by_zero(a),
                       torch.floor_divide(a, torch.where(zero, 1, b)))


def _int_remainder(fn):
    def rem(a, b):
        v = _host_value(b)
        if v is not None:
            return fn(a, b) if v else torch.zeros_like(a)
        zero = b == 0
        return torch.where(zero, 0, fn(_first(a, b), torch.where(zero, 1, b)))
    return rem


def _floor_divide(a, b):
    if not a.is_floating_point():
        return _int_floor_divide(a, b)
    v = _host_value(b)
    if v is not None:
        return torch.floor_divide(a, b) if v else torch.full_like(
            a, float("nan"))
    return torch.where(b == 0, float("nan"), torch.floor_divide(a, b))


def _zero_safe(fn):
    """A remainder over tensors of one dtype: 0 where an integer divisor
    is 0 (floats keep torch's nan)."""
    int_fn = _int_remainder(fn)

    def rem(a, b):
        return fn(a, b) if a.is_floating_point() else int_fn(a, b)
    rem.__name__ = fn.__name__
    return rem


def _bool_fmod(a, b):
    """``fmod`` of two bools cast to int32: ``x % 0`` is ``x`` (module
    note), ``x % 1`` is 0."""
    return a * (b == 0)


def divmod_pair(a, b):
    """``(a // b, a % b)`` over tensors of one dtype, zero-safe."""
    return _floor_divide(a, b), _zero_safe(torch.remainder)(a, b)


#: kind -> what the result dtype of the promoted operands becomes
KINDS = {
    "same": lambda dt: dt,
    "numeric": numeric_dtype,
    "inexact": inexact_dtype,
}

#: the functions whose zero divisor needs the zero-safe integer forms
SAFE = {torch.floor_divide: _floor_divide,
        torch.remainder: _zero_safe(torch.remainder),
        torch.fmod: _zero_safe(torch.fmod)}


def binary(fn, kind="same"):
    """``fn(a, b)`` over tensors of one dtype, made a function of tensors
    and Python scalars that returns the JAX package's dtype: the operands
    promote (:func:`result_dtype`), the kind maps the promoted dtype to the
    one the function computes in (``same``; ``numeric``: bool becomes
    int32; ``inexact``: ints become floats), and the tensors are cast to
    it. A Python scalar becomes a 0-dim CPU tensor of that dtype, which
    torch reads on the host beside a tensor on the card: ``x * 2.0`` is
    one launch, with no fill and no copy. ``power`` with a Python int
    exponent keeps the base's dtype (bool: int32), as ``jnp.power``'s
    integer power does. Integer division and remainders by a zero element
    give the JAX package's values, ``fmod`` of two bools its own (module
    note)."""
    bool_fn = _bool_fmod if fn is torch.fmod else None
    fn = SAFE.get(fn, fn)
    to = KINDS["numeric" if kind == "power" else kind]

    def wrapped(a, b, *args, **kwargs):
        if kind == "power" and isinstance(a, torch.Tensor) and isinstance(
                b, int) and not isinstance(b, _np.generic):
            return fn(a.to(numeric_dtype(a.dtype)), int(b))
        dt = result_dtype(a, b)
        if bool_fn is not None and dt == torch.bool:
            return bool_fn(_cast(a, torch.int32), _cast(b, torch.int32))
        dt = to(dt)
        return fn(_cast(a, dt), _cast(b, dt), *args, **kwargs)

    wrapped.__name__ = getattr(fn, "__name__", "binary")
    return wrapped
