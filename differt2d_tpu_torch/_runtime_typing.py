"""Runtime type checks at the public entry points (counterpart of
``differt2d_tpu/_runtime_typing.py``).

The JAX package checks its public functions the way jaxtyping and beartype
check the reference's: a float where hard logic needs a boolean, an int
array where a float one is due, a string outside a ``Literal`` set, a
non-callable ``fun`` or a key of the wrong kind raise
:class:`TypeCheckError`, whose message holds ``"Expected type: <label>"``.
This module is the port's copy of that contract, on tensors:

* :class:`Spec` describes the values a parameter (or the return value)
  accepts: dtype kinds of tensors and arrays, plain Python types, a 0-d
  (scalar) constraint, a trailing axis of 2, a ``Literal`` set of strings,
  ``None``, or a predicate.
* The dtype kind of a tensor comes from its torch dtype: ``torch.bool`` is
  ``b``, the floating dtypes (``float16`` and ``bfloat16`` too) ``f``,
  signed integers ``i``, unsigned ``u``, complex ``c``.  NumPy arrays and
  Python scalars keep the JAX module's rules (``bool`` is not an ``int``
  where only ``int`` is listed).
* :func:`typecheck` wraps a function with those checks.  Inside
  ``torch.func.vmap`` a per-example tensor shows its per-example shape, and
  inside ``torch.func.grad``/``jvp`` the wrapped tensors keep their dtype,
  so the checks hold there as they hold at trace time in JAX.

Checks run at the public entry points only.  The package's own
per-operation calls (the eager tracer, ``ops/``, ``parallel/``, the
autograd Functions, the objects' methods) call the undecorated bodies,
:func:`unchecked` of the public function, so a map pays for one check of
its own arguments, not one per operation.

Checking is on by default; ``DIFFERT2D_TPU_DISABLE_TYPECHECK=1`` turns it
off for the process, :func:`set_typecheck` for the current thread and
:func:`no_typecheck` for a scope.

>>> from differt2d_tpu_torch.logic import is_true
>>> try:
...     is_true(0.5, approx=False)
... except TypeCheckError as e:
...     print("Expected type: Bool" in str(e))
True
"""

from __future__ import annotations

import functools
import inspect
import os
import threading
from typing import Any, Callable, Optional

import numpy as np
import torch

__all__ = (
    "BOOL_ARRAY",
    "CALLABLE",
    "FLOAT_ARRAY",
    "FLOAT_LIKE",
    "KEY_ARRAY",
    "OPT_BOOL",
    "OPT_CALLABLE",
    "OPT_KEY_ARRAY",
    "OPT_XY_ARRAY",
    "SCALAR_FLOAT",
    "SCALAR_INT",
    "SCALAR_INT_STRICT",
    "TRUTHY",
    "XY_ARRAY",
    "Spec",
    "TypeCheckError",
    "literal_spec",
    "no_typecheck",
    "set_typecheck",
    "typecheck",
    "unchecked",
)


class TypeCheckError(TypeError):
    """Raised when a runtime type check fails (jaxtyping's name)."""


_STATE = threading.local()

_DEFAULT_ENABLED = os.environ.get(
    "DIFFERT2D_TPU_DISABLE_TYPECHECK", ""
).lower() not in ("1", "true", "yes")


def _enabled() -> bool:
    return getattr(_STATE, "enabled", _DEFAULT_ENABLED)


def set_typecheck(enable: bool) -> None:
    """Enable or disable runtime type checking for the current thread."""
    _STATE.enabled = bool(enable)


class no_typecheck:  # noqa: N801 -- the JAX package's name
    """Context manager disabling runtime type checks in its scope.

    >>> from differt2d_tpu_torch.logic import is_true
    >>> with no_typecheck():
    ...     bool(is_true(1.0, approx=False))  # would raise otherwise
    True
    """

    def __enter__(self):
        self._saved = _enabled()
        set_typecheck(False)
        return self

    def __exit__(self, *exc):
        set_typecheck(self._saved)
        return False


def _torch_kind(dtype: torch.dtype) -> str:
    if dtype == torch.bool:
        return "b"
    if dtype.is_floating_point:
        return "f"
    if dtype.is_complex:
        return "c"
    return "i" if dtype.is_signed else "u"


def _dtype_kind(dtype: Any) -> str:
    """NumPy-style kind character of a torch or NumPy dtype ("" if neither)."""
    if isinstance(dtype, torch.dtype):
        return _torch_kind(dtype)
    try:
        return np.dtype(dtype).kind
    except TypeError:
        return ""


def _describe(value: Any) -> str:
    dtype = getattr(value, "dtype", None)
    if dtype is not None:
        kind = "tensor" if isinstance(value, torch.Tensor) else "array"
        return f"{kind}(dtype={dtype}, shape={tuple(getattr(value, 'shape', ()))})"
    return f"{type(value).__name__}({value!r})"


class Spec:
    """Accepted values of one parameter or of the return value.

    ``kinds`` are the dtype kinds (``'b'``, ``'f'``, ``'i'``, ``'u'``,
    ``'c'``) accepted for tensors and arrays; ``py_types`` the accepted plain
    Python types; ``scalar=True`` requires a 0-d tensor or array;
    ``last_dim`` a trailing axis of that size; ``literals`` makes the spec
    an exact set of strings; ``allow_none`` admits ``None``; ``predicate``
    replaces every other rule.
    """

    __slots__ = ("label", "kinds", "py_types", "scalar", "literals", "allow_none",
                 "predicate", "last_dim")

    def __init__(
        self,
        label: str,
        kinds: frozenset = frozenset(),
        py_types: tuple = (),
        scalar: bool = False,
        literals: Optional[frozenset] = None,
        allow_none: bool = False,
        predicate: Optional[Callable[[Any], bool]] = None,
        last_dim: Optional[int] = None,
    ):
        self.label = label
        self.kinds = frozenset(kinds)
        self.py_types = py_types
        self.scalar = scalar
        self.literals = literals
        self.allow_none = allow_none
        self.predicate = predicate
        self.last_dim = last_dim

    def _ok(self, value: Any) -> bool:
        if value is None:
            return self.allow_none
        if self.predicate is not None:
            return bool(self.predicate(value))
        if self.literals is not None:
            return isinstance(value, str) and value in self.literals
        if isinstance(value, torch.Tensor):
            kind, shape = _torch_kind(value.dtype), value.shape
        else:
            # Plain Python and NumPy scalars.  bool is an int subclass:
            # accept it only where bool is listed.
            if isinstance(value, (bool, np.bool_)):
                return bool in self.py_types or "b" in self.kinds
            if isinstance(value, (int, np.integer)):
                return int in self.py_types
            if isinstance(value, (float, np.floating)):
                return float in self.py_types
            dtype = getattr(value, "dtype", None)
            if dtype is None:
                return False
            kind, shape = _dtype_kind(dtype), getattr(value, "shape", None)
        if kind not in self.kinds:
            return False
        if self.last_dim is not None and (not shape or shape[-1] != self.last_dim):
            return False
        if self.scalar and shape is not None:
            return len(shape) == 0
        return True

    def check(self, where: str, name: str, value: Any) -> None:
        """Raise :class:`TypeCheckError` unless ``value`` is accepted."""
        if not self._ok(value):
            self.fail(where, name, value)

    def fail(self, where: str, name: str, value: Any) -> None:
        raise TypeCheckError(
            f"{where}: {name} — Expected type: {self.label}; got {_describe(value)}."
        )


BOOL_ARRAY = Spec("Bool[Tensor, ' *batch']", kinds=frozenset("b"), py_types=(bool,))
TRUTHY = Spec(
    "Union[Bool[Tensor, ' *batch'], Float[Tensor, ' *batch'], float, bool]",
    kinds=frozenset("bf"),
    py_types=(bool, float),
)
FLOAT_LIKE = Spec(
    "Union[Float[Tensor, ' *batch'], float]", kinds=frozenset("f"), py_types=(float,)
)
SCALAR_FLOAT = Spec(
    "Union[Float[Tensor, ''], float]", kinds=frozenset("f"), py_types=(float,), scalar=True
)
SCALAR_INT = Spec(
    "Union[Int[Tensor, ''], int]", kinds=frozenset("iu"), py_types=(int,), scalar=True
)
SCALAR_INT_STRICT = Spec("int", py_types=(int,))
OPT_BOOL = Spec("Optional[bool]", py_types=(bool,), allow_none=True)
XY_ARRAY = Spec("Float[Tensor, '... 2']", kinds=frozenset("f"), last_dim=2)
OPT_XY_ARRAY = Spec(
    "Optional[Float[Tensor, '... 2']]", kinds=frozenset("f"), last_dim=2, allow_none=True
)
FLOAT_ARRAY = Spec("Float[Tensor, '...']", kinds=frozenset("f"))


def _is_prng_key(value: Any) -> bool:
    """A raw key of :mod:`~differt2d_tpu_torch.prng`: an unsigned integer
    array or tensor (``prng.PRNGKey`` gives ``uint32[2]``)."""
    dtype = getattr(value, "dtype", None)
    return dtype is not None and _dtype_kind(dtype) == "u"


KEY_ARRAY = Spec("PRNGKeyArray", predicate=_is_prng_key)
OPT_KEY_ARRAY = Spec("Optional[PRNGKeyArray]", predicate=_is_prng_key, allow_none=True)
CALLABLE = Spec("Callable", predicate=callable)
OPT_CALLABLE = Spec("Optional[Callable]", predicate=callable, allow_none=True)


def literal_spec(*values: str) -> Spec:
    """Spec accepting exactly the given strings (``typing.Literal``)."""
    return Spec(f"Literal[{', '.join(map(repr, values))}]", literals=frozenset(values))


def typecheck(
    _fn: Optional[Callable] = None,
    *,
    ret: Optional[Spec] = None,
    **param_specs: Spec,
) -> Callable:
    """Decorator checking the named parameters and the return value.

    Parameters not named in ``param_specs`` are not checked.  Positional
    arguments are matched to names through the function's signature, read
    once at decoration time; a spec name that matches no parameter (and
    the function takes no ``**kwargs``) raises ``TypeError`` there.  The
    wrapper's ``__wrapped__`` is the body (:func:`unchecked`).
    """

    def deco(fn: Callable) -> Callable:
        sig = inspect.signature(fn)
        has_var_kw = any(p.kind is p.VAR_KEYWORD for p in sig.parameters.values())
        unknown = set(param_specs) - set(sig.parameters)
        if unknown and not has_var_kw:
            msg = (f"typecheck spec(s) {sorted(unknown)} match no parameter of"
                   f" {fn.__qualname__} — typo or renamed parameter?")
            raise TypeError(msg)
        positional = [p.name for p in sig.parameters.values()
                      if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
        pos_specs = [(i, name, param_specs[name]) for i, name in enumerate(positional)
                     if name in param_specs]
        where = f"{fn.__module__}.{fn.__qualname__}"

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not _enabled():
                return fn(*args, **kwargs)
            for i, name, spec in pos_specs:
                if i < len(args) and not spec._ok(args[i]):
                    spec.fail(where, f"parameter '{name}'", args[i])
            for name, value in kwargs.items():
                spec = param_specs.get(name)
                if spec is not None and not spec._ok(value):
                    spec.fail(where, f"parameter '{name}'", value)
            result = fn(*args, **kwargs)
            if ret is not None and not ret._ok(result):
                ret.fail(where, "return value", result)
            return result

        wrapper.__typechecked__ = True
        return wrapper

    if _fn is not None:
        return deco(_fn)
    return deco


def unchecked(fn: Callable) -> Callable:
    """The body of a function decorated by :func:`typecheck`, else ``fn``
    itself: what the package's own per-operation calls run."""
    return fn.__wrapped__ if getattr(fn, "__typechecked__", False) else fn
