"""Position-dependent parameters.

A :class:`Parameter` wraps a user function ``f(x, y[, z], **kwargs)`` and can
be combined with other Parameters and real numbers using ``+ - * / **``,
yielding :class:`CompositeParameter` expression trees that evaluate lazily at
given coordinates.  This mirrors the public contract of the reference package
(``superscreen/parameter.py:65-339``) while using its own machinery:
``inspect.signature``-based argument classification and a symbol-keyed
operator table.

Wrapped functions may consume/return numpy arrays (the default, used for
host-side applied-field evaluation) and the evaluation path does not inspect
values, so numeric array-likes flow through untouched.
"""

import inspect
import numbers
from typing import Callable, Optional, Union

import numpy as np

__all__ = ["Parameter", "CompositeParameter", "Constant", "function_repr"]


def function_repr(func: Callable, argspec=None) -> str:
    """Renders ``func`` as a readable ``name(signature)`` string.

    API-parity helper (reference ``superscreen/parameter.py:30-62``) built on
    :func:`inspect.signature` instead of ``getfullargspec``: each parameter is
    formatted by its own :class:`inspect.Parameter` (which already handles
    defaults, ``*args``/``**kwargs`` markers, and keyword-only separators).

    Args:
        func: The function to describe.
        argspec: Optional pre-computed ``inspect.FullArgSpec``-like object;
            when given, a signature is reconstructed from it instead of
            re-inspecting ``func``.

    Returns:
        ``"name(arg, kwarg=default, ...)"``.
    """
    if argspec is None:
        try:
            sig = inspect.signature(func)
        except (TypeError, ValueError):
            return f"{getattr(func, '__name__', repr(func))}(...)"
    else:
        P = inspect.Parameter
        params = []
        defaults = list(argspec.defaults or ())
        n_plain = len(argspec.args) - len(defaults)
        for i, name in enumerate(argspec.args):
            default = defaults[i - n_plain] if i >= n_plain else P.empty
            params.append(P(name, P.POSITIONAL_OR_KEYWORD, default=default))
        if argspec.varargs:
            params.append(P(argspec.varargs, P.VAR_POSITIONAL))
        kw_defaults = argspec.kwonlydefaults or {}
        for name in argspec.kwonlyargs or ():
            params.append(
                P(name, P.KEYWORD_ONLY, default=kw_defaults.get(name, P.empty))
            )
        if argspec.varkw:
            params.append(P(argspec.varkw, P.VAR_KEYWORD))
        sig = inspect.Signature(params)
    rendered = ", ".join(str(p) for p in sig.parameters.values())
    return f"{func.__name__}({rendered})"

# Binary operations supported between parameter expressions, keyed by the
# symbol used in reprs.  Callables from the ``operator`` module are accepted
# as aliases for backward compatibility with the reference API.
_OP_TABLE = {
    "+": lambda a, b: a + b,
    "-": lambda a, b: a - b,
    "*": lambda a, b: a * b,
    "/": lambda a, b: a / b,
    "**": lambda a, b: a**b,
}


def _op_symbol(op) -> str:
    """Normalize an operator spec (symbol string or stdlib callable) to a symbol."""
    import operator as _stdlib_operator

    aliases = {
        _stdlib_operator.add: "+",
        _stdlib_operator.sub: "-",
        _stdlib_operator.mul: "*",
        _stdlib_operator.truediv: "/",
        _stdlib_operator.pow: "**",
    }
    if isinstance(op, str):
        symbol = op.strip()
    else:
        symbol = aliases.get(op)
    if symbol not in _OP_TABLE:
        raise ValueError(
            f"Unsupported operator {op!r}; expected one of {sorted(_OP_TABLE)}."
        )
    return symbol


def _classify_signature(func: Callable):
    """Split ``func``'s signature into coordinate args, bound defaults, and
    the set of names that may be overridden by keyword.

    Returns ``(takes_z, defaults, overridable, accepts_any_kwarg)``.
    Raises ``ValueError`` if the signature does not start with ``x, y``
    (optionally followed by ``z``) or has required non-coordinate positional
    arguments.
    """
    sig = inspect.signature(func)
    params = list(sig.parameters.values())
    positional_kinds = (
        inspect.Parameter.POSITIONAL_ONLY,
        inspect.Parameter.POSITIONAL_OR_KEYWORD,
    )
    positional = [p.name for p in params if p.kind in positional_kinds]
    if positional[:2] != ["x", "y"]:
        raise ValueError(
            f"Parameter functions must accept x and y as their first two "
            f"arguments; got signature {func.__name__}{sig}."
        )
    takes_z = "z" in sig.parameters
    n_coords = 2
    if takes_z:
        if len(positional) < 3 or positional[2] != "z":
            raise ValueError(
                f"If a parameter function accepts z, it must be the third "
                f"positional argument; got signature {func.__name__}{sig}."
            )
        n_coords = 3
    defaults = {}
    overridable = set()
    accepts_any = False
    for p in params:
        if p.name in ("x", "y", "z"):
            continue
        if p.kind == inspect.Parameter.VAR_KEYWORD:
            accepts_any = True
            continue
        if p.kind == inspect.Parameter.VAR_POSITIONAL:
            continue
        if p.kind in positional_kinds and p.default is inspect.Parameter.empty:
            raise ValueError(
                f"Parameter function argument {p.name!r} must be a keyword "
                f"argument (all non-coordinate arguments require defaults)."
            )
        overridable.add(p.name)
        if p.default is not inspect.Parameter.empty:
            defaults[p.name] = p.default
    return takes_z, defaults, overridable, accepts_any


def _coerce_coord(value):
    """Bring a coordinate input to the canonical 1D form used for evaluation."""
    return np.atleast_1d(np.squeeze(value))


def _values_equal(a, b) -> bool:
    """Tolerant equality for bound keyword values (handles arrays)."""
    try:
        return bool(np.all(np.asarray(a) == np.asarray(b)))
    except Exception:
        try:
            return bool(a == b)
        except Exception:
            return False


class Parameter:
    """A callable ``f(x, y[, z])`` representing a physical quantity that
    varies with position.

    Arithmetic (``+ - * / **``) with other Parameters or real numbers builds
    a lazy :class:`CompositeParameter` expression tree.

    Args:
        func: Function evaluating the parameter.  Must take ``x, y`` (and
            optionally ``z`` third) positionally; every other argument must
            have a default or be keyword-only.
        kwargs: Values bound to ``func``'s keyword arguments for every
            evaluation.
    """

    def __init__(self, func: Callable, **kwargs):
        takes_z, defaults, overridable, accepts_any = _classify_signature(func)
        if not accepts_any:
            unknown = set(kwargs) - overridable
            if unknown:
                raise ValueError(
                    f"Unknown keyword argument(s) {sorted(unknown)!r} for "
                    f"parameter function {func.__name__}."
                )
        bound = dict(defaults)
        bound.update(kwargs)
        self.func = func
        self.kwargs = bound

    def _evaluate(self, x, y, z):
        """Expression-node protocol: evaluate at already-coerced coordinates."""
        call_kwargs = dict(self.kwargs)
        if z is not None:
            call_kwargs["z"] = z
        return self.func(x, y, **call_kwargs)

    def __call__(
        self,
        x: Union[int, float, np.ndarray],
        y: Union[int, float, np.ndarray],
        z: Optional[Union[int, float, np.ndarray]] = None,
    ):
        x = _coerce_coord(x)
        y = _coerce_coord(y)
        if z is not None:
            z = _coerce_coord(z)
        out = np.asarray(self._evaluate(x, y, z)).squeeze()
        return out.item() if out.ndim == 0 else out

    def _describe(self) -> str:
        """Render this node for use inside a repr."""
        bound = ", ".join(f"{k}={v!r}" for k, v in self.kwargs.items())
        coords = "x, y" + (", z" if "z" in inspect.signature(self.func).parameters else "")
        inner = coords if not bound else f"{coords}, {bound}"
        return f"{self.func.__name__}({inner})"

    def __repr__(self) -> str:
        return f"{type(self).__name__}<{self._describe()}>"

    def __eq__(self, other) -> bool:
        if self is other:
            return True
        if type(other) is not type(self):
            return NotImplemented
        if self.func.__code__ != other.func.__code__:
            return False
        if set(self.kwargs) != set(other.kwargs):
            return False
        return all(_values_equal(v, other.kwargs[k]) for k, v in self.kwargs.items())

    # -- operator overloads ------------------------------------------------
    def __add__(self, other):
        return CompositeParameter(self, other, "+")

    def __radd__(self, other):
        return CompositeParameter(other, self, "+")

    def __sub__(self, other):
        return CompositeParameter(self, other, "-")

    def __rsub__(self, other):
        return CompositeParameter(other, self, "-")

    def __mul__(self, other):
        return CompositeParameter(self, other, "*")

    def __rmul__(self, other):
        return CompositeParameter(other, self, "*")

    def __truediv__(self, other):
        return CompositeParameter(self, other, "/")

    def __rtruediv__(self, other):
        return CompositeParameter(other, self, "/")

    def __pow__(self, other):
        return CompositeParameter(self, other, "**")

    def __rpow__(self, other):
        return CompositeParameter(other, self, "**")


class CompositeParameter(Parameter):
    """An interior node of a parameter expression tree: ``left <op> right``
    where each operand is a number, :class:`Parameter`, or another
    CompositeParameter.
    """

    # Kept for API compatibility with code that introspects valid operators.
    VALID_OPERATORS = tuple(_OP_TABLE)

    def __init__(self, left, right, op):
        for name, operand in (("left", left), ("right", right)):
            if not isinstance(operand, (numbers.Real, Parameter)):
                raise TypeError(
                    f"CompositeParameter {name} operand must be a real number "
                    f"or Parameter, not {type(operand).__name__}."
                )
        if not (isinstance(left, Parameter) or isinstance(right, Parameter)):
            raise TypeError(
                "At least one CompositeParameter operand must be a Parameter."
            )
        self.left = left
        self.right = right
        self.operator = _op_symbol(op)

    def _evaluate(self, x, y, z):
        def branch(node):
            if isinstance(node, Parameter):
                return node._evaluate(x, y, z)
            return node  # plain number

        return _OP_TABLE[self.operator](branch(self.left), branch(self.right))

    def __call__(self, x, y, z=None):
        x = _coerce_coord(x)
        y = _coerce_coord(y)
        if z is not None:
            z = _coerce_coord(z)
        return self._evaluate(x, y, z)

    def _describe(self) -> str:
        def side(node):
            return node._describe() if isinstance(node, Parameter) else repr(node)

        return f"({side(self.left)} {self.operator} {side(self.right)})"

    def __repr__(self) -> str:
        return f"{type(self).__name__}<{self._describe()}>"

    def __eq__(self, other) -> bool:
        if self is other:
            return True
        if type(other) is not type(self):
            return NotImplemented
        return (
            self.operator == other.operator
            and self.left == other.left
            and self.right == other.right
        )


def _constant_2d(x, y, value=0.0):
    return np.full(np.shape(np.asarray(x, dtype=float)), value, dtype=float)


def _constant_3d(x, y, z, value=0.0):
    return np.full(np.shape(np.asarray(x, dtype=float)), value, dtype=float)


class Constant(Parameter):
    """A position-independent :class:`Parameter` (returns ``value`` everywhere).

    Args:
        value: The constant value.
        dimensions: 2 for ``f(x, y)``, 3 for ``f(x, y, z)``.
    """

    def __init__(self, value, dimensions: int = 2):
        if dimensions == 2:
            base = _constant_2d
        elif dimensions == 3:
            base = _constant_3d
        else:
            raise ValueError(f"dimensions must be 2 or 3, got {dimensions}.")
        super().__init__(base, value=value)
