"""Self-contained physical units system.

A minimal, dependency-free replacement for the ``pint`` unit registry used by
the reference implementation (``superscreen/units.py:1-3`` and pervasively via
``Device.ureg``).  Only the quantities relevant to thin-film magnetostatics are
supported: length, current, magnetic field H [A/m], flux density B [T], flux
[Wb / Phi_0], inductance [H], magnetic moment [A*m^2], plus the physical
constants ``mu_0``, ``Phi_0``, ``mu_B``, ``h`` and ``e``.

Quantities are kept strictly on the host (plain Python / NumPy); all unit
conversion happens once at the API boundary, so nothing in this module ever
enters a jitted computation.
"""

from __future__ import annotations

import math
import re
from typing import Dict, Tuple, Union

import numpy as np

__all__ = [
    "ureg",
    "UnitRegistry",
    "Quantity",
    "Unit",
    "DimensionalityError",
    "UndefinedUnitError",
]

# Dimension vector: exponents of (length, mass, time, current).
Dim = Tuple[float, float, float, float]

_DIMENSIONLESS: Dim = (0.0, 0.0, 0.0, 0.0)

_DIM_NAMES = ("[length]", "[mass]", "[time]", "[current]")


class DimensionalityError(ValueError):
    """Raised when converting between incompatible dimensionalities."""

    def __init__(self, src, dst, msg=None):
        self.src = src
        self.dst = dst
        super().__init__(
            msg or f"Cannot convert from {src!r} to {dst!r}: incompatible dimensions."
        )


class UndefinedUnitError(ValueError):
    """Raised when a unit name cannot be resolved."""


def _dim_add(a: Dim, b: Dim) -> Dim:
    return tuple(x + y for x, y in zip(a, b))


def _dim_sub(a: Dim, b: Dim) -> Dim:
    return tuple(x - y for x, y in zip(a, b))


def _dim_mul(a: Dim, k: float) -> Dim:
    return tuple(x * k for x in a)


# ---------------------------------------------------------------------------
# Base unit table: name -> (SI factor, dimension vector, prefixable)
# ---------------------------------------------------------------------------

_PI = math.pi

_UNIT_TABLE: Dict[str, Tuple[float, Dim, bool]] = {
    # length
    "m": (1.0, (1, 0, 0, 0), True),
    "meter": (1.0, (1, 0, 0, 0), False),
    "inch": (0.0254, (1, 0, 0, 0), False),
    # mass
    "kg": (1.0, (0, 1, 0, 0), False),
    "g": (1e-3, (0, 1, 0, 0), True),
    # time
    "s": (1.0, (0, 0, 1, 0), True),
    "second": (1.0, (0, 0, 1, 0), False),
    # current
    "A": (1.0, (0, 0, 0, 1), True),
    "amp": (1.0, (0, 0, 0, 1), False),
    "ampere": (1.0, (0, 0, 0, 1), False),
    # flux density B: T = kg / (A s^2)
    "T": (1.0, (0, 1, -2, -1), True),
    "tesla": (1.0, (0, 1, -2, -1), False),
    "G": (1e-4, (0, 1, -2, -1), True),
    "gauss": (1e-4, (0, 1, -2, -1), False),
    # magnetic field H: A / m
    "Oe": (1e3 / (4 * _PI), (-1, 0, 0, 1), True),
    "oersted": (1e3 / (4 * _PI), (-1, 0, 0, 1), False),
    # flux: Wb = T m^2
    "Wb": (1.0, (2, 1, -2, -1), True),
    "weber": (1.0, (2, 1, -2, -1), False),
    # inductance: H = Wb / A
    "H": (1.0, (2, 1, -2, -2), True),
    "henry": (1.0, (2, 1, -2, -2), False),
    # energy (occasionally useful)
    "J": (1.0, (2, 1, -2, 0), True),
    "eV": (1.602176634e-19, (2, 1, -2, 0), True),
    # force: N = kg m / s^2
    "N": (1.0, (1, 1, -2, 0), True),
    "newton": (1.0, (1, 1, -2, 0), False),
    # dimensionless helpers
    "dimensionless": (1.0, _DIMENSIONLESS, False),
    "pi": (_PI, _DIMENSIONLESS, False),
    # physical constants (CODATA 2018 exact where defined)
    # magnetic constant mu_0 [H / m]
    "mu_0": (1.25663706212e-06, (1, 1, -2, -2), False),
    "mu0": (1.25663706212e-06, (1, 1, -2, -2), False),
    "vacuum_permeability": (1.25663706212e-06, (1, 1, -2, -2), False),
    # flux quantum Phi_0 = h / (2 e) [Wb]; prefixable like pint's
    # (mPhi_0/uPhi_0 readouts are standard in scanning-SQUID work)
    "Phi_0": (2.067833848461929e-15, (2, 1, -2, -1), True),
    "Phi0": (2.067833848461929e-15, (2, 1, -2, -1), True),
    # Bohr magneton [A m^2]
    "mu_B": (9.2740100783e-24, (2, 0, 0, 1), False),
    "bohr_magneton": (9.2740100783e-24, (2, 0, 0, 1), False),
    # Planck constant [J s]
    "h_planck": (6.62607015e-34, (2, 1, -1, 0), False),
    # elementary charge [A s]
    "e": (1.602176634e-19, (0, 0, 1, 1), False),
}

_PREFIXES: Dict[str, float] = {
    "f": 1e-15,
    "p": 1e-12,
    "n": 1e-9,
    "u": 1e-6,
    "µ": 1e-6,
    "μ": 1e-6,  # greek mu
    "m": 1e-3,
    "c": 1e-2,
    "d": 1e-1,
    "k": 1e3,
    "M": 1e6,
    "G": 1e9,
}


def _resolve_name(name: str) -> Tuple[float, Dim]:
    """Resolve a unit name (with optional SI prefix) to (SI factor, dims)."""
    if name in _UNIT_TABLE:
        factor, dims, _ = _UNIT_TABLE[name]
        return factor, dims
    # Try prefix + base unit (exact-match takes precedence above).
    for plen in (1,):
        prefix, rest = name[:plen], name[plen:]
        if prefix in _PREFIXES and rest in _UNIT_TABLE:
            factor, dims, prefixable = _UNIT_TABLE[rest]
            if prefixable:
                return factor * _PREFIXES[prefix], dims
    raise UndefinedUnitError(f"Unknown unit: {name!r}.")


# ---------------------------------------------------------------------------
# Expression parsing: numbers, names, * / ** ( ), whitespace = multiplication
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"\s*(?:"
    r"(?P<number>[+-]?\d+(?:\.\d*)?(?:[eE][+-]?\d+)?)"
    r"|(?P<name>[A-Za-z_µμ][A-Za-z0-9_]*)"
    r"|(?P<pow>\*\*|\^)"
    r"|(?P<op>[*/()])"
    r")"
)


def _tokenize(expr: str):
    pos = 0
    tokens = []
    while pos < len(expr):
        m = _TOKEN_RE.match(expr, pos)
        if m is None:
            if expr[pos:].strip() == "":
                break
            raise UndefinedUnitError(f"Cannot parse unit expression: {expr!r}.")
        pos = m.end()
        if m.lastgroup == "number":
            tokens.append(("num", float(m.group("number"))))
        elif m.lastgroup == "name":
            tokens.append(("name", m.group("name")))
        elif m.lastgroup == "pow":
            tokens.append(("op", "**"))
        else:
            tokens.append(("op", m.group("op")))
    return tokens


class _Parser:
    """Recursive-descent parser producing (factor, dims, units_container)."""

    def __init__(self, tokens):
        self.tokens = tokens
        self.pos = 0

    def peek(self):
        return self.tokens[self.pos] if self.pos < len(self.tokens) else (None, None)

    def next(self):
        tok = self.peek()
        self.pos += 1
        return tok

    def parse(self):
        result = self.expr()
        if self.pos != len(self.tokens):
            raise UndefinedUnitError("Trailing tokens in unit expression.")
        return result

    def expr(self):
        factor, dims, units = self.term()
        while True:
            kind, val = self.peek()
            if kind == "op" and val == "*":
                self.next()
                f2, d2, u2 = self.term()
                factor *= f2
                dims = _dim_add(dims, d2)
                units = _merge_units(units, u2, +1)
            elif kind == "op" and val == "/":
                self.next()
                f2, d2, u2 = self.term()
                factor /= f2
                dims = _dim_sub(dims, d2)
                units = _merge_units(units, u2, -1)
            elif kind in ("num", "name") or (kind == "op" and val == "("):
                # implicit multiplication, e.g. "1 mA" or "uA um"
                f2, d2, u2 = self.term()
                factor *= f2
                dims = _dim_add(dims, d2)
                units = _merge_units(units, u2, +1)
            else:
                break
        return factor, dims, units

    def term(self):
        factor, dims, units = self.factor()
        kind, val = self.peek()
        if kind == "op" and val == "**":
            self.next()
            k2, v2 = self.next()
            sign = 1.0
            if k2 == "op" and v2 == "(":
                # e.g. **(-2)
                k2, v2 = self.next()
                if k2 == "num":
                    sign = 1.0
                exp = v2
                k3, v3 = self.next()
                if not (k3 == "op" and v3 == ")"):
                    raise UndefinedUnitError("Expected ')' in exponent.")
            elif k2 == "num":
                exp = v2
            else:
                raise UndefinedUnitError("Expected a numeric exponent after '**'.")
            exp = float(exp) * sign
            factor = factor**exp
            dims = _dim_mul(dims, exp)
            units = {k: v * exp for k, v in units.items()}
        return factor, dims, units

    def factor(self):
        kind, val = self.next()
        if kind == "num":
            return float(val), _DIMENSIONLESS, {}
        if kind == "name":
            f, d = _resolve_name(val)
            return f, d, {val: 1.0}
        if kind == "op" and val == "(":
            result = self.expr()
            k2, v2 = self.next()
            if not (k2 == "op" and v2 == ")"):
                raise UndefinedUnitError("Unbalanced parentheses in unit expression.")
            return result
        raise UndefinedUnitError(f"Unexpected token in unit expression: {val!r}.")


def _merge_units(a: Dict[str, float], b: Dict[str, float], sign: int):
    out = dict(a)
    for k, v in b.items():
        out[k] = out.get(k, 0.0) + sign * v
        if out[k] == 0:
            del out[k]
    return out


def _parse_units(expr: str) -> Tuple[float, Dim, Dict[str, float]]:
    tokens = _tokenize(expr)
    if not tokens:
        return 1.0, _DIMENSIONLESS, {}
    return _Parser(tokens).parse()


def _format_units(units: Dict[str, float], latex: bool = False) -> str:
    if not units:
        return "dimensionless"
    num, den = [], []
    for name, exp in sorted(units.items()):
        target = num if exp > 0 else den
        e = abs(exp)
        e_int = int(e) if float(e).is_integer() else e
        if latex:
            part = rf"\mathrm{{{name}}}" + (f"^{{{e_int}}}" if e_int != 1 else "")
        else:
            part = name + (f"**{e_int}" if e_int != 1 else "")
        target.append(part)
    s = " * ".join(num) if num else "1"
    if den:
        s += " / " + " / ".join(den)
    return s


class Unit:
    """A (possibly compound) unit: an SI conversion factor plus dimensions."""

    __slots__ = ("_factor", "_dims", "_units")

    def __init__(self, factor: float, dims: Dim, units: Dict[str, float]):
        self._factor = float(factor)
        self._dims = tuple(dims)
        self._units = dict(units)

    @classmethod
    def parse(cls, expr: Union[str, "Unit"]) -> "Unit":
        if isinstance(expr, Unit):
            return expr
        factor, dims, units = _parse_units(expr)
        return cls(factor, dims, units)

    @property
    def dimensionality(self) -> Dict[str, float]:
        return {
            name: exp for name, exp in zip(_DIM_NAMES, self._dims) if exp != 0
        }

    @property
    def dimensionless(self) -> bool:
        return all(d == 0 for d in self._dims)

    def __eq__(self, other) -> bool:
        if isinstance(other, str):
            other = Unit.parse(other)
        if not isinstance(other, Unit):
            return NotImplemented
        return self._dims == other._dims and np.isclose(self._factor, other._factor)

    def __hash__(self):
        return hash((self._dims, round(math.log10(abs(self._factor) + 1e-300), 9)))

    def __mul__(self, other):
        if isinstance(other, Unit):
            return Unit(
                self._factor * other._factor,
                _dim_add(self._dims, other._dims),
                _merge_units(self._units, other._units, +1),
            )
        return Quantity(other, self)

    __rmul__ = __mul__

    def __truediv__(self, other):
        if isinstance(other, Unit):
            return Unit(
                self._factor / other._factor,
                _dim_sub(self._dims, other._dims),
                _merge_units(self._units, other._units, -1),
            )
        return NotImplemented

    def __pow__(self, exp):
        return Unit(
            self._factor**exp,
            _dim_mul(self._dims, exp),
            {k: v * exp for k, v in self._units.items()},
        )

    def __repr__(self) -> str:
        return f"<Unit('{_format_units(self._units)}')>"

    def __str__(self) -> str:
        return _format_units(self._units)

    def __format__(self, spec: str) -> str:
        if "L" in spec:
            return _format_units(self._units, latex=True)
        return _format_units(self._units)


class Quantity:
    """A value (scalar or array) with attached units."""

    __slots__ = ("_magnitude", "_unit")

    # Ensure ndarray * Quantity defers to Quantity.__rmul__.
    __array_priority__ = 100

    def __init__(self, magnitude, unit: Union[str, Unit] = ""):
        if isinstance(magnitude, Quantity):
            inner_unit = magnitude._unit
            magnitude = magnitude._magnitude
            unit = inner_unit * Unit.parse(unit) if unit else inner_unit
        self._magnitude = magnitude
        self._unit = Unit.parse(unit)

    # -- accessors ---------------------------------------------------------
    @property
    def magnitude(self):
        return self._magnitude

    m = magnitude

    @property
    def units(self) -> Unit:
        return self._unit

    @property
    def dimensionality(self) -> Dict[str, float]:
        return self._unit.dimensionality

    @property
    def dimensionless(self) -> bool:
        return self._unit.dimensionless

    # -- conversion --------------------------------------------------------
    def to(self, target: Union[str, Unit, "Quantity"]) -> "Quantity":
        if isinstance(target, Quantity):
            target = target._unit
        target = Unit.parse(target)
        if target._dims != self._unit._dims:
            raise DimensionalityError(str(self._unit), str(target))
        scale = self._unit._factor / target._factor
        return Quantity(self._magnitude * scale, target)

    def to_base_units(self) -> "Quantity":
        si_units = {}
        for name, exp in zip(("m", "kg", "s", "A"), self._unit._dims):
            if exp != 0:
                si_units[name] = exp
        return Quantity(
            self._magnitude * self._unit._factor,
            Unit(1.0, self._unit._dims, si_units),
        )

    # -- arithmetic --------------------------------------------------------
    def _coerce(self, other) -> "Quantity":
        if isinstance(other, Quantity):
            return other
        if isinstance(other, Unit):
            return Quantity(1.0, other)
        if isinstance(other, str):
            return ureg(other)
        return Quantity(other, Unit(1.0, _DIMENSIONLESS, {}))

    def __add__(self, other):
        if isinstance(other, (int, float)) and other == 0:
            return self
        other = self._coerce(other)
        other = other.to(self._unit)
        return Quantity(self._magnitude + other._magnitude, self._unit)

    __radd__ = __add__

    def __sub__(self, other):
        other = self._coerce(other).to(self._unit)
        return Quantity(self._magnitude - other._magnitude, self._unit)

    def __rsub__(self, other):
        other = self._coerce(other).to(self._unit)
        return Quantity(other._magnitude - self._magnitude, self._unit)

    def __mul__(self, other):
        if isinstance(other, Unit):
            return Quantity(self._magnitude, self._unit * other)
        other = self._coerce(other)
        return Quantity(
            self._magnitude * other._magnitude, self._unit * other._unit
        )

    __rmul__ = __mul__

    def __truediv__(self, other):
        if isinstance(other, Unit):
            return Quantity(self._magnitude, self._unit / other)
        other = self._coerce(other)
        return Quantity(
            self._magnitude / other._magnitude, self._unit / other._unit
        )

    def __rtruediv__(self, other):
        other = self._coerce(other)
        return Quantity(
            other._magnitude / self._magnitude, other._unit / self._unit
        )

    def __pow__(self, exp):
        return Quantity(self._magnitude**exp, self._unit**exp)

    def __neg__(self):
        return Quantity(-self._magnitude, self._unit)

    def __abs__(self):
        return Quantity(abs(self._magnitude), self._unit)

    def __len__(self):
        return len(self._magnitude)

    def __getitem__(self, idx):
        return Quantity(self._magnitude[idx], self._unit)

    def __array__(self, dtype=None, copy=None):
        return np.asarray(self._magnitude, dtype=dtype)

    # -- comparison --------------------------------------------------------
    def _cmp_value(self, other):
        other = self._coerce(other).to(self._unit)
        return other._magnitude

    def __eq__(self, other):
        try:
            return bool(np.all(self._magnitude == self._cmp_value(other)))
        except (DimensionalityError, UndefinedUnitError):
            return False

    def __lt__(self, other):
        return self._magnitude < self._cmp_value(other)

    def __le__(self, other):
        return self._magnitude <= self._cmp_value(other)

    def __gt__(self, other):
        return self._magnitude > self._cmp_value(other)

    def __ge__(self, other):
        return self._magnitude >= self._cmp_value(other)

    def __hash__(self):
        return hash((np.shape(self._magnitude), str(self._unit)))

    # -- formatting --------------------------------------------------------
    def __repr__(self) -> str:
        return f"<Quantity({self._magnitude}, '{self._unit}')>"

    def __str__(self) -> str:
        return f"{self._magnitude} {self._unit}"

    def __format__(self, spec: str) -> str:
        spec = spec.replace("~", "")
        uspec = "L" if "L" in spec else ("P" if "P" in spec else "")
        mspec = spec.replace("L", "").replace("P", "")
        mag = format(self._magnitude, mspec) if mspec else str(self._magnitude)
        return f"{mag} {format(self._unit, uspec)}"


class UnitRegistry:
    """Callable registry: ``ureg("1 mA")`` -> :class:`Quantity`,
    ``ureg("mT")`` -> :class:`Quantity` with magnitude 1."""

    Quantity = Quantity
    Unit = Unit

    def __call__(self, expr: Union[str, float, Quantity]) -> Quantity:
        if isinstance(expr, Quantity):
            return expr
        if isinstance(expr, (int, float)):
            return Quantity(expr)
        factor, dims, units = _parse_units(expr)
        # Separate any leading numeric factor from the symbolic units so that
        # e.g. ureg("2 mA") has magnitude 2 and units mA.
        unit_factor, _, _ = _parse_units(_format_units(units)) if units else (1.0, None, None)
        magnitude = factor / unit_factor
        if np.isclose(magnitude, 1.0):
            magnitude = 1.0
        return Quantity(magnitude, Unit(unit_factor, dims, units))

    def parse_units(self, expr: str) -> Unit:
        return Unit.parse(expr)

    def parse_expression(self, expr: str) -> Quantity:
        return self(expr)


#: The global unit registry (reference: ``superscreen/units.py:3``).
ureg = UnitRegistry()
