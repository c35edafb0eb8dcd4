from .solve import FactorizedModel, factorize_model, solve
from .solve_film import (
    LinearSystem,
    TerminalSystems,
    factorize_linear_systems,
    solve_film,
    solve_for_terminal_current_stream,
)
from .utils import (
    FilmInfo,
    LambdaInfo,
    convert_field,
    current_to_float,
    currents_to_floats,
    field_conversion_factor,
    make_film_info,
    stream_from_current_density,
    stream_from_terminal_current,
)

__all__ = [
    "FactorizedModel",
    "FilmInfo",
    "LambdaInfo",
    "LinearSystem",
    "TerminalSystems",
    "convert_field",
    "current_to_float",
    "currents_to_floats",
    "factorize_linear_systems",
    "factorize_model",
    "field_conversion_factor",
    "make_film_info",
    "solve",
    "solve_film",
    "solve_for_terminal_current_stream",
    "stream_from_current_density",
    "stream_from_terminal_current",
]
