from .solve import FactorizedModel, factorize_model, solve
from .utils import field_conversion_factor

__all__ = ["FactorizedModel", "factorize_model", "field_conversion_factor", "solve"]
