from . import backbones  # noqa: F401  (BACKBONE registrations)
from . import methods  # noqa: F401  (MODEL registrations)
from .bridge import export_jax_variables, load_jax_variables
from .init import init_parameters

__all__ = ["export_jax_variables", "init_parameters", "load_jax_variables"]
