from . import backbones  # noqa: F401  (BACKBONE registrations)
from . import methods  # noqa: F401  (MODEL registrations)
from ..config import ConfigNode
from ..registry import MODEL
from .bridge import export_jax_variables, load_jax_variables
from .init import init_parameters


def build_model(model_config, image_size):
    """The registered model ``model_config.name`` for square inputs of
    ``image_size`` pixels (the recipe's ``dataset.transformer.image_size``).
    Layers whose width is the flattened feature map's (OSME's ``part_fc``,
    CIN's ``gate_fc`` and ``pair_head``), which flax infers at init, are
    built to it."""
    cfg = model_config.to_dict()
    cfg["image_size"] = int(image_size)
    return MODEL.get(model_config.name)(ConfigNode(cfg).freeze())


__all__ = ["build_model", "export_jax_variables", "init_parameters",
           "load_jax_variables"]
