from .encoder import expand_icv_to_layers, prepare_intervention_layers

__all__ = ["expand_icv_to_layers", "prepare_intervention_layers"]
