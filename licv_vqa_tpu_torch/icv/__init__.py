from .encoder import GlobalICVEncoder, expand_icv_to_layers, prepare_intervention_layers
from .module import ICVModuleConfig, TrainState, icv_loss_fn, make_train_step

__all__ = [
    "GlobalICVEncoder",
    "ICVModuleConfig",
    "TrainState",
    "expand_icv_to_layers",
    "icv_loss_fn",
    "make_train_step",
    "prepare_intervention_layers",
]
