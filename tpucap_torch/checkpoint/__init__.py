"""Checkpoints of the port: the training checkpoint manager
(``CheckpointManager``) and Keras ``.h5`` import and export through the
port's own HDF5 reader and writer (``hdf5``)."""

from tpucap_torch.checkpoint.keras_export import (
    KerasModel,
    attention_decoder_to_keras,
    decoder_to_keras,
    export_h5,
    gru_merge_decoder_to_keras,
    inject_decoder_to_keras,
    merge_decoder_to_keras,
)
from tpucap_torch.checkpoint.keras_import import (
    KerasH5Model,
    attention_decoder_params_from_keras,
    gru_merge_decoder_params_from_keras,
    inject_decoder_params_from_keras,
    merge_decoder_params_from_keras,
    params_from_keras,
)
from tpucap_torch.checkpoint.manager import CheckpointManager

__all__ = [
    "params_from_keras",
    "merge_decoder_params_from_keras",
    "gru_merge_decoder_params_from_keras",
    "inject_decoder_params_from_keras",
    "attention_decoder_params_from_keras",
    "KerasH5Model",
    "export_h5",
    "decoder_to_keras",
    "merge_decoder_to_keras",
    "gru_merge_decoder_to_keras",
    "inject_decoder_to_keras",
    "attention_decoder_to_keras",
    "KerasModel",
    "CheckpointManager",
]
