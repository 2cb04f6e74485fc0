"""Keras HDF5 and JSON model import (counterpart of
deeplearning4j_tpu/modelimport; parity: deeplearning4j-modelimport —
KerasModelImport.java:48-231 entry points, KerasModel.java config
translation, KerasLayer.java weight-layout permutations, Hdf5Archive.java
HDF5 reading). The DL4J zip reader and writer are in
``modelimport.dl4j``."""

from deeplearning4j_tpu_torch.modelimport.keras import (
    KerasImportError,
    import_keras_model,
    import_keras_model_and_weights,
    import_keras_sequential_model,
    import_keras_sequential_model_and_weights,
)

__all__ = [
    "KerasImportError",
    "import_keras_model",
    "import_keras_model_and_weights",
    "import_keras_sequential_model",
    "import_keras_sequential_model_and_weights",
]
