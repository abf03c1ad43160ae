"""The ML library, fv3fit's counterpart (port of
``fv3net_tpu/fit/__init__.py``; reference: external/fv3fit/fv3fit).

The names the reference exports, resolved on first use (PEP 562), so
that importing ``fv3net_torch.fit`` (as every ``fit`` submodule and CLI
process does) loads none of the trainers: ``fv3net_torch.fit.load``
imports the model types it dispatches to itself.  The modules named here
register their model types and trainers when they are imported.
"""
import importlib

_MODULES = (
    "autoencoder", "convolutional", "cyclegan", "dense", "graph",
    "models", "novelty", "precipitative", "random_forest", "recurrent",
    "reservoir", "testing", "transformed", "transformers",
)

# name -> module that defines it
_NAMES = {
    "Predictor": "predictor",
    "register": "io", "dump": "io", "load": "io",
    "TrainingConfig": "train", "get_training_function": "train",
    "register_training_function": "train",
    "get_hyperparameter_class": "train", "set_random_seed": "train",
    "StandardScaler": "normalize",
    "DerivedModel": "models",
    "compute_jacobians": "jacobian",
    "nondimensionalize_jacobians": "jacobian",
    "LearningRateScheduleConfig": "config", "OptimizerConfig": "config",
    "OutputLimit": "config", "OutputLimitConfig": "config",
    "RegularizerConfig": "config",
    "ConvolutionalNetwork": "networks",
    "ConvolutionalNetworkConfig": "networks", "DenseNetwork": "networks",
    "DenseNetworkConfig": "networks", "EpochResult": "networks",
    "LossConfig": "networks", "TrainingLoopConfig": "networks",
    "InputSensitivity": "input_sensitivity",
    "JacobianInputSensitivity": "input_sensitivity",
    "RandomForestInputSensitivities": "input_sensitivity",
    "RandomForestInputSensitivity": "input_sensitivity",
    "input_sensitivity": "input_sensitivity",
    "FromBatches": "data", "SyntheticNoise": "data",
    "TFDatasetLoader": "data", "WindowedZarrLoader": "data",
    "register_tfdataset_loader": "data",
    "tfdataset_loader_from_dict": "data",
    "DenseHyperparameters": "dense",
    "ConvolutionalHyperparameters": "convolutional",
    "TransformedPredictor": "transformed",
    "DatasetPredictor": "transformers",
    "DoNothingAutoencoder": "transformers",
    "PCATransformer": "transformers",
}


def __getattr__(name):
    if name in _MODULES:
        return importlib.import_module(f"{__name__}.{name}")
    if name in _NAMES:
        module = importlib.import_module(f"{__name__}.{_NAMES[name]}")
        # every name of the module at once: importing a submodule binds
        # it on the package, and ``input_sensitivity`` names both
        for other, where in _NAMES.items():
            if where == _NAMES[name]:
                globals()[other] = getattr(module, other)
        return globals()[name]
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_MODULES) | set(_NAMES))
