"""Functional layers (``layers``, ``custom_components``) and the evolvable
modules: ``base``, ``mlp``, ``cnn``, ``resnet``, ``simba``, ``lstm``,
``multi_input``, ``dummy``, the net ``configs`` and the evolvable
transformers ``gpt`` and ``bert``.

The JAX package's exports are importable from here; each loads its
submodule at first use, so importing one module does not import them all.
"""

from importlib import import_module

_EXPORTS = {
    "EvolvableModule": "base", "ModuleDict": "base", "mutation": "base",
    "preserve_params": "base",
    "EvolvableMLP": "mlp", "MLPConfig": "mlp",
    "EvolvableCNN": "cnn", "CNNConfig": "cnn",
    "EvolvableLSTM": "lstm", "LSTMConfig": "lstm",
    "EvolvableMultiInput": "multi_input", "MultiInputConfig": "multi_input",
    "EvolvableSimBa": "simba", "SimBaConfig": "simba",
    "EvolvableResNet": "resnet", "ResNetConfig": "resnet",
    "EvolvableGPT": "gpt",
    "EvolvableBERT": "bert", "BERTConfig": "bert",
    "DummyEvolvable": "dummy",
}

__all__ = list(_EXPORTS)


def __getattr__(name: str):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(import_module(f"{__name__}.{_EXPORTS[name]}"), name)
