"""Model families of the port.

- ``mnist``       -- MNISTClassifier MLP and its data module.
- ``resnet``      -- CIFAR-10 ResNet-18 and its data module.
- ``transformer`` -- the GPT decoder LM.
- ``vit``         -- Vision Transformer.
- ``speculative`` -- speculative decoding over the GPT.

Re-exports are lazy (PEP 562), as in the JAX package, so importing one
family does not pay for the others.
"""

_EXPORTS = {
    "MNISTClassifier": "mnist", "MNISTDataModule": "mnist",
    "synthetic_mnist": "mnist",
    "ResNet18": "resnet", "CIFAR10DataModule": "resnet",
    "synthetic_cifar10": "resnet",
    "GPT": "transformer", "TransformerConfig": "transformer",
    "ViT": "vit", "ViTConfig": "vit",
    "speculative_generate": "speculative",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        import importlib
        mod = importlib.import_module(f".{_EXPORTS[name]}", __name__)
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
