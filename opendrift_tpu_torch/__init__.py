"""opendrift_tpu_torch — the PyTorch/CUDA port of ``opendrift_tpu``.

A second package beside the JAX one, with the same module names so each
counterpart is easy to find.  It imports ``torch`` and never ``jax`` or
anything of ``opendrift_tpu``; the JAX package is the reference every part
of the port is held against (``tests/test_torch_*.py``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
The port grows one slice at a time (ROADMAP.md, queue A): so far an
OceanDrift run on gridded forcing with Visser vertical mixing, and an
OpenOil run (weathering, wave entrainment, stranding).  The three mixing
kernels are hand-written CUDA (``csrc/visser_mixing.cu``).
"""

import importlib

__version__ = "0.1.0"

_MODEL_REGISTRY = {
    "OceanDrift": "opendrift_tpu_torch.models.oceandrift",
    "OpenOil": "opendrift_tpu_torch.models.openoil",
}


def get_model_names():
    """Names of the models the port provides so far."""
    return list(_MODEL_REGISTRY)


def get_model(model_name):
    """Import and return a model class by name
    (reference opendrift/__init__.py:31-43)."""
    if model_name not in _MODEL_REGISTRY:
        raise ValueError(
            f"No drift model named {model_name} in the port; "
            f"available: {list(_MODEL_REGISTRY)} (the rest of the model "
            "zoo is ROADMAP item A.12)")
    module = importlib.import_module(_MODEL_REGISTRY[model_name])
    return getattr(module, model_name)
