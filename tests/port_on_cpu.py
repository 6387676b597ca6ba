"""The one way the port's CPU tests build a model: on the CPU, asked for.

``smplfitter_tpu_torch.BodyModel`` runs on the CUDA card unless the caller
names another device, and raises where there is none. Every CPU test of the
port (``tests/test_torch_*.py``) builds its models through these helpers,
which pass ``device='cpu'``; the fitter takes its device from the model.
"""

from __future__ import annotations

from smplfitter_tpu_torch import BodyModel

DEVICE = 'cpu'


def port_model(model_name: str = 'smpl', gender: str = 'neutral', **kwargs) -> BodyModel:
    """``BodyModel(model_name, gender, ...)`` loaded from the model files, on the CPU."""
    return BodyModel(model_name, gender, device=DEVICE, **kwargs)


def port_model_from(source) -> BodyModel:
    """The port's model on the CPU from another model's weights: a JAX
    ``BodyModel`` or a port ``BodyModel`` (its ``model_data``, name and gender)."""
    return BodyModel.from_model_data(source.model_data, source.model_name, source.gender,
                                     device=DEVICE)
