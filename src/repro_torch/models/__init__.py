"""Model zoo: six architecture families behind one functional API."""

from repro_torch.models.common import ModelConfig  # noqa: F401
from repro_torch.models.registry import ModelAPI, active_params, get_api  # noqa: F401
