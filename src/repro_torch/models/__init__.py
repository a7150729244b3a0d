"""Model zoo behind one functional API (dense, ssm and hybrid families ported so far)."""

from repro_torch.models.common import ModelConfig  # noqa: F401
from repro_torch.models.registry import ModelAPI, get_api  # noqa: F401
