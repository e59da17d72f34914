"""Model zoo port: config, layers, attention, stacks (dense, vlm, moe,
audio, hybrid, ssm)."""

from repro_torch.models.config import ModelConfig, smoke_variant  # noqa: F401
from repro_torch.models.model import Model  # noqa: F401
