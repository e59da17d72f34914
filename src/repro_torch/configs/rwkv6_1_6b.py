"""RWKV6 (Finch) 1.6B: attention-free, data-dependent decay.

Assigned config: [arXiv:2404.05892; unverified]
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
name="rwkv6-1.6b",
family="ssm",
n_layers=24,
d_model=2048,
n_heads=0,
n_kv_heads=0,
d_ff=7168,
vocab=65536,
rwkv_head_dim=64,
activation="relu2",
)
