"""Qwen2-VL 72B backbone: dense decoder with M-RoPE.

Assigned config: [arXiv:2409.12191; hf] (vision frontend stubbed per assignment)
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
name="qwen2-vl-72b",
family="vlm",
n_layers=80,
d_model=8192,
n_heads=64,
n_kv_heads=8,
d_ff=29568,
vocab=152064,
head_dim=128,
mrope_sections=(16, 24, 24),
)
