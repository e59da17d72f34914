"""StableLM 3B: dense GQA decoder.

Assigned config: [hf:stabilityai/stablelm-2-1_6b family; unverified]
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
name="stablelm-3b",
family="dense",
n_layers=32,
d_model=2560,
n_heads=32,
n_kv_heads=32,
d_ff=6912,
vocab=50304,
)
