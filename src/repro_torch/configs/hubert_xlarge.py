"""HuBERT X-Large: encoder-only audio transformer.

Assigned config: [arXiv:2106.07447; unverified] (conv frontend stubbed per assignment)
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
name="hubert-xlarge",
family="audio",
n_layers=48,
d_model=1280,
n_heads=16,
n_kv_heads=16,
d_ff=5120,
vocab=504,
encoder_only=True,
embed_inputs=True,
activation="gelu",
)
