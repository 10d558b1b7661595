"""mamba2-780m — SSD (state-space duality) [arXiv:2405.21060].

48L d_model=1536 (attn-free), vocab=50280, ssm_state=128, d_inner=2*d_model,
head_dim=64 (48 SSD heads). Sub-quadratic: runs the long_500k cell.
"""

from repro_torch.models.config import ModelConfig
from repro_torch.models.ssd import SSMConfig

CONFIG = ModelConfig(
    name="mamba2-780m", family="ssm", num_layers=48, d_model=1536,
    vocab_size=50280,
    ssm=SSMConfig(d_inner=3072, state_dim=128, head_dim=64),
    subquadratic=True,
)
