"""xLSTM-1.3B [arXiv:2405.04517; unverified] — sLSTM + mLSTM blocks.

48L d_model=2048 4H, attention-free (d_ff=0), vocab 50304.
7:1 mLSTM:sLSTM pattern (slstm_every=8) as in the paper's xLSTM[7:1];
blocks carry matrix/scalar memories -> O(1) decode state, so this arch
runs the long_500k cell."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b", family="ssm",
    num_layers=48, d_model=2048, num_heads=4, num_kv_heads=4,
    d_ff=0, vocab_size=50304, slstm_every=8,
    dtype="bfloat16", ssm_chunk=256)


def smoke_config() -> ModelConfig:
    return CONFIG.scaled(num_layers=4, d_model=64, num_heads=2,
                         num_kv_heads=2, slstm_every=2, ssm_chunk=8,
                         vocab_size=256, dtype="float32", remat=False)
