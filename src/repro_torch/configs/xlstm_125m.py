"""xlstm-125m — recurrent xLSTM (sLSTM + mLSTM blocks), attention-free.

[arXiv:2405.04517; unverified]
12L d_model=768 4H d_ff=0 vocab=50304

Block pattern: the xLSTM[7:1] ratio from the paper, cycled: one sLSTM block
per 8 blocks, the rest mLSTM (positions chosen to cycle evenly over 12
layers).  d_ff=0 in the assignment: xLSTM blocks carry their own up/down
projections (expand factor 2) instead of a separate FFN.

Attention-free => no KV cache; decode is O(1) per token, so long_500k RUNS.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="xlstm",
    num_layers=12,
    d_model=768,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    # 'm'*7 + 's' cycled over the 12 layers -> sLSTM at layers 7 and (12+7)%12
    xlstm_pattern=("m", "m", "m", "m", "m", "m", "m", "s"),
)
