"""xLSTM-1.3B: stacked mLSTM blocks with interleaved sLSTM blocks.
[arXiv:2405.04517]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-1.3b",
    family="ssm",
    source="[arXiv:2405.04517]",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,            # xLSTM blocks carry their own up/down projections
    vocab_size=50304,
    expand=2,
    slstm_every=4,     # one sLSTM per 4 layers (7:1-ish mix of the paper)
    chunk_size=128,
)
