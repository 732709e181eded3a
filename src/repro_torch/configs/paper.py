"""The paper's own experiment models (a copy of ``repro/configs/paper.py``)."""
from repro_torch.configs.base import ArchConfig

CONFIGS = {
    # 1-layer net of Sec 3.2.1 / LeNet-scale stand-in: a small dense decoder
    "paper-mlp": ArchConfig(
        name="paper-mlp",
        family="dense",
        source="[paper Sec 3.2.1]",
        n_layers=2,
        d_model=256,
        n_heads=4,
        n_kv_heads=4,
        d_ff=1024,
        vocab_size=1024,
        dtype="float32",
    ),
    # ~125M-parameter dense decoder for the end-to-end local-SGD run
    "paper-lenet": ArchConfig(
        name="paper-lenet",
        family="dense",
        source="[paper Sec 3.2.2 scale-equivalent]",
        n_layers=8,
        d_model=768,
        n_heads=12,
        n_kv_heads=12,
        d_ff=3072,
        vocab_size=32000,
        dtype="float32",
    ),
}
