"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version:

========================== ============================ ========================
wrapper                    kernel (csrc/)               replaces (tpucap/)
========================== ============================ ========================
preprocess.preprocess_u8   preprocess.cu (K1)           ops/preprocess.py
                                                        normalize_images
lstm_step.lstm_cell        lstm_step.cu (K2)            ops/pallas/lstm_step.py
                                                        fused_lstm_step
decoder_step.merge_head    decoder_step.cu (K3, head)   ops/pallas/decoder_step.py
decoder_step.vocab_proj    decoder_step.cu (K3, proj)   fused_merge_step
bottleneck.fused_identity  bottleneck.cu (K4)           ops/pallas/bottleneck.py
_block                                                  fused_identity_block
attention.flash_attention  flash_attention.cu (K5)      models/encoders/vit.py
                                                        _flash_ctx (jax's stock
                                                        TPU flash attention)
attention.flash_attention  flash_attention_bwd.cu       the stock kernel's
_bwd_dkv                   (K5b, dK/dV)                 _flash_attention_bwd_dkv
attention.flash_attention  flash_attention_bwd.cu       the stock kernel's
_bwd_dq                    (K5b, dQ)                    _flash_attention_bwd_dq
========================== ============================ ========================

Each wrapper counts its launches in a ``launches`` attribute: it adds one
where it launches its kernel and nowhere else.
"""

from tpucap_torch.ops.attention import (
    flash_attention,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
)
from tpucap_torch.ops.bottleneck import fused_identity_block
from tpucap_torch.ops.decoder_step import merge_head, vocab_proj
from tpucap_torch.ops.lstm_step import lstm_cell
from tpucap_torch.ops.preprocess import preprocess_u8

KERNEL_WRAPPERS = {
    "preprocess_u8": preprocess_u8,
    "lstm_cell": lstm_cell,
    "merge_head": merge_head,
    "vocab_proj": vocab_proj,
    "identity_block": fused_identity_block,
    "flash_attention": flash_attention,
    "flash_attention_bwd_dkv": flash_attention_bwd_dkv,
    "flash_attention_bwd_dq": flash_attention_bwd_dq,
}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}
