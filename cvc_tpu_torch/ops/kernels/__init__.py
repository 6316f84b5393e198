"""Hand-written Hopper kernels of the port, one module each, with the plain
PyTorch version of each beside it. Importing this package builds nothing:
the CUDA library is compiled at the first launch (`build.library`)."""

from cvc_tpu_torch.ops.kernels.attention import (
    fused_additive_attention, fused_additive_attention_bwd)
from cvc_tpu_torch.ops.kernels.decoder_step import fused_beam_decoder_core
from cvc_tpu_torch.ops.kernels.lstm import (fused_lstm_gates,
                                            fused_lstm_gates_bwd)
from cvc_tpu_torch.ops.kernels.topk_select import fused_topk_lse
from cvc_tpu_torch.ops.kernels.xent import (fused_masked_xent,
                                            fused_masked_xent_bwd)

# every kernel's counter, forward and backward: each wrapper adds one to
# `.launches` where it launches its kernel (fused_masked_xent counts the
# forward kernel's launches)
KERNELS = (fused_lstm_gates, fused_lstm_gates_bwd, fused_additive_attention,
           fused_additive_attention_bwd, fused_beam_decoder_core,
           fused_topk_lse, fused_masked_xent, fused_masked_xent_bwd)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}


__all__ = ["KERNELS", "fused_additive_attention",
           "fused_additive_attention_bwd", "fused_beam_decoder_core",
           "fused_lstm_gates", "fused_lstm_gates_bwd", "fused_masked_xent",
           "fused_masked_xent_bwd", "fused_topk_lse", "launch_counts",
           "reset_launch_counts"]
