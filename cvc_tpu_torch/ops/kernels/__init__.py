"""Hand-written Hopper kernels of the port, one module each, with the plain
PyTorch version of each beside it. Importing this package builds nothing:
the CUDA library is compiled at the first launch (`build.library`)."""

from cvc_tpu_torch.ops.kernels.attention import fused_additive_attention
from cvc_tpu_torch.ops.kernels.decoder_step import fused_beam_decoder_core
from cvc_tpu_torch.ops.kernels.lstm import fused_lstm_gates
from cvc_tpu_torch.ops.kernels.topk_select import fused_topk_lse

# every kernel wrapper; each counts its own launches in `.launches`
KERNELS = (fused_lstm_gates, fused_additive_attention,
           fused_beam_decoder_core, fused_topk_lse)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}


__all__ = ["KERNELS", "fused_additive_attention", "fused_beam_decoder_core",
           "fused_lstm_gates", "fused_topk_lse", "launch_counts",
           "reset_launch_counts"]
