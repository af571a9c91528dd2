"""Model: device ms a train step in the LayerNorm's kernels, forward and
backward: PyTorch's own (``F.layer_norm``: its row statistics, apply,
input gradient and affine-gradient kernels) or the port's hand-written
ones (``csrc/layernorm.cu``, every kernel named ``layernorm_*``), so that a
program with either reads the same layer."""

from h100_bench.lib.kernels import kernel_seconds

# PyTorch's vectorized_layer_norm_kernel, LayerNormForwardCUDAKernel,
# RowwiseMomentsCUDAKernel, layer_norm_grad_input_kernel* and
# GammaBetaBackward*CUDAKernel; the port's layernorm_forward,
# layernorm_backward and layernorm_finish
LAYERNORM = ("layer_norm", "LayerNorm", "GammaBeta", "RowwiseMoments", "layernorm")


def read(run):
    if run.kind != "train":
        return None
    s = kernel_seconds(run, LAYERNORM)
    return None if s is None else 1e3 * s
