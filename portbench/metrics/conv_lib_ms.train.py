"""Device milliseconds a training step spends in the library's (cuDNN's)
convolution kernels, forward, data gradient and weight gradient, over the
traced window. Layer: library convolutions; moves ``train_img_per_s``.

The kernel-name class below was checked on the card against the operators
that launched each kernel in one profiled eager step
(``portbench/probe_kernels.py``): K1's and K2's kernels are the port's own
and never count here."""

from portbench.lib import trace

OWN = ("layer_norm_relu", "conv3x3_c64", "pack_conv3x3_weights")
# cuDNN's kernels (their names carry "cudnn"), its implicit-GEMM, FFT and
# direct engines, and the bf16 tensor-op GEMMs it runs for some layers (the
# model's only matrix products are the resizes', in float32)
LIBRARY_CONV = ("cudnn", "fprop", "dgrad", "wgrad", "convolve", "convolution", "winograd", "fft",
                "pointwise_mult_and_sum_complex", "tensorop_bf16")


def is_library_conv(name: str) -> bool:
    low = name.lower()
    return not any(s in name for s in OWN) and any(s in low for s in LIBRARY_CONV)


def read(ctx):
    tr, steps = ctx.get("trace"), ctx.get("steps", 0)
    if tr is None or steps <= 0:
        return None
    seconds = trace.device_seconds(tr, is_library_conv)
    return seconds * 1e3 / steps if seconds > 0 else None
