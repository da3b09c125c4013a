"""Device milliseconds a training step spends in the float32 matrix-product
kernels of the resizes (``ops/resize.py``: the encoder's and decoder's
resizes, their gradients, and the degradation of the batch), over the
traced window. Layer: ops; moves ``train_img_per_s``.

The class: a GEMM kernel (cuBLAS or CUTLASS) that is no convolution's and
not of a 16-bit type; the training step's convolutions run in bf16, so the
float32 products are the resizes'. Checked on the card against the
operators that launched each kernel (``portbench/probe_kernels.py``)."""

from portbench.lib import trace

OWN = ("layer_norm_relu", "conv3x3_c64", "pack_conv3x3_weights")
CONV = ("cudnn", "fprop", "dgrad", "wgrad", "implicit", "winograd", "fft", "conv")
GEMM = ("gemm", "gemv", "matmul")
HALF = ("bf16", "f16", "h16", "fp16", "s16816", "16816", "hmma", "e4m3")


def is_resize(name: str) -> bool:
    low = name.lower()
    return (not any(s in name for s in OWN) and not any(s in low for s in CONV)
            and any(s in low for s in GEMM) and not any(s in low for s in HALF))


def read(ctx):
    tr, steps = ctx.get("trace"), ctx.get("steps", 0)
    if tr is None or steps <= 0:
        return None
    seconds = trace.device_seconds(tr, is_resize)
    return seconds * 1e3 / steps if seconds > 0 else None
