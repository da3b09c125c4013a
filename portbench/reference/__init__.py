"""The plain reference of the adaptive SR U-Net: its forward, its training
step (patch sampling, degradation, Charbonnier loss, Adam) and its int8
weight quantization, in plain PyTorch. It imports nothing of the program
(``adunet_torch``) nor of the JAX package, and takes nothing the program
made: it works out the sampled patches, the degraded inputs and the
quantized weights again from the benchmark's own inputs."""
