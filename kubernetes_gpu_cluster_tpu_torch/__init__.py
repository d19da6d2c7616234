"""PyTorch/CUDA port of the serving framework, for NVIDIA Hopper (H100).

Mirrors the layout of the JAX package ``kubernetes_gpu_cluster_tpu`` (which
stays the reference it is tested against) and imports nothing from it.
Entry points (``engine.LLMEngine``, ``serving.async_engine.AsyncLLMEngine``)
run on the CUDA device unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
