"""Model forward passes: llama-class dense and mixtral-class MoE, and the
model registry."""
