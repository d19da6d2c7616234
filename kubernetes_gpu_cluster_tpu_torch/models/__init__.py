"""Model forward passes (llama-class dense)."""
