"""The serving half of the JAX package's ``sdtpu/train``: LoRA adapter
trees (``lora``). Training itself is still to port."""
