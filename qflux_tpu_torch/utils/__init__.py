"""File formats of the port: safetensors, LoRA files and checkpoints."""
