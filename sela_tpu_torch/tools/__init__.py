"""The port's measurement tools, each run as `python -m sela_tpu_torch.tools.<name>`."""
