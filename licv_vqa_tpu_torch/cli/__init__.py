"""Command-line entry points of the port (``python inference_torch.py``)."""
