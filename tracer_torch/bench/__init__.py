"""Timing on the card and the headline benchmark (``python -m tracer_torch.bench``)."""
