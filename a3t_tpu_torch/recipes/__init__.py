"""End-to-end recipes of the port (``python -m a3t_tpu_torch.recipes.mini``)."""
