from a3t_tpu_torch.data.synthetic import make_synthetic_batch

__all__ = ["make_synthetic_batch"]
